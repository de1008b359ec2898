"""The differentiable fused run (kernel mode B9).

Replaces the ``differentiable=True`` branch of
``landhydrology_tpu/ops/pallas/column_kernel.py::make_fused_column_run``
(``run_ad``, a ``jax.custom_vjp``): the forward is the fused kernel, the
backward a vector-Jacobian product of the plain version under
``torch.autograd``, over the state, ``t0`` and the step size.

- :class:`DifferentiableFusedRun` is ``run(Y, t0, dt_run=None) -> Y'``,
  functional: the kernel (on CUDA tensors; the plain version on CPU
  tensors) advances clones of the state's tensors, and ``Y`` stays as it
  was.  The autograd node keeps only the inputs, as JAX's residuals.
- The backward recomputes the run one step at a time: first the
  ``steps_per_call`` step-start states without a graph, then, from the last
  step to the first, one step's graph and its vjp.  Its memory is the
  step-start states plus one step's graph, where a graph of the whole
  launch would hold every step's.  The state's gradient equals that of the
  whole launch's graph bit for bit; the gradients of ``t0`` and the step
  size are the same sums, added in another order.
- Scope as JAX's: the plain soil column.  A parameter tensor of the model
  that requires grad raises ``ValueError`` naming it: the run closes over
  the model, so its gradient would be lost (JAX's ``custom_vjp`` refuses to
  differentiate a closed-over value).
"""

from __future__ import annotations

import dataclasses

import torch


def parameters_requiring_grad(obj, path: str = "model") -> list:
    """The paths of the tensors under ``obj`` (dataclass fields, dicts,
    tuples and lists, recursively) that require grad."""
    if torch.is_tensor(obj):
        return [path] if obj.requires_grad else []
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [p for f in dataclasses.fields(obj)
                for p in parameters_requiring_grad(getattr(obj, f.name), f"{path}.{f.name}")]
    if isinstance(obj, dict):
        return [p for k, v in obj.items() for p in parameters_requiring_grad(v, f"{path}[{k!r}]")]
    if isinstance(obj, (tuple, list)):
        return [p for j, v in enumerate(obj) for p in parameters_requiring_grad(v, f"{path}[{j}]")]
    return []


class _Run(torch.autograd.Function):
    """``(t0, dt, *fields) -> fields'``: one launch of ``run`` (a
    :class:`DifferentiableFusedRun`), its vjp by the step-by-step replay."""

    @staticmethod
    def forward(ctx, run, t0, dt, *fields):
        ctx.run = run
        ctx.save_for_backward(t0, dt, *fields)
        Y = {run.soil.name: {k: f.clone(memory_format=torch.contiguous_format)
                             for k, f in zip(run.fields, fields)}}
        run.inner(Y, t0, dt_run=dt)
        return tuple(Y[run.soil.name][k] for k in run.fields)

    @staticmethod
    def backward(ctx, *grads):
        run = ctx.run
        t0, dt, *fields = ctx.saved_tensors
        _, need_t0, need_dt = ctx.needs_input_grad[:3]
        g_t0, g_dt, g_Y = run.vjp(fields, t0, dt, grads, need_t0, need_dt)
        return (None, g_t0, g_dt, *g_Y)


class DifferentiableFusedRun:
    """``run(Y, t0, forcing=None, dt_run=None) -> Y'``: ``inner`` (a
    non-differentiable ``FusedColumnRun`` on a plain soil column) as a
    function of ``(Y, t0, dt_run)`` that ``torch.autograd`` differentiates
    (kernel mode B9).  Its launches count in ``LAUNCHES`` under
    ``B9:<mode>``."""

    def __init__(self, inner):
        self.inner = inner
        inner.name = f"B9:{inner.name}"
        self.name = inner.name
        self.model = self.soil = inner.model
        self.fields = inner.fields
        self.steps_per_call = inner.steps_per_call
        self.dt = inner.dt

    def _check_parameters(self) -> None:
        names = parameters_requiring_grad(self.model)
        if names:
            raise ValueError(
                f"the differentiable fused run closes over the model, so it cannot differentiate its "
                f"parameters: {', '.join(names)} require grad.  Take parameter gradients through the "
                "eager engine (stepper.step under torch.autograd)"
            )

    def __call__(self, Y: dict, t0, forcing=None, dt_run=None) -> dict:
        if forcing is not None:
            raise ValueError("differentiable fused run takes no forcing")
        self._check_parameters()
        dtype = self.soil.float_dtype
        t0 = torch.as_tensor(t0, dtype=dtype)
        dt = torch.as_tensor(self.dt if dt_run is None else dt_run, dtype=dtype)
        name = self.soil.name
        out = _Run.apply(self, t0, dt, *(Y[name][k] for k in self.fields))
        return {name: dict(zip(self.fields, out))}

    def vjp(self, fields, t0, dt, grads, need_t0=True, need_dt=True) -> tuple:
        """``(d t0, d dt, d fields)`` of the launch from ``fields`` at ``(t0,
        dt)`` against the cotangents ``grads`` of its output fields (``None``
        for zero), by the step-by-step replay of the plain version on the
        state's device."""
        from landhydrology_tpu_torch.ops.cuda.column_kernel import plain_step, step_times

        dtype = self.soil.float_dtype
        name = self.soil.name
        step = plain_step(self.model, self.inner.stepper, fields[0].device, self.inner.geometry)
        n = self.steps_per_call
        starts = [dict(zip(self.fields, fields))]
        with torch.no_grad():
            for t in step_times(t0, dt, n - 1, dtype):
                starts.append(step({name: starts[-1]}, t, dt)[name])
        g = [torch.zeros_like(f) if c is None else c for f, c in zip(fields, grads)]
        g_t0 = torch.zeros_like(t0) if need_t0 else None
        g_dt = torch.zeros_like(dt) if need_dt else None
        for i in reversed(range(n)):
            with torch.enable_grad():
                t0_r = t0.detach().requires_grad_(need_t0)
                dt_r = dt.detach().requires_grad_(need_dt)
                Y_i = {k: v.detach().requires_grad_(True) for k, v in starts[i].items()}
                t_i = step_times(t0_r, dt_r, i + 1, dtype)[i]
                Y_next = step({name: Y_i}, t_i, dt_r)[name]
                live = [(Y_next[k], c) for k, c in zip(self.fields, g) if Y_next[k].requires_grad]
                inputs = [Y_i[k] for k in self.fields] + [x for x, need in ((t0_r, need_t0), (dt_r, need_dt))
                                                          if need]
                got = torch.autograd.grad([o for o, _ in live], inputs, [c for _, c in live],
                                          allow_unused=True) if live else [None] * len(inputs)
            g = [torch.zeros_like(Y_i[k]) if d is None else d for k, d in zip(self.fields, got)]
            extra = list(got[len(self.fields):])
            if need_t0:
                d = extra.pop(0)
                g_t0 = g_t0 if d is None else g_t0 + d
            if need_dt:
                d = extra.pop(0)
                g_dt = g_dt if d is None else g_dt + d
            starts[i] = None
        return g_t0, g_dt, g


def check_scope(model, forcing_fields, streamed_geometry) -> None:
    """Refuse what the JAX package's differentiable run refuses, before any
    other check of the factory: a LandModel, streamed forcing rows and
    streamed geometry."""
    from landhydrology_tpu_torch.models.land import LandModel

    if isinstance(model, LandModel) or forcing_fields or streamed_geometry is not None:
        raise NotImplementedError(
            "differentiable=True covers the plain soil column kernel (no LandModel composition, "
            "streamed forcing, or streamed geometry): differentiate those through the eager engine"
        )
