"""Adaptive (error-controlled) time integration.

PyTorch port of ``landhydrology_tpu/adaptive.py``: step-doubling Richardson
error control on top of any fixed-step stepper.

- propose a step ``dt``: compute one full step ``Y1`` and two half steps
  ``Y2``; their difference estimates the local error, and ``Y2`` is accepted
  when the weighted error norm is <= 1;
- dt adapts with a PI controller (0.7/(p+1) and 0.4/(p+1) exponents for a
  stepper of order p), with clamped growth and shrink;
- a NaN error counts as a rejection, a step at ``dt_min`` is force-accepted
  and ``max_steps`` caps the loop, so every run terminates.

Where the JAX package runs the controller in one ``lax.while_loop`` on the
device, this port runs it on the host: a Python loop that reads the error
norm back once per iteration.  Its arithmetic is the JAX package's,
operation for operation, on 0-d tensors: ``t``, ``tf``, ``dt`` and the error
are in the model dtype in :func:`run_adaptive_fused`, and in the promoted
dtype of ``t0`` and ``dt0`` in :func:`run_adaptive` (a Python number counts
as float64, as in JAX with x64).

:func:`run_adaptive_fused` steps through the CUDA kernels of
``ops/cuda/column_kernel.py`` (on CPU tensors their plain version) at a
run-time step size (``run(Y, t, dt_run=dt)``, kernel mode B1-dt).  A fused
run updates its state in place, so each iteration works on clones and a
rejected iteration leaves ``Y`` as it was.
"""

from __future__ import annotations

import dataclasses

import torch

from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.models.land import LandModel, wrap_stepper_for_land
from landhydrology_tpu_torch.models.soil.freeze_thaw import wrap_stepper_with_projection
from landhydrology_tpu_torch.models.soil.lagged import wrap_stepper_for_soil
from landhydrology_tpu_torch.timestepping import SSPRK33, AbstractTimestepper


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    rtol: float = 1e-4
    atol: float = 1e-8
    dt_min: float = 1e-6
    dt_max: float = 1e6
    safety: float = 0.9
    max_growth: float = 4.0
    max_shrink: float = 0.1
    #: PI (Gustafsson) exponents: the step-doubling estimate of an order-p
    #: stepper is order p+1, hence 0.7/(p+1), 0.4/(p+1); ``None`` derives
    #: them from the stepper's ``order`` attribute at run time
    k_p: float | None = None
    k_i: float | None = None
    #: hard iteration cap: the loop ends even under persistent rejection
    #: (NaN error) or dt below the time's ulp
    max_steps: int = 10_000_000


def _wrap_freeze_thaw(stepper, model):
    """The equilibrium phase projection around ``stepper`` where the model
    (or its soil) configures ``EquilibriumFreezeThaw``; otherwise
    ``stepper`` (the JAX package's ``parallel/stepping.py::_wrap_freeze_thaw``)."""
    ft_owner = getattr(model, "soil", model)
    if getattr(ft_owner, "freeze_thaw", None) is not None:
        return wrap_stepper_with_projection(stepper, ft_owner)
    return stepper


def _dtype_of(x):
    return x.dtype if torch.is_tensor(x) else torch.float64


def _scalar(x, dtype):
    """``x`` as a 0-d tensor of ``dtype`` on the host."""
    return torch.as_tensor(x, dtype=dtype, device="cpu").reshape(())


def _with_exponents(config: AdaptiveConfig, stepper) -> AdaptiveConfig:
    """``config`` with the PI exponents from the stepper's order unless pinned."""
    p1 = float(getattr(stepper, "order", 3)) + 1.0
    k_p = config.k_p if config.k_p is not None else 0.7 / p1
    k_i = config.k_i if config.k_i is not None else 0.4 / p1
    return dataclasses.replace(config, k_p=k_p, k_i=k_i)


def _err_norm(config: AdaptiveConfig, Y1: dict, Y2: dict, Yref: dict):
    """The weighted max norm of ``Y1 - Y2`` over every leaf, scaled by
    ``atol + rtol * max(|Yref|, |Y2|)``, as a 0-d tensor on the state's
    device (NaN if any leaf holds one)."""
    leaves = []
    for group, fields in Yref.items():
        for k, r in fields.items():
            a, b = Y1[group][k], Y2[group][k]
            scale = config.atol + config.rtol * torch.maximum(torch.abs(r), torch.abs(b))
            leaves.append(torch.max(torch.abs(a - b) / scale))
    err = leaves[0]
    for leaf in leaves[1:]:
        err = torch.maximum(err, leaf)
    return err


def _converged(t, tf):
    return t >= tf - 1e-12 * torch.clamp(torch.abs(tf), min=1.0)


def _control(config: AdaptiveConfig, err, dt, err_prev):
    """``(accept, dt_new, err_next)`` of one iteration from the error norm
    ``err`` (a 0-d host tensor, floored at 1e-12) at step ``dt``."""
    # a NaN error (an unphysical state at this dt) is a rejection, and at
    # dt_min there is nothing left to shrink: force-accept
    at_floor = bool(dt <= config.dt_min * (1.0 + 1e-9))
    accept = bool(err <= 1.0) or at_floor
    # PI controller on the error history; a NaN factor shrinks the most
    factor = config.safety * err ** (-config.k_p) * err_prev ** (config.k_i)
    factor = torch.where(torch.isfinite(factor), factor, torch.full_like(factor, config.max_shrink))
    factor = torch.clamp(factor, config.max_shrink, config.max_growth)
    dt_new = torch.clamp(dt * factor, config.dt_min, config.dt_max)
    if accept:
        err_next = err if bool(torch.isfinite(err)) else torch.ones_like(err)
    else:
        err_next = err_prev
    return accept, dt_new, err_next


def _drive(segment, Y: dict, t0, tf, dt0, config: AdaptiveConfig, dtype, spc: int = 1, log=None,
           replay=None):
    """The step-doubling loop of both drivers.  ``segment(Y, t, dt)``
    returns the state ``spc`` steps of ``dt`` on from ``(Y, t)`` and leaves
    ``Y`` as it was; each iteration takes one segment at ``dt`` and two at
    ``dt / 2`` from ``t`` and ``t + 0.5 * spc * dt``, with ``dt`` first cut
    to ``(tf - t) / spc`` so the last segment lands on ``tf``.  ``config``
    carries the PI exponents.

    ``log``, a list, receives ``(t, dt, err, accept, dt_new)`` of every
    iteration (host floats; ``err`` floored at 1e-12, ``dt_new`` the
    controller's next step).  ``replay``, a sequence of such records (the
    first four fields are read), drives the loop instead of the controller:
    iteration ``i`` takes ``t`` and ``dt`` from record ``i`` and keeps its
    ``accept``, so a run reproduces another run's steps and ``log`` holds
    this implementation's error norms at them.  Returns ``(Y, stats)``."""
    t, tf, dt = _scalar(t0, dtype), _scalar(tf, dtype), _scalar(dt0, dtype)
    err_prev = torch.ones((), dtype=dtype)
    n_acc = n_rej = iters = 0
    while True:
        if replay is not None:
            if iters >= len(replay):
                break
            t, dt = _scalar(replay[iters][0], dtype), _scalar(replay[iters][1], dtype)
        elif bool(_converged(t, tf)) or iters >= config.max_steps:
            break
        else:
            dt = torch.minimum(dt, (tf - t) / spc)
        Y1 = segment(Y, t, dt)  # one segment at dt
        half = 0.5 * dt  # two at dt/2
        Y2 = segment(segment(Y, t, half), t + 0.5 * spc * dt, half)
        err = _scalar(_err_norm(config, Y1, Y2, Y), dtype)
        err = torch.maximum(err, torch.full_like(err, 1e-12))
        accept, dt_new, err_prev = _control(config, err, dt, err_prev)
        if log is not None:
            log.append((float(t), float(dt), float(err), accept, float(dt_new)))
        if replay is not None:
            accept = bool(replay[iters][3])
        if accept:
            Y, t = Y2, t + spc * dt
            n_acc += 1
        else:
            n_rej += 1
        dt = dt_new
        iters += 1
    return Y, {
        "n_accepted": torch.tensor(n_acc, dtype=torch.int32),
        "n_rejected": torch.tensor(n_rej, dtype=torch.int32),
        "dt_final": dt,
        "converged": _converged(t, tf),
    }


def run_adaptive(
    rhs,
    Y: dict,
    Ya: dict,
    t0,
    tf,
    dt0,
    stepper: AbstractTimestepper = SSPRK33(),
    config: AdaptiveConfig = AdaptiveConfig(),
    model=None,
    log=None,
    replay=None,
):
    """Integrate ``rhs`` from ``t0`` to ``tf`` with step-doubling error
    control.  Returns ``(Y_final, stats)`` with ``stats = {'n_accepted',
    'n_rejected', 'dt_final', 'converged'}`` (0-d tensors).  The loop stops
    at ``config.max_steps`` iterations even if the error estimate is NaN or
    dt underflows the time's ulp; check ``stats['converged']`` (t reached
    tf) on return.  ``log``, a list, receives ``(t, dt, err, accept, dt_new)``
    of every iteration (host floats); ``replay``, such records of another
    run, makes the loop take that run's steps and decisions instead of its
    own, so ``log`` holds this run's error norms at them (a check of one
    implementation against another, which the JAX package does not
    offer).

    Pass ``model`` to apply the model's step policies (the equilibrium
    freeze-thaw projection, lagged coefficients and
    ``LandModel(surface_update="step")``'s frozen exchange) as every other
    engine does; with ``rhs`` alone the caller wraps ``stepper``."""
    if model is not None:
        stepper = _wrap_freeze_thaw(stepper, model)
        if hasattr(model, "soil") and hasattr(model, "surface"):
            stepper = wrap_stepper_for_land(stepper, model)
        else:
            stepper = wrap_stepper_for_soil(stepper, model)
    dtype = torch.promote_types(_dtype_of(t0), _dtype_of(dt0))
    config = _with_exponents(config, stepper)
    return _drive(lambda Y, t, dt: stepper.step(rhs, Y, Ya, t, dt), Y, t0, tf, dt0, config, dtype, log=log,
                  replay=replay)


def run_adaptive_forced(
    model,
    Y: dict,
    Ya: dict,
    t0,
    tf,
    dt0,
    forcing: dict,
    forcing_dt: float,
    forcing_t0: float = 0.0,
    stepper: AbstractTimestepper = SSPRK33(),
    config: AdaptiveConfig = AdaptiveConfig(),
    engine: str = "torch",
    steps_per_call: int = 8,
    tile_cols: int = 128,
    log=None,
    replay=None,
):
    """Error-controlled integration under streamed time-varying forcing.

    ``forcing`` is a dict of ``(n_rows,)`` or ``(n_rows, ncol)`` tables on
    the uniform grid ``forcing_t0 + i * forcing_dt``, applied
    piecewise-constant in time: every trial step reads the row containing
    its start time, so step sizes need not align with the forcing grid
    (rows clamp at the table ends).

    ``engine="torch"`` (the JAX package's ``"xla"``) wraps the stepper in
    :class:`~landhydrology_tpu_torch.runtime.forcing_driver.TimeForcedStepper`
    (the row frozen at the step's start, the model's policies applied per
    step) inside :func:`run_adaptive`; ``engine="fused"`` streams the table
    through the kernel's time-indexed rows inside :func:`run_adaptive_fused`
    (macro-segment granularity).  Both return ``(Y_final, stats)`` and
    append each iteration's ``(t, dt, err, accept, dt_new)`` to ``log``
    (``replay``: see :func:`run_adaptive`)."""
    if engine == "fused":
        return run_adaptive_fused(
            model, Y, Ya, t0, tf, dt0,
            stepper=stepper, config=config, steps_per_call=steps_per_call,
            tile_cols=tile_cols, forcing=forcing, forcing_dt=forcing_dt, forcing_t0=forcing_t0, log=log,
            replay=replay,
        )
    if engine != "torch":
        raise ValueError(f"unknown engine {engine!r} (torch or fused)")

    from landhydrology_tpu_torch.runtime.forcing_driver import TimeForcedStepper

    soil = model.soil if isinstance(model, LandModel) else model
    device = next(iter(Y[soil.name].values())).device
    dtype = model.float_dtype
    grid = make_function_space(soil.domain, dtype, device)
    tables = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in forcing.items()}
    # the freeze-thaw projection wraps once around the inner stepper; the
    # row-local policy wraps are applied per step inside TimeForcedStepper
    if getattr(soil, "freeze_thaw", None) is not None:
        stepper = wrap_stepper_with_projection(stepper, soil)
    wrapped = TimeForcedStepper(
        inner=stepper, model=model, grid=grid, tables=tables,
        t_start=float(forcing_t0), dt_forcing=float(forcing_dt),
    )
    # TimeForcedStepper builds the row-local rhs in every step and ignores
    # the rhs argument; policies ride inside it, so model=None here
    return run_adaptive(None, Y, Ya, t0, tf, dt0, stepper=wrapped, config=config, log=log, replay=replay)


def _clone(Y: dict) -> dict:
    return {group: {k: v.clone() for k, v in fields.items()} for group, fields in Y.items()}


def run_adaptive_fused(
    model,
    Y: dict,
    Ya: dict,
    t0,
    tf,
    dt0,
    stepper: AbstractTimestepper = SSPRK33(),
    config: AdaptiveConfig = AdaptiveConfig(),
    steps_per_call: int = 8,
    tile_cols: int = 128,
    forcing=None,
    forcing_dt: float | None = None,
    forcing_t0: float = 0.0,
    log=None,
    replay=None,
):
    """Error-controlled integration over fused segments: step doubling at
    ``steps_per_call`` granularity through the CUDA column kernels, which
    take the trial step size at run time (``dt_run``), so one kernel
    serves every step size.

    Each controller iteration advances one macro-step ``H = steps_per_call
    * dt``: the kernel runs once at ``dt`` and twice at ``dt/2``, the
    segment-end states drive the weighted error norm and PI controller of
    :func:`run_adaptive`, and the doubled solution is kept on acceptance.
    With ``steps_per_call=1`` this is :func:`run_adaptive` on the kernel.

    ``forcing``, ``forcing_dt`` and ``forcing_t0`` add streamed
    time-varying forcing: ``(n_rows,)`` or ``(n_rows, ncol)`` tables on the
    grid ``forcing_t0 + i * forcing_dt``, each step reading the row of its
    start time (the kernel's ``forcing_time_grid``).

    ``model`` is required: the kernel is built from it, and its step
    policies apply inside the kernel.  ``tile_cols`` is the kernel's
    columns per block.  Returns ``(Y_final, stats)`` like
    :func:`run_adaptive`, where ``n_accepted`` / ``n_rejected`` count
    macro-steps, and appends each iteration's ``(t, dt, err, accept,
    dt_new)`` to ``log`` (``replay``: see :func:`run_adaptive`).  ``Y`` is
    left as it was."""
    from landhydrology_tpu_torch.ops.cuda.column_kernel import make_fused_column_run

    dtype = model.float_dtype
    soil = model.soil if isinstance(model, LandModel) else model
    device = next(iter(Y[soil.name].values())).device
    spc = int(steps_per_call)

    forcing_kwargs = {}
    if forcing is not None:
        if forcing_dt is None:
            raise ValueError("forcing requires forcing_dt (the row spacing)")
        forcing = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in forcing.items()}
        n_rows = next(iter(forcing.values())).shape[0]
        forcing_kwargs = dict(
            forcing_fields=tuple(sorted(forcing)),
            forcing_time_grid=(float(forcing_t0), float(forcing_dt), n_rows),
        )
    fused = make_fused_column_run(model, stepper, dt=float(_scalar(dt0, dtype)), steps_per_call=spc,
                                  tile_cols=tile_cols, **forcing_kwargs)

    def segment(Y, t, dt):  # the fused run updates in place: step a clone
        return fused(_clone(Y), t, forcing=forcing, dt_run=dt)

    return _drive(segment, Y, t0, tf, dt0, _with_exponents(config, stepper), dtype, spc, log=log, replay=replay)
