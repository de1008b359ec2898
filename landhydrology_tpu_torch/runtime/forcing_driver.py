"""Time-varying forcing driven runs: the consumer of the forcing pipeline.

PyTorch port of ``landhydrology_tpu/runtime/forcing_driver.py``.  Per-column
atmospheric forcing time series written once with
:func:`~landhydrology_tpu_torch.runtime.write_forcing` stream from the native
windowed reader (mmap and a background prefetch thread) into a forced run,
the card integrating window k while the host stages window k+1 through
pinned buffers on a side CUDA stream.

Contract: the forcing file is sampled on the run's step grid, row ``i``
holding the forcing applied during step ``i`` (piecewise constant over each
``dt``).

Field routing by name:

- keys matching :class:`PrescribedAtmosForcing` fields (``u_atm``,
  ``theta_atm``, ``q_atm``, ``z_atm``, ``theta_scale``, ``rho_a_sfc``)
  replace the top-face MOST forcing per step;
- ``precipitation`` feeds the :class:`SurfaceWaterModel` rain rate
  (LandModel runs only).

Rows may be scalars (one value per step) or per-column ``(ncol,)`` tensors.
Two engines, as in ``Simulation``: ``"torch"`` takes one eager step per row;
``"fused"`` streams the rows through the CUDA land kernel (kernel mode B7 of
``ops/cuda/column_kernel.py``), ``steps_per_call`` rows per launch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.imex import IMPLICIT_STEPPERS
from landhydrology_tpu_torch.models.land import LandModel, wrap_stepper_for_land
from landhydrology_tpu_torch.models.soil.boundary import PrescribedAtmosForcing, SoilColumnBC
from landhydrology_tpu_torch.models.soil.freeze_thaw import wrap_stepper_with_projection
from landhydrology_tpu_torch.models.soil.lagged import wrap_stepper_for_soil
from landhydrology_tpu_torch.timestepping import SSPRK33, AbstractTimestepper

Array = Any

#: PrescribedAtmosForcing field names a forcing file may drive
ATMOS_FIELDS = ("u_atm", "theta_atm", "z_atm", "theta_scale", "rho_a_sfc", "q_atm")


def _split_routing(model, field_names):
    """(atmos_keys, has_precip) after validating every field routes."""
    is_land = isinstance(model, LandModel)
    soil = model.soil if is_land else model
    top = soil.boundary_conditions.top
    atmos = [k for k in field_names if k in ATMOS_FIELDS]
    has_precip = "precipitation" in field_names
    unknown = set(field_names) - set(atmos) - {"precipitation"}
    if unknown:
        raise KeyError(
            f"forcing fields {sorted(unknown)} route nowhere; supported: "
            f"{ATMOS_FIELDS + ('precipitation',)}"
        )
    if atmos and not isinstance(top, PrescribedAtmosForcing):
        raise TypeError(
            "atmospheric forcing fields require a PrescribedAtmosForcing "
            f"top boundary; the model's top BC is {type(top).__name__}"
        )
    if has_precip and not is_land:
        raise TypeError(
            "'precipitation' forcing requires a LandModel (the rain rate "
            "feeds its SurfaceWaterModel)"
        )
    return atmos, has_precip


def _install_forcing_rows(model, rows: Dict[str, Array], atmos_keys, has_precip):
    """The model with one forcing row's values installed in its
    ``PrescribedAtmosForcing`` fields and its rain rate."""
    is_land = isinstance(model, LandModel)
    soil = model.soil if is_land else model
    bc = soil.boundary_conditions
    out = model
    if atmos_keys:
        top = dataclasses.replace(bc.top, **{k: rows[k] for k in atmos_keys})
        soil_t = dataclasses.replace(soil, boundary_conditions=SoilColumnBC(top=top, bottom=bc.bottom))
        out = dataclasses.replace(model, soil=soil_t) if is_land else soil_t
    if has_precip:
        P = rows["precipitation"]
        out = dataclasses.replace(out, surface=dataclasses.replace(out.surface, precipitation=lambda t: P))
    return out


def _row_local_step(stepper, model, grid):
    """``(rhs, stepper)`` of the row-local ``model``: the land or soil step
    policies (frozen exchange, lagged coefficients) wrapped around
    ``stepper`` for this row's model, as every engine applies them."""
    if isinstance(model, LandModel):
        return model.make_rhs(grid), wrap_stepper_for_land(stepper, model, grid)
    return model.make_rhs(grid), wrap_stepper_for_soil(stepper, model, grid)


def time_row(t, t_start, dt_forcing, n_rows: int) -> int:
    """The forcing row of a step starting at ``t``: ``(t - t_start)`` times
    the reciprocal of ``dt_forcing`` precomputed in ``t``'s dtype, truncated
    and clipped to ``[0, n_rows - 1]``.  A division here rounds differently
    and can truncate to the adjacent row when a step lands on a row
    boundary; the fused kernel computes exactly this product."""
    t = torch.as_tensor(t)
    inv_dtF = torch.tensor(1.0 / float(dt_forcing), dtype=t.dtype)
    x = (t - torch.tensor(float(t_start), dtype=t.dtype)) * inv_dtF
    return int(torch.clamp(torch.trunc(x), 0, n_rows - 1))


@dataclasses.dataclass(frozen=True)
class TimeForcedStepper(AbstractTimestepper):
    """Stepper wrapper applying TIME-indexed forcing rows: each ``step``
    reads the row whose interval contains the step's start time
    (:func:`time_row`), installs it into the model, and delegates to
    ``inner`` with the row-local rhs and step policies: forcing constant
    over the step, the fused kernel's ``forcing_time_grid`` semantics, with
    step sizes free of the forcing grid.  The ``rhs`` argument of
    :meth:`step` is ignored."""

    inner: AbstractTimestepper
    model: Any
    grid: Any
    tables: Dict[str, Array]
    t_start: float
    dt_forcing: float

    @property
    def order(self):
        return self.inner.order

    @property
    def stages(self):
        return self.inner.stages

    @property
    def unconditionally_stable(self):
        return self.inner.unconditionally_stable

    def step(self, rhs, Y: dict, Ya: dict, t: Array, dt: Array) -> dict:
        atmos_keys, has_precip = _split_routing(self.model, tuple(self.tables))
        n_rows = next(iter(self.tables.values())).shape[0]
        j = time_row(t, self.t_start, self.dt_forcing, n_rows)
        rows = {k: v[j] for k, v in self.tables.items()}
        m = _install_forcing_rows(self.model, rows, atmos_keys, has_precip)
        rhs_j, st = _row_local_step(self.inner, m, self.grid)
        return st.step(rhs_j, Y, Ya, t, dt)


def _state_device(model, Y: dict):
    soil = model.soil if isinstance(model, LandModel) else model
    return next(iter(Y[soil.name].values())).device


def make_forced_segment_run(
    model,
    stepper: AbstractTimestepper = SSPRK33(),
    dt: float = 1.0,
    field_names=(),
    engine: str = "torch",
    steps_per_call: int = 32,
    tile_cols: int = 128,
):
    """Build ``run(Y, Ya, t0, forcing) -> (Y', t')`` advancing one step per
    forcing row.

    ``forcing``: dict of ``(n_steps, ...)`` arrays or tensors (leading axis
    = step), converted to the model's dtype on the state's device; each step
    rebuilds the MOST boundary / rain rate from its row and takes one
    ``stepper`` step.  ``Y`` is left as it was.

    ``engine="torch"`` takes the steps eagerly; ``engine="fused"`` streams
    the rows through the CUDA land kernel (``forcing_fields`` of
    ``make_fused_column_run``) in launches of ``steps_per_call`` rows and a
    remainder launch, with the same piecewise-constant row semantics (on
    CPU tensors, through the kernel's plain version).
    """
    atmos_keys, has_precip = _split_routing(model, tuple(field_names))
    if engine == "fused":
        return _make_forced_fused_run(model, stepper, dt, tuple(field_names),
                                      steps_per_call=steps_per_call, tile_cols=tile_cols)
    if engine != "torch":
        raise ValueError(f"unknown engine {engine!r} (torch or fused)")

    soil = model.soil if isinstance(model, LandModel) else model
    dtype = model.float_dtype
    grid = make_function_space(soil.domain, dtype, soil.device)
    if isinstance(stepper, IMPLICIT_STEPPERS):
        stepper = dataclasses.replace(stepper, grid=grid)  # the implicit steppers solve on the run's grid
    stepper = wrap_stepper_with_projection(stepper, soil)
    dt_t = torch.as_tensor(dt, dtype=dtype)

    def run(Y, Ya, t0, forcing: Dict[str, Array]):
        device = _state_device(model, Y)
        rows = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in forcing.items()}
        n_steps = next(iter(rows.values())).shape[0]
        t = torch.as_tensor(t0, dtype=dtype)
        for i in range(n_steps):
            m = _install_forcing_rows(model, {k: v[i] for k, v in rows.items()}, atmos_keys, has_precip)
            rhs, st = _row_local_step(stepper, m, grid)
            Y = st.step(rhs, Y, Ya, t, dt_t)
            t = t + dt_t
        return Y, t

    return run


def _make_forced_fused_run(model, stepper, dt, field_names, *, steps_per_call, tile_cols):
    """The fused engine of :func:`make_forced_segment_run`: the rows go to
    the card once per call and each launch reads its chunk of them in place
    (one run object per chunk length)."""
    from landhydrology_tpu_torch.ops.cuda.column_kernel import make_fused_column_run

    dtype = model.float_dtype
    soil = model.soil if isinstance(model, LandModel) else model
    ncol = int(np.prod(soil.domain.batch_shape)) if soil.domain.batch_shape else 1
    fused_cache: dict = {}

    def fused_for(spc):
        if spc not in fused_cache:
            fused_cache[spc] = make_fused_column_run(
                model, stepper, dt=dt, steps_per_call=spc, tile_cols=tile_cols,
                forcing_fields=field_names,
            )
        return fused_cache[spc]

    fused_for(steps_per_call)  # validates the model, stepper and fields now

    def _rows(k, v, n_steps, device):
        v = torch.as_tensor(v, dtype=dtype, device=device)
        if tuple(v.shape) not in ((n_steps,), (n_steps, ncol)):
            raise ValueError(
                f"forcing field {k!r} has shape {tuple(v.shape)}; the fused engine "
                f"expects ({n_steps},) or ({n_steps}, {ncol})"
            )
        return v

    def run(Y, Ya, t0, forcing):
        device = _state_device(model, Y)
        n_steps = next(iter(forcing.values())).shape[0]
        forcing = {k: _rows(k, v, n_steps, device) for k, v in forcing.items()}
        Y = {group: {k: v.clone() for k, v in fields.items()} for group, fields in Y.items()}
        n_chunks, rem = divmod(n_steps, steps_per_call)
        t = torch.as_tensor(t0, dtype=dtype)
        for c in range(n_chunks):
            chunk = slice(c * steps_per_call, (c + 1) * steps_per_call)
            fused_for(steps_per_call)(Y, t, forcing={k: v[chunk] for k, v in forcing.items()})
            t = t + steps_per_call * dt
        if rem:
            tail = slice(n_chunks * steps_per_call, n_steps)
            fused_for(rem)(Y, t, forcing={k: v[tail] for k, v in forcing.items()})
            t = t + rem * dt
        return Y, t

    return run


class _PinnedStager:
    """Window staging onto the card: the reader fills one of two pinned
    host buffers (allocated once, used in turns), a side stream copies it
    to the card (and casts it to the model dtype there) and records an
    event.  A buffer is refilled only after its previous copy's event has
    completed."""

    def __init__(self, reader, window: int, device, dtype):
        file_dtype = torch.from_numpy(np.empty(0, reader.dtype)).dtype
        shape = (window, len(reader.field_names), reader.n_cols)
        self.reader, self.device, self.dtype = reader, device, dtype
        self.buffers = [torch.empty(shape, dtype=file_dtype, pin_memory=True) for _ in range(2)]
        self.events = [None, None]
        self.side = torch.cuda.Stream(device)
        self.compute = torch.cuda.current_stream(device)
        self.turn = 0

    def stage(self, i0: int, nt: int):
        """``(block, event)``: window [i0, i0+nt) as a ``(nt, n_fields,
        n_cols)`` tensor on the card, valid on the compute stream once it
        waits for ``event``."""
        b = self.turn
        self.turn ^= 1
        if self.events[b] is not None:
            self.events[b].synchronize()
        host = self.buffers[b][:nt]
        self.reader.read_into(i0, nt, host)
        with torch.cuda.stream(self.side):
            block = host.to(self.device, non_blocking=True).to(self.dtype)
            event = torch.cuda.Event()
            event.record(self.side)
        block.record_stream(self.compute)
        self.events[b] = event
        return block, event


def run_forced(
    model,
    Y: dict,
    Ya: dict,
    reader,
    stepper: AbstractTimestepper = SSPRK33(),
    dt: float = 1.0,
    t0: float = 0.0,
    window: int = 256,
    start: int = 0,
    stop: Optional[int] = None,
    fields=None,
    on_window=None,
    engine: str = "torch",
    steps_per_call: int = 32,
    tile_cols: int = 128,
    overlap: bool = True,
):
    """Integrate ``model`` from ``t0`` consuming forcing windows from a
    :class:`~landhydrology_tpu_torch.runtime.ForcingReader`: the end-to-end
    production loop, a three-stage pipeline:

    1. the reader's background thread prefetches window k+2 from disk into
       host memory;
    2. the host stages window k+1: on a CUDA state it reads the window
       straight into a pinned buffer and copies it to the card on a side
       stream (:class:`_PinnedStager`);
    3. the card integrates window k (``make_forced_segment_run``), queued
       as soon as its rows were staged; the compute stream waits for the
       window's copy event first.

    ``fields``: subset of ``reader.field_names`` to route (default: all).
    A field of width 1 becomes a scalar row per step, one of the model's
    column count a per-column row.  ``on_window(i0, Y, t)``: optional host
    callback after each window's dispatch.  ``overlap=False`` synchronizes
    after each window, so the host stages window k+1 only once the card
    has integrated window k: the measurement baseline for the overlap, not
    a production mode.

    Returns ``(Y, t)`` after ``stop - start`` steps (default: the whole
    file); ``Y`` is left as it was.
    """
    fields = list(reader.field_names) if fields is None else list(fields)
    missing = set(fields) - set(reader.field_names)
    if missing:
        raise KeyError(f"forcing fields {sorted(missing)} are not in the file {reader.field_names}")
    dtype = model.float_dtype
    batch = (model.soil if isinstance(model, LandModel) else model).domain.batch_shape
    ncol = int(np.prod(batch)) if batch else 1
    if reader.n_cols not in (1, ncol):
        raise ValueError(
            f"the forcing file has {reader.n_cols} columns; expected 1 or the model's {ncol} (batch {batch})"
        )
    seg = make_forced_segment_run(model, stepper, dt=dt, field_names=fields, engine=engine,
                                  steps_per_call=steps_per_call, tile_cols=tile_cols)
    device = _state_device(model, Y)
    stop = reader.n_times if stop is None else stop

    def rows_of(block):
        """{field: rows} of a ``(nt, n_fields, n_cols)`` block (views)."""
        nt = block.shape[0]
        out = {}
        for k in fields:
            v = block[:, reader.field_names.index(k), :]
            out[k] = v[:, 0] if reader.n_cols == 1 else v.reshape((nt, *batch))
        return out

    if device.type == "cuda":
        stager = _PinnedStager(reader, window, device, dtype)
        stage = stager.stage
    else:
        def stage(i0, nt):
            host = np.empty((nt, len(reader.field_names), reader.n_cols), dtype=reader.dtype)
            reader.read_into(i0, nt, host)
            return torch.from_numpy(host).to(dtype), None

    t, i0 = t0, start
    if i0 < stop:
        reader.prefetch(i0, min(window, stop - i0))
    while i0 < stop:
        nt = min(window, stop - i0)
        block, event = stage(i0, nt)
        if i0 + nt < stop:  # the reader stages the next window while the card computes this one
            reader.prefetch(i0 + nt, min(window, stop - i0 - nt))
        if event is not None:
            torch.cuda.current_stream(device).wait_event(event)
        Y, t = seg(Y, Ya, t, rows_of(block))
        if not overlap and device.type == "cuda":
            torch.cuda.synchronize(device)
        if on_window is not None:
            on_window(i0, Y, t)
        i0 += nt
    return Y, t
