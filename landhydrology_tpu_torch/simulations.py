"""Simulation loop — time integration with strided saving.

PyTorch port of ``landhydrology_tpu/simulations.py``.  A
:class:`Simulation` steps a model from ``tspan[0]`` to ``tspan[1]`` and saves
the state every ``saveat`` (the initial state first), with host-side
callbacks at the save points.  Two engines:

- ``"torch"``: the eager loop of ``stepper.step`` calls (the analogue of
  the JAX package's XLA engine);
- ``"fused"``: the CUDA column kernels (``ops/cuda/column_kernel.py``, the
  analogue of the ``"pallas"`` engine), ``steps_per_call`` steps per
  launch, with time carried in the model dtype: the explicit steppers
  (ForwardEuler, SSPRK22, SSPRK33, SSPRK104, under a MOST top and with a
  LandModel too) and the implicit steppers of ``imex.py``, whose ``model``
  must be the simulation's.

An implicit stepper's grid is rebuilt on the model's device; with its step
policies it runs on the fused engine on the coupled soil, under a MOST top
too, and on the water-only soil (lagged coefficients, ``assume_no_ice``).
A ``LandModel`` (soil + pond, ``models/land.py``) runs on both
engines, its soil with freeze-thaw or ``assume_no_ice`` too, or water-only
under a plain top: its soil component
owns the freeze-thaw projection, and its step-level policies (frozen
surface exchange, lagged coefficients) wrap the stepper as
``wrap_stepper_for_land`` does.  Per-column BC kinds and depths run on
both engines; a ``LateralSurfaceCoupling`` couples columns and runs on the
eager engine only (the fused engine raises ``ValueError``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.imex import IMPLICIT_STEPPERS
from landhydrology_tpu_torch.models.land import wrap_stepper_for_land
from landhydrology_tpu_torch.models.soil.freeze_thaw import wrap_stepper_with_projection
from landhydrology_tpu_torch.models.soil.lagged import wrap_stepper_for_soil
from landhydrology_tpu_torch.models.soil.rhs import make_rhs
from landhydrology_tpu_torch.timestepping import SSPRK33, AbstractTimestepper, tree_map


def _copy(Y: dict) -> dict:
    return tree_map(torch.clone, Y)


class Solution:
    """Saved trajectory: ``ts`` ``(n_saved,)`` and ``us``, a state dict whose
    tensors are stacked along a leading save axis."""

    def __init__(self, ts, us: dict):
        self.ts = ts
        self.us = us

    def __len__(self) -> int:
        return int(self.ts.shape[0])

    def state(self, k: int) -> dict:
        """The k-th saved state (supports negative indices)."""
        return tree_map(lambda x: x[k], self.us)


class Simulation:
    """Wraps a model + stepper + state and integrates it.

    ``Y_init``/``Ya_init`` may be ``None`` to use the model's default ICs.
    ``saveat`` is a time interval, (close to) an integer multiple of ``dt``.
    ``callbacks`` are ``fn(Y, t) -> Optional[Y]`` run on the host at every
    save point; a returned dict replaces the state.  The initial state is
    never modified.
    """

    def __init__(
        self,
        model,
        stepper: AbstractTimestepper = SSPRK33(),
        *,
        Y_init: Optional[dict] = None,
        Ya_init: Optional[dict] = None,
        dt: float,
        tspan: tuple,
        saveat: Optional[float] = None,
        callbacks=None,
        engine: str = "torch",
        steps_per_call: int = 48,
        tile_cols: int = 128,
    ):
        soil = getattr(model, "soil", model)
        if Y_init is None:
            Y_init, Ya_init = model.default_initial_conditions()
        elif Ya_init is None:
            from landhydrology_tpu_torch.models.soil.initial_conditions import (
                initialize_auxiliary,
            )

            grid0 = make_function_space(soil.domain, soil.float_dtype, soil.device)
            Ya_init = initialize_auxiliary(
                soil, torch.as_tensor(tspan[0], dtype=soil.float_dtype), grid0.zc
            )
        if engine not in ("torch", "fused"):
            raise ValueError(f"unknown engine {engine!r}")
        self.model = model
        if isinstance(stepper, IMPLICIT_STEPPERS):
            # the implicit steppers solve on their grid: the run's own
            stepper = dataclasses.replace(
                stepper, grid=make_function_space(model.domain, model.float_dtype, model.device)
            )
        # step policies, as the JAX package applies them: the equilibrium
        # projection (owned by the soil) wraps the stepper and the lagged
        # coefficients / frozen surface exchange are outermost, so each step
        # is coefficients, stages, projection; the fused engine runs the
        # same order inside the kernel
        stepper = wrap_stepper_with_projection(stepper, soil)
        if soil is model:
            stepper = wrap_stepper_for_soil(stepper, model)
        else:
            stepper = wrap_stepper_for_land(stepper, model)
        self.stepper = stepper
        self.dt = float(dt)
        self.tspan = (float(tspan[0]), float(tspan[1]))
        self.Y = Y_init
        self.Ya = Ya_init
        self.t = self.tspan[0]
        self.saveat = None if saveat is None else float(saveat)
        self.callbacks = list(callbacks) if callbacks else []
        self.engine = engine
        self._dtype = model.float_dtype
        self._rhs = model.make_rhs() if hasattr(model, "make_rhs") else make_rhs(model)
        self._steps_per_call = int(steps_per_call)
        self._tile_cols = int(tile_cols)
        self._fused_runs: dict = {}
        if engine == "fused":
            self._fused(1)  # validates the model, stepper and tile now
        self._warn_if_cfl_unstable(model)

    def _fused(self, spc: int):
        """The fused run advancing ``spc`` steps per call (memoized)."""
        if spc not in self._fused_runs:
            from landhydrology_tpu_torch.ops.cuda.column_kernel import (
                make_fused_column_run,
            )

            self._fused_runs[spc] = make_fused_column_run(
                self.model, self.stepper, dt=self.dt, steps_per_call=spc,
                tile_cols=self._tile_cols,
            )
        return self._fused_runs[spc]

    def _warn_if_cfl_unstable(self, model) -> None:
        """Warn when the explicit dt exceeds ~4x the estimated Richards CFL
        limit of the initial state (see diagnostics.explicit_dt_limit); a
        LandModel's soil is read."""
        from landhydrology_tpu_torch.models.soil.model import (
            SoilHydrologyModel,
            SoilModel,
        )

        model = getattr(model, "soil", model)
        if not isinstance(model, SoilModel):
            return
        if not isinstance(model.hydrology_model, SoilHydrologyModel):
            return
        if getattr(self.stepper, "unconditionally_stable", False):
            return
        from landhydrology_tpu_torch.diagnostics import explicit_dt_limit

        limit = float(explicit_dt_limit(model, self.Y))
        if self.dt > 4.0 * limit:
            warnings.warn(
                f"dt={self.dt:g} exceeds ~4x the estimated explicit Richards "
                f"CFL limit ({limit:.3g}s) for this initial state "
                "(saturated-zone diffusivity is K/S_s); expect instability — "
                "reduce dt",
                RuntimeWarning,
                stacklevel=3,
            )

    def _advance(self, Y: dict, t, n: int, spc: Optional[int] = None):
        """Advance ``n`` steps from ``(Y, t)``.  The fused engine updates
        ``Y`` in place, ``spc`` steps per call; by default ``spc`` is the
        largest divisor of ``n`` not above ``steps_per_call``."""
        dt = torch.as_tensor(self.dt, dtype=self._dtype)
        if self.engine == "torch":
            for _ in range(n):
                Y = self.stepper.step(self._rhs, Y, self.Ya, t, dt)
                t = t + dt
            return Y, t
        if spc is None:
            spc = min(self._steps_per_call, n)
            while n % spc:
                spc -= 1
        fused = self._fused(spc)
        for _ in range(n // spc):
            Y = fused(Y, t)
            t = t + spc * dt
        return Y, t

    # -- reference step!/run! analogues --

    def step(self) -> None:
        """Advance one time step."""
        self.Y = self.stepper.step(
            self._rhs, self.Y, self.Ya,
            torch.as_tensor(self.t, dtype=self._dtype),
            torch.as_tensor(self.dt, dtype=self._dtype),
        )
        self.t += self.dt

    def run(self, sink=None) -> Solution:
        """Integrate from the current (Y, t) to ``tspan[1]`` and return the
        saved trajectory (also stored on ``self.sol``).  A last partial save
        interval is integrated and appended as the final saved state."""
        if sink is not None:
            raise NotImplementedError(
                "trajectory sinks are not ported yet: ROADMAP A16"
            )
        Y0, t0 = self.Y, self.t
        n_steps = max(0, int(round((self.tspan[1] - t0) / self.dt)))
        if self.saveat is not None:
            save_every = max(1, int(round(self.saveat / self.dt)))
        else:
            save_every = max(1, n_steps)
        n_saves, rem = divmod(n_steps, save_every)

        Y = _copy(Y0)
        t = torch.as_tensor(t0, dtype=self._dtype)
        ts_list, us_list = [t], [Y0]  # torch.stack copies at the end
        for _ in range(n_saves):
            Y, t = self._advance(Y, t, save_every)
            for cb in self.callbacks:
                replaced = cb(Y, float(t))
                if replaced is not None:
                    Y = _copy(replaced)
            ts_list.append(t)
            us_list.append(_copy(Y))
        if rem:
            # one fused call for the whole tail, as the JAX engine does
            # without callbacks; with callbacks it uses the divisor rule
            Y, t = self._advance(Y, t, rem, None if self.callbacks else rem)
            ts_list.append(t)
            us_list.append(_copy(Y))
        self.Y = Y
        self.t = float(t)
        self.sol = Solution(
            ts=torch.stack(ts_list),
            us=tree_map(lambda *xs: torch.stack(xs), *us_list),
        )
        return self.sol


def step(simulation: Simulation) -> None:
    """Functional alias of :meth:`Simulation.step`."""
    simulation.step()


def run(simulation: Simulation) -> Solution:
    """Functional alias of :meth:`Simulation.run`."""
    return simulation.run()
