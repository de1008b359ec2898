"""Explicit SSP Runge-Kutta steppers over dict-of-tensor states.

PyTorch port of ``landhydrology_tpu/timestepping.py``.  State arithmetic is
a map over the nested dict, so any model family plugs in.  SSPRK33 follows
Shu & Osher (1988) with stage times c = (0, 1, 1/2):

    u1 = u + dt f(u, t)
    u2 = 3/4 u + 1/4 (u1 + dt f(u1, t + dt))
    u+ = 1/3 u + 2/3 (u2 + dt f(u2, t + dt/2))
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

Array = Any
RHS = Callable[[dict, dict, Array], dict]


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over nested dicts of identical structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _axpy(a, x: dict, y: dict) -> dict:
    """y + a * x over nested dicts."""
    return tree_map(lambda xi, yi: yi + a * xi, x, y)


def _lincomb2(a, x: dict, b, y: dict) -> dict:
    return tree_map(lambda xi, yi: a * xi + b * yi, x, y)


class AbstractTimestepper:
    """A stepper advances (Y, t) -> Y(t+dt) given the rhs function."""

    #: number of rhs evaluations per step
    stages: int = 1
    #: formal temporal order of accuracy
    order: int = 1
    #: True for implicit steppers with no CFL restriction
    unconditionally_stable: bool = False

    def step(self, rhs: RHS, Y: dict, Ya: dict, t: Array, dt: Array) -> dict:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ForwardEuler(AbstractTimestepper):
    """1st-order explicit Euler."""

    stages = 1
    order = 1

    def stage_times(self, t, dt) -> tuple:
        """The time of the one rhs evaluation."""
        return (t,)

    def step(self, rhs, Y, Ya, t, dt):
        (t1,) = self.stage_times(t, dt)
        return _axpy(dt, rhs(Y, Ya, t1), Y)


@dataclasses.dataclass(frozen=True)
class SSPRK22(AbstractTimestepper):
    """2nd-order, 2-stage SSP RK (Heun)."""

    stages = 2
    order = 2

    def stage_times(self, t, dt) -> tuple:
        """The times of the two rhs evaluations."""
        return (t, t + dt)

    def step(self, rhs, Y, Ya, t, dt):
        t1, t2 = self.stage_times(t, dt)
        u1 = _axpy(dt, rhs(Y, Ya, t1), Y)
        u2 = _axpy(dt, rhs(u1, Ya, t2), u1)
        return _lincomb2(0.5, Y, 0.5, u2)


@dataclasses.dataclass(frozen=True)
class SSPRK33(AbstractTimestepper):
    """3rd-order, 3-stage SSP RK of Shu & Osher."""

    stages = 3
    order = 3

    def stage_times(self, t, dt) -> tuple:
        """The times of the three rhs evaluations."""
        return (t, t + dt, t + 0.5 * dt)

    def step(self, rhs, Y, Ya, t, dt):
        t1, t2, t3 = self.stage_times(t, dt)
        u1 = _axpy(dt, rhs(Y, Ya, t1), Y)
        u2_inner = _axpy(dt, rhs(u1, Ya, t2), u1)
        u2 = _lincomb2(0.75, Y, 0.25, u2_inner)
        u3_inner = _axpy(dt, rhs(u2, Ya, t3), u2)
        return _lincomb2(1.0 / 3.0, Y, 2.0 / 3.0, u3_inner)


@dataclasses.dataclass(frozen=True)
class SSPRK104(AbstractTimestepper):
    """4th-order, 10-stage optimal SSP RK (Ketcheson 2008) in its
    two-register low-storage form."""

    stages = 10
    order = 4

    def stage_times(self, t, dt) -> tuple:
        """The times of the ten rhs evaluations, as the JAX package's step
        computes them in the model dtype: ``dt/6`` accumulated from ``t``
        over the first five, then from ``t + dt/3`` (``15 q2 - 5 q1``
        rewinds the stage time) over the last five."""
        sixth = dt / 6.0
        times = []
        for start in (t, t + (1.0 / 3.0) * dt):
            tq = start
            for _ in range(5):
                times.append(tq)
                tq = tq + sixth
        return tuple(times)

    def step(self, rhs, Y, Ya, t, dt):
        times = self.stage_times(t, dt)
        sixth = dt / 6.0
        q1 = Y
        for tq in times[:5]:
            q1 = _axpy(sixth, rhs(q1, Ya, tq), q1)
        q2 = _lincomb2(1.0 / 25.0, Y, 9.0 / 25.0, q1)
        q1 = _lincomb2(15.0, q2, -5.0, q1)
        for tq in times[5:9]:
            q1 = _axpy(sixth, rhs(q1, Ya, tq), q1)
        f_last = rhs(q1, Ya, times[9])
        out = _lincomb2(1.0, q2, 3.0 / 5.0, q1)
        return _axpy(0.1 * dt, f_last, out)
