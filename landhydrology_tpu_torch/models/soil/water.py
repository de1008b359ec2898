"""Soil-water (hydraulics) parameterizations — van Genuchten closures.

PyTorch port of ``landhydrology_tpu/models/soil/water.py``.  Every closure
is a branch-free tensor function over ``(nz, *batch)`` fields; branches
are ``torch.where`` selects whose untaken operand is first clamped into its
valid domain, so no NaN leaks out of the select.  The clamps keep the
reference's exact forms and order of operations.  ``torch.minimum`` /
``torch.maximum`` propagate NaN, as ``jnp.minimum`` / ``jnp.maximum`` /
``jnp.clip`` do, and split the gradient evenly at a tie as they do
(:func:`_maximum`, :func:`_minimum`, :func:`_clip`; ``torch.clamp`` would
pass it whole), so ``torch.autograd`` gives ``jax.grad``'s values.

Every hydraulics parameter may be a Python scalar or a ``(ncol,)`` tensor.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch

Array = Any


def _eps_of(x) -> float:
    """Machine epsilon of the dtype of ``x`` (Julia ``eps(FT)``); Python
    scalars count as float64."""
    return torch.finfo(x.dtype if torch.is_tensor(x) else torch.float64).eps


def _tiny_of(x) -> float:
    """Smallest positive normal of the dtype of ``x`` (log-domain guard)."""
    return torch.finfo(x.dtype if torch.is_tensor(x) else torch.float64).tiny


def _bound(b, like):
    """A Python bound as a 0-dim CPU tensor of ``like``'s dtype: an operand
    of ``torch.maximum`` / ``torch.minimum``, which (unlike ``torch.clamp``)
    split the gradient evenly where the operands tie, as ``jax.grad`` of
    ``jnp.maximum`` / ``jnp.minimum`` / ``jnp.clip`` does.  The values are
    those of ``torch.clamp``."""
    return _cpu_scalar(float(b), like.dtype)


@functools.lru_cache(maxsize=256)
def _cpu_scalar(b: float, dtype: torch.dtype):
    """One 0-dim CPU tensor per bound and dtype, made once."""
    return torch.tensor(b, dtype=dtype)


def _maximum(a, b):
    """Elementwise max of tensors and/or scalars (``jnp.maximum``, tie
    gradient split evenly)."""
    if torch.is_tensor(a) and torch.is_tensor(b):
        return torch.maximum(a, b)
    if torch.is_tensor(a):
        return torch.maximum(a, _bound(b, a))
    if torch.is_tensor(b):
        return torch.maximum(_bound(a, b), b)
    return max(a, b)


def _minimum(a, b):
    """Elementwise min of tensors and/or scalars (``jnp.minimum``, tie
    gradient split evenly)."""
    if torch.is_tensor(a) and torch.is_tensor(b):
        return torch.minimum(a, b)
    if torch.is_tensor(a):
        return torch.minimum(a, _bound(b, a))
    if torch.is_tensor(b):
        return torch.minimum(_bound(a, b), b)
    return min(a, b)


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``: ``minimum(maximum(x, lo), hi)``."""
    return _minimum(_maximum(x, lo), hi)


# --------------------------------------------------------------------------
# Conductivity factors
# --------------------------------------------------------------------------


class AbstractConductivityFactor:
    """Multiplicative hydraulic-conductivity factor."""


@dataclasses.dataclass(frozen=True)
class NoEffect(AbstractConductivityFactor):
    """Unity factor."""


@dataclasses.dataclass(frozen=True)
class TemperatureDependentViscosity(AbstractConductivityFactor):
    """Temperature-dependent viscosity factor exp(gamma (T - T_ref))."""

    gamma: Array = 2.64e-2
    T_ref: Array = 288.0


@dataclasses.dataclass(frozen=True)
class IceImpedance(AbstractConductivityFactor):
    """Ice-impedance factor 10^(-Omega f_i), Lundin (1990)."""

    omega: Array = 7.0


def viscosity_factor(factor: AbstractConductivityFactor, T: Array) -> Array:
    """``NoEffect`` -> 1; ``TemperatureDependentViscosity`` ->
    exp(gamma (T - T_ref))."""
    if isinstance(factor, TemperatureDependentViscosity):
        return torch.exp(factor.gamma * (T - factor.T_ref))
    return torch.ones_like(T)


def impedance_factor(factor: AbstractConductivityFactor, f_i: Array) -> Array:
    """``NoEffect`` -> 1; ``IceImpedance`` -> 10^(-Omega f_i), evaluated as
    exp(-Omega ln10 f_i)."""
    if isinstance(factor, IceImpedance):
        return torch.exp((-math.log(10.0)) * factor.omega * f_i)
    return torch.ones_like(f_i)


# --------------------------------------------------------------------------
# Hydraulics model
# --------------------------------------------------------------------------


class AbstractHydraulicsModel:
    """Soil-water retention/conductivity model."""


@dataclasses.dataclass(frozen=True)
class vanGenuchten(AbstractHydraulicsModel):
    """van Genuchten hydraulics parameters (loam defaults, theta_r = 0);
    ``m = 1 - 1/n``.  Every field may be a scalar or a per-column tensor."""

    n: Array = 1.56
    alpha: Array = 3.6  # 1/m
    Ksat: Array = 2.9e-7  # m/s
    theta_r: Array = 0.0

    @property
    def m(self) -> Array:
        return 1.0 - 1.0 / self.n


# --------------------------------------------------------------------------
# Closures
# --------------------------------------------------------------------------


def volumetric_liquid_fraction(vartheta_l: Array, nu_eff: Array) -> Array:
    """theta_l = min(vartheta_l, nu_eff)."""
    return _minimum(vartheta_l, nu_eff)


def effective_saturation(porosity: Array, vartheta_l: Array, theta_r: Array) -> Array:
    """S_l = (vartheta_l - theta_r)/(porosity - theta_r) with the safety
    clamp vartheta_l >= theta_r + eps(FT)."""
    vartheta_l_safe = _maximum(vartheta_l, theta_r + _eps_of(vartheta_l))
    return (vartheta_l_safe - theta_r) / (porosity - theta_r)


def matric_potential(hm: vanGenuchten, S: Array) -> Array:
    """psi_m = -((S^(-1/m) - 1) alpha^(-n))^(1/n) for S < 1, exactly 0 for
    S >= 1.  The power law is evaluated in the log domain on the clip of S
    to [eps, 1 - eps]; the tiny-guard protects the log from rounding to
    zero."""
    n, alpha, m = hm.n, hm.alpha, hm.m
    eps = _eps_of(S)
    S_safe = _clip(S, eps, 1.0 - eps)
    u_inv = torch.exp(torch.log(S_safe) * (-1.0 / m))
    base = (u_inv - 1.0) * alpha ** (-n)
    psi_unsat = -torch.exp(torch.log(_maximum(base, _tiny_of(S))) * (1.0 / n))
    return torch.where(S < 1.0, psi_unsat, 0.0)


def inverse_matric_potential(hm: vanGenuchten, psi: Array) -> Array:
    """S = (1 + (alpha |psi|)^n)^(-m) for psi <= 0; raises on positive psi."""
    if bool(torch.any(torch.as_tensor(psi) > 0)):
        raise ValueError("Matric potential is positive")
    n, alpha, m = hm.n, hm.alpha, hm.m
    return (1.0 + (alpha * torch.abs(psi)) ** n) ** (-m)


def pressure_head(hm: vanGenuchten, vartheta_l: Array, nu_eff: Array, S_s: Array) -> Array:
    """Matric potential when unsaturated (S_l_eff <= 1), else the positive
    compressibility head (vartheta_l - nu_eff)/S_s; both operands are
    evaluated on their clamped-valid domains, then selected."""
    S_l_eff = effective_saturation(nu_eff, vartheta_l, hm.theta_r)
    psi_unsat = matric_potential(hm, S_l_eff)
    psi_sat = (vartheta_l - nu_eff) / S_s
    return torch.where(S_l_eff <= 1.0, psi_unsat, psi_sat)


def _tie_gate(x: Array, bound, above: bool) -> Array:
    """The derivative of ``maximum(x, bound)`` (``above``) or
    ``minimum(x, bound)`` in ``x`` as ``jax.grad`` gives it: 1 on the side
    where x passes through, 0 on the other, and 1/2 where x ties with the
    bound (``jnp.maximum``/``jnp.minimum``/``jnp.clip`` split the cotangent
    evenly between the operands)."""
    passes = x > bound if above else x < bound
    return passes.to(x.dtype) + 0.5 * (x == bound).to(x.dtype)


def dpsi_dtheta(hm: vanGenuchten, vartheta_l: Array, nu_eff: Array, S_s: Array) -> Array:
    """``C = d psi / d vartheta_l`` of :func:`pressure_head`, in closed form.
    In the plain unsaturated region, with ``u_inv = S^(-1/m)``,

        C = -psi u_inv / (n m S (u_inv - 1) (nu_eff - theta_r));

    ``1/S_s`` where S > 1; 0 at S == 1 exactly, where S is clamped to
    [1 - eps, 1), below the dry clamp theta_r + eps and under the tiny guard;
    and half the one-sided value where an operand ties with a clamp's bound,
    the value ``jax.grad`` of the pressure head gives there (the JAX
    package's ``imex._dpsi_dtheta``)."""
    n, alpha, m, theta_r = hm.n, hm.alpha, hm.m, hm.theta_r
    eps = _eps_of(vartheta_l)
    tiny = _tiny_of(vartheta_l)
    floor = theta_r + eps
    S = (_maximum(vartheta_l, floor) - theta_r) / (nu_eff - theta_r)
    S_low = _maximum(S, eps)
    S_safe = _minimum(S_low, 1.0 - eps)
    u_inv = torch.exp(torch.log(S_safe) * (-1.0 / m))
    base = (u_inv - 1.0) * alpha ** (-n)
    psi = -torch.exp(torch.log(_maximum(base, tiny)) * (1.0 / n))
    gate = (
        _tie_gate(vartheta_l, floor, True)
        * _tie_gate(S, eps, True)
        * _tie_gate(S_low, 1.0 - eps, False)
        * _tie_gate(base, tiny, True)
    )
    C_unsat = (-psi) * u_inv / (n * m * S_safe * (u_inv - 1.0) * (nu_eff - theta_r))
    unsat = torch.where(S < 1.0, C_unsat * gate, 0.0)
    return torch.where(S <= 1.0, unsat, 1.0 / S_s)


def hydraulic_conductivity(
    hm: vanGenuchten, S: Array, viscosity_f: Array, impedance_f: Array
) -> Array:
    """Mualem-van Genuchten K = Ksat sqrt(S) (1 - (1 - S^(1/m))^m)^2
    * viscosity_f * impedance_f, with K = Ksat for S >= 1.  S is clipped to
    [eps, 1 - eps] before the log-domain power laws."""
    m, Ksat = hm.m, hm.Ksat
    eps = _eps_of(S)
    S_safe = _clip(S, eps, 1.0 - eps)
    u = torch.exp(torch.log(S_safe) * (1.0 / m))  # S^(1/m) in (0, 1)
    f = 1.0 - torch.exp(torch.log(_maximum(1.0 - u, _tiny_of(S))) * m)
    K_unsat = torch.sqrt(S_safe) * f * f
    K = torch.where(S < 1.0, K_unsat, 1.0)
    return K * Ksat * viscosity_f * impedance_f


def hydrostatic_profile(
    hm: vanGenuchten, z: Array, z_interface: Array, nu: Array, S_s: Array
) -> Array:
    """Augmented liquid fraction of the hydrostatic equilibrium profile with
    the water table at ``z_interface``: S(z) (nu - theta_r) + theta_r above
    it, the linear storage profile -S_s (z - z_nabla) + nu below."""
    alpha, m, n, theta_r = hm.alpha, hm.m, hm.n, hm.theta_r
    dz = _maximum(z - z_interface, 0.0)  # untaken branch stays real
    S = (1.0 + (alpha * dz) ** n) ** (-m)
    unsat = S * (nu - theta_r) + theta_r
    sat = -S_s * (z - z_interface) + nu
    return torch.where(z > z_interface, unsat, sat)


def ice_fraction_of_water(theta_l: Array, theta_i: Array) -> Array:
    """f_i = theta_i / (theta_l + theta_i), guarded against 0/0 in a dry
    column."""
    theta_w = theta_l + theta_i
    return theta_i * (1.0 / _maximum(theta_w, _eps_of(theta_w)))
