"""Refractive-index fields of the four scenarios, with analytic gradients.

Mirrors the scenario functions of the reference (RT_bench.py:104-119) and adds
closed-form gradients — the reference only ever obtains gradients numerically
through ``np.gradient`` + bicubic splines (RT_bench.py:450-458), whereas the
framework evaluates media two ways: *analytic* (this module — exact, cheap,
branch-free, the fast path for million-ray batches) and *grid/spline*
(:mod:`raytracing_tpu.media.spline` — bit-parity with the reference).

Every function is pure jnp, shape-polymorphic, and dtype-preserving, so the
same code runs scalar (parity tests), vmapped (ray batches), and inside Pallas
kernels.
"""
from __future__ import annotations

import jax.numpy as jnp

from raytracing_tpu.config import THCK_PARAM

_SQRT2 = 1.4142135623730951


# -- Sharp interface: sigmoid in y (RT_bench.py:106-108) --------------------
def _sigmoid(t):
    """Overflow-safe logistic 1/(1 + e^-t), jvp-safe in float32.

    The reference's literal form (RT_bench.py:107) computes ``e^-t`` which
    overflows float32 for t < ~ -88 — only |y| > 0.44 at THCK_PARAM =
    0.005, where the PRIMAL still rounds correctly (1/inf = 0) but any
    tangent through it is inf/inf = NaN, which silently poisoned f32
    dynamic/diff traces of the interface scenario.  Both branches here
    exponentiate ``-|t|`` (never overflows); the t >= 0 branch is the
    reference's expression verbatim, so f64 parity is bit-identical on
    the refracting side and within one ulp below.
    """
    # -|t| via a select of inputs, not jnp.abs: abs's jvp has a zero
    # "derivative" at t == 0, which would zero the sigmoid's tangent right
    # on the interface midline; the select's jvp picks a branch instead
    pos = t >= 0
    e = jnp.exp(jnp.where(pos, -t, t))
    return jnp.where(pos, 1.0 / (1.0 + e), e / (1.0 + e))


def interface(x, y):
    """n = sqrt(2) - (sqrt(2)-1) / (1 + exp(-y/THCK_PARAM))."""
    return _SQRT2 - (_SQRT2 - 1.0) * _sigmoid(y / THCK_PARAM)


def interface_grad(x, y):
    """Closed-form (dn/dx, dn/dy) of :func:`interface`."""
    sig = _sigmoid(y / THCK_PARAM)
    dndy = -(_SQRT2 - 1.0) * sig * (1.0 - sig) / THCK_PARAM
    return jnp.zeros_like(dndy), dndy


# -- Maxwell fisheye (RT_bench.py:110-112) ----------------------------------
def fisheye(x, y):
    """n = 1 / (1 + x^2 + y^2)."""
    return 1.0 / (1.0 + x * x + y * y)


def fisheye_grad(x, y):
    """(dn/dx, dn/dy) = -2 n^2 (x, y)."""
    n = fisheye(x, y)
    c = -2.0 * n * n
    return c * x, c * y


# -- Vertically heterogeneous (RT_bench.py:114-116) -------------------------
def vert_heterogeneous(x, y):
    """n = 1 / (18 + 2 y)."""
    return 1.0 / (18.0 + 2.0 * y)


def vert_heterogeneous_grad(x, y):
    """(dn/dx, dn/dy) = (0, -2 n^2)."""
    n = vert_heterogeneous(x, y)
    dndy = -2.0 * n * n
    return jnp.zeros_like(dndy), dndy


# -- Anisotropy factor (RT_bench.py:118-119) --------------------------------
def anisotropy(theta, gamma):
    """Elliptical angular factor sqrt((gamma sin t)^2 + cos^2 t).

    Multiplies an isotropic n to make the medium anisotropic; equals 1 for
    gamma == 1 (isotropic media).
    """
    s, c = jnp.sin(theta), jnp.cos(theta)
    return jnp.sqrt((gamma * s) ** 2 + c * c)


def anisotropy_uv(ux, uy, gamma):
    """:func:`anisotropy` expressed in the unit tangent (cos t, sin t).

    Avoids the sin/cos round-trip on the trig-free fast path: with
    u = (cos t, sin t), sqrt((gamma sin t)^2 + cos^2 t) = sqrt(g^2 uy^2 + ux^2).
    """
    return jnp.sqrt((gamma * uy) ** 2 + ux * ux)


#: field name -> (n(x, y), grad(x, y) -> (dndx, dndy))
FIELDS = {
    "interface": (interface, interface_grad),
    "fisheye": (fisheye, fisheye_grad),
    "vert_heterogeneous": (vert_heterogeneous, vert_heterogeneous_grad),
}
