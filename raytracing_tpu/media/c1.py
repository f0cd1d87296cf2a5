"""Consistent-gradient ("C1") sampled media: n and grad n from ONE spline.

The reference's sampled pipeline interpolates n *bilinearly* from Z but
takes its gradient from independently fitted *bicubic* splines of
``np.gradient(Z)`` (RT_bench.py:455-458).  The two fields are therefore
inconsistent — grad n is NOT the derivative of the n the integrator
consumes — and that inconsistency is the measured floor on momentum
conservation for sampled media (docs/PRECISION.md "the sampled-media CV
floor": CV ~0.006 % at the reference pitch, unchanged at float64, so no
arithmetic fixes it; the medium itself breaks the conservation law).

This module is the repaired design the reference cannot express: fit ONE
not-a-knot bicubic spline S to the SAME samples Z and evaluate both fields
from it — n = S, grad n = the exact analytic derivative of S.  Momentum
conservation then holds at the medium level again, and the evaluation
needs only the 16 numbers of one spline patch per cell instead of the
parity form's 36 independent floats (4 bilinear corners + 16 + 16
gradient-spline coefficients) — 16/36 the gather traffic.

These media deliberately DIVERGE from reference parity (documented in
docs/PARITY.md): n is the bicubic interpolant of Z rather than the
bilinear one (closer to the true field — the bilinear n dominates the
parity medium's ~1.5e-4 deviation from the analytic fisheye), and grad n
interpolates the same nodal data through S's derivative rather than an
independent fit.  Use the parity builders (media/spline.py) to reproduce
the reference bit-for-bit; use these for production accuracy/conservation.

Layout mirrors media/hermite.py: per-NODE Hermite data of S —
``(f, f_v, f_u, f_vu)`` in cell-normalized units, 4 channels/node (the
parity Hermite form carries 9).
"""
from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np
from raytracing_tpu.utils import struct

from raytracing_tpu import config
from raytracing_tpu.media import grid as _grid
from raytracing_tpu.media.hermite import _node_data, hermite_basis


def hermite_dbasis(t):
    """Derivatives (h00', h10', h01', h11') of the Hermite basis at t."""
    t2 = t * t
    return (6.0 * t2 - 6.0 * t, 3.0 * t2 - 4.0 * t + 1.0,
            -6.0 * t2 + 6.0 * t, 3.0 * t2 - 2.0 * t)


def hermite_d2basis(t):
    """Second derivatives (h00'', h10'', h01'', h11'') of the basis at t."""
    return (12.0 * t - 6.0, 6.0 * t - 4.0,
            -12.0 * t + 6.0, 6.0 * t - 2.0)


def _hermite1(c, h):
    """Blend one corner-column stack c = (c0, c1) pairs with basis h."""
    h0, g0, h1, g1 = h
    return c[0] * h0 + c[1] * g0 + c[2] * h1 + c[3] * g1


def c1_blend(corners, u, v, inv_hx, inv_hy):
    """(n, gx, gy) of the C1 spline from a 4-channel corner accessor.

    ``corners(ch) -> (c00, c01, c10, c11)`` fetches channel ``ch``'s 2x2
    corner node values (c01 = +x neighbor, c10 = +y); how they are fetched
    is the caller's concern (the 2-D medium here, the z-collapsed 3-D
    patch in media/grid3.py).
    """
    f = corners(0)
    fv = corners(1)
    fu = corners(2)
    fw = corners(3)
    hv, dv = hermite_basis(v), hermite_dbasis(v)
    hu, du = hermite_basis(u), hermite_dbasis(u)

    def vblend(basis):
        # v-blend each corner COLUMN pair into cubic-in-u Hermite data:
        # p0/p1 = S at the u=0/1 edges, m0/m1 = dS/du there (functions of v)
        p0 = _hermite1((f[0], fv[0], f[2], fv[2]), basis)
        p1 = _hermite1((f[1], fv[1], f[3], fv[3]), basis)
        m0 = _hermite1((fu[0], fw[0], fu[2], fw[2]), basis)
        m1 = _hermite1((fu[1], fw[1], fu[3], fw[3]), basis)
        return p0, m0, p1, m1

    col = vblend(hv)
    n = _hermite1(col, hu)
    gu = _hermite1(col, du)
    gv = _hermite1(vblend(dv), hu)
    return n, gu * inv_hx, gv * inv_hy


@struct.dataclass
class C1GridMedium:
    """2-D sampled medium with grad n == the exact gradient of n.

    ``nodes`` is (ny*nx, 4): the Hermite node data ``(f, f_v, f_u, f_vu)``
    of one not-a-knot bicubic spline of the samples, in cell-normalized
    units.  ``n_and_grad`` evaluates the spline and its analytic partial
    derivatives from the same 4x4-number patch.
    """

    nodes: Any       # (ny*nx, 4)
    x0: float = struct.field(pytree_node=False)
    y0: float = struct.field(pytree_node=False)
    inv_hx: float = struct.field(pytree_node=False)
    inv_hy: float = struct.field(pytree_node=False)
    nx: int = struct.field(pytree_node=False)
    ny: int = struct.field(pytree_node=False)
    def _cell(self, x, y):
        fx = (x - self.x0) * self.inv_hx
        fy = (y - self.y0) * self.inv_hy
        fx = jnp.clip(fx, 0.0, float(self.nx - 1))
        fy = jnp.clip(fy, 0.0, float(self.ny - 1))
        ix = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, self.nx - 2)
        iy = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, self.ny - 2)
        return ix, iy, fx - ix, fy - iy

    def n_and_grad(self, x, y):
        """Gather-based evaluation (scan tier)."""
        ix, iy, ux, uy = self._cell(x, y)
        flat = iy * self.nx + ix
        c00 = self.nodes[flat]
        c01 = self.nodes[flat + 1]
        c10 = self.nodes[flat + self.nx]
        c11 = self.nodes[flat + self.nx + 1]

        def corners(ch):
            return (c00[..., ch], c01[..., ch], c10[..., ch], c11[..., ch])

        n, gx, gy = c1_blend(corners, ux, uy, self.inv_hx, self.inv_hy)
        return n, (gx, gy)

    def n(self, x, y):
        return self.n_and_grad(x, y)[0]


@struct.dataclass
class C1StratifiedMedium:
    """1-D consistent medium for x-independent fields (interface, vert).

    ``cn`` is (ny-1, 4): per-cell power coefficients (normalized offset)
    of one not-a-knot cubic spline of the y-samples; n is the spline,
    dn/dy its exact derivative — 4 floats/cell serve both fields (the
    parity StratifiedGridMedium gathers 2 value + 4 gradient floats).
    """

    cn: Any          # (ny-1, 4)
    y0: float = struct.field(pytree_node=False)
    inv_hy: float = struct.field(pytree_node=False)
    ny: int = struct.field(pytree_node=False)

    def n_and_grad(self, x, y):
        fy = (y - self.y0) * self.inv_hy
        fy = jnp.clip(fy, 0.0, float(self.ny - 1))
        iy = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, self.ny - 2)
        uy = fy - iy
        c = self.cn[iy]
        n = c[..., 0] + uy * (c[..., 1] + uy * (c[..., 2] + uy * c[..., 3]))
        gy = (c[..., 1] + uy * (2.0 * c[..., 2] + uy * 3.0 * c[..., 3])
              ) * self.inv_hy
        return n, (jnp.zeros_like(gy), gy)

    def n(self, x, y):
        return self.n_and_grad(x, y)[0]


def _n_spline_cells(Z, y, x, backend: str = "auto"):
    """Per-cell (ncy, ncx, 4, 4) power coefficients of the not-a-knot
    bicubic interpolant of Z itself (float64)."""
    if backend == "auto":
        from raytracing_tpu import native
        backend = "native" if native.available() else "scipy"
    if backend == "native":
        from raytracing_tpu import native
        return native.bicubic_cells(np.asarray(Z, np.float64))
    from scipy.interpolate import RectBivariateSpline

    from raytracing_tpu.media.spline import _spline_to_cells
    spl = RectBivariateSpline(y, x, Z, kx=3, ky=3)
    return _spline_to_cells(spl, y, x)


def c1_medium_from_samples(Z, x, y, *, dtype=np.float32,
                           backend: str = "auto") -> C1GridMedium:
    """Consistent-gradient 2-D medium from user index samples.

    Same entry contract as spline.grid_medium_from_samples (uniform grids,
    >= 4x4), different field model: see the module docstring.
    """
    from raytracing_tpu.media.spline import check_uniform_grid

    Z, x, y, hx, hy = check_uniform_grid(Z, x, y)

    cells = _n_spline_cells(Z, y, x, backend)
    nodes = _node_data(np.ascontiguousarray(cells))          # (ny, nx, 4)
    ny, nx = nodes.shape[:2]
    inv_hx, inv_hy = 1.0 / hx, 1.0 / hy
    return C1GridMedium(
        nodes=jnp.asarray(nodes.reshape(ny * nx, 4), dtype),
        x0=float(x[0]), y0=float(y[0]), inv_hx=float(inv_hx),
        inv_hy=float(inv_hy), nx=nx, ny=ny)


def build_c1_medium(field: str, box, delta: float = config.DELTA,
                    dtype=np.float32, backend: str = "auto") -> C1GridMedium:
    """Sample ``field`` on the reference's padded grid, build a C1 medium."""
    x, y, Z = _grid.gen_grid(field, box, delta)
    return c1_medium_from_samples(Z, x, y, dtype=dtype, backend=backend)


def compact_c1_stratified(medium: C1StratifiedMedium, margin: int = 2,
                          y_range: tuple[float, float] | None = None
                          ) -> C1StratifiedMedium:
    """Trim a C1 stratified table to its reachable, nontrivial window.

    The C1 twin of media.spline.compact_stratified.  Constancy: cells where the cubic is
    flat (c1..c3 ~ 0) and the value matches the edge plateau; reachability
    (``y_range``): rows a boxed ray can never query.  Same contract as the
    parity trim: exact for reachable queries, clamping differs outside.
    """
    cn = np.asarray(medium.cn, np.float64)
    hy = 1.0 / medium.inv_hy
    lo, hi = 0, len(cn) - 1
    eps = float(np.finfo(np.float32).eps)
    tol_c = eps * float(np.abs(cn[:, 1:]).max() or 1.0)
    tol_z = eps * float(cn[:, 0].max() - cn[:, 0].min() or 1.0)
    nz_c = np.nonzero(np.abs(cn[:, 1:]).max(1) > tol_c)[0]
    nz_lo = np.nonzero(np.abs(cn[:, 0] - cn[0, 0]) > tol_z)[0]
    nz_hi = np.nonzero(np.abs(cn[:, 0] - cn[-1, 0]) > tol_z)[0]
    if len(nz_c) and len(nz_lo) and len(nz_hi):
        lo = max(lo, int(min(nz_c.min(), nz_lo.min() - 1)) - margin)
        hi = min(hi, int(max(nz_c.max(), nz_hi.max() + 1)) + margin)
    if y_range is not None:
        y_lo, y_hi = y_range
        lo = max(lo, int(np.floor((y_lo - medium.y0) / hy)) - margin)
        hi = min(hi, int(np.ceil((y_hi - medium.y0) / hy)) + margin)
    lo = max(lo, 0)
    hi = min(hi, len(cn) - 1)
    if (lo <= 0 and hi >= len(cn) - 1) or hi < lo:
        return medium
    return C1StratifiedMedium(
        cn=medium.cn[lo:hi + 1],
        y0=float(medium.y0 + lo * hy), inv_hy=medium.inv_hy,
        ny=hi - lo + 2)


def c1_stratified_from_samples(samples, y, *,
                               dtype=np.float32) -> C1StratifiedMedium:
    """1-D consistent-gradient medium from a USER-measured profile.

    One not-a-knot cubic of the (ny,) ``samples`` serves n and dn/dy
    exactly — the profile counterpart of :func:`c1_medium_from_samples`
    and the conservation-grade alternative to
    spline.stratified_medium_from_samples on the same data.
    """
    from raytracing_tpu.media.spline import _check_profile, cubic_cells_1d

    samples, y, hy = _check_profile(samples, y)
    return C1StratifiedMedium(
        cn=jnp.asarray(cubic_cells_1d(samples), dtype),
        y0=float(y[0]), inv_hy=float(1.0 / hy), ny=len(y))


def build_c1_stratified(field: str, box, delta: float = config.DELTA,
                        dtype=np.float32) -> C1StratifiedMedium:
    """1-D consistent medium for the x-independent fields."""
    if field == "fisheye":
        raise ValueError("fisheye varies in x; use build_c1_medium")
    x, y, Z = _grid.gen_grid(field, box, delta)
    return c1_stratified_from_samples(Z[:, 0], y, dtype=dtype)
