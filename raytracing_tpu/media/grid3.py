"""Sampled 3-D grid media: tri-Hermite per-cell tables (C1 family).

The reference's production medium is a *sampled* field — sample on a grid,
fit splines, trace through the fit (RT_bench.py:412-464) — but it is
strictly 2-D.  This module lifts that story to three dimensions the way
the C1 2-D family (media/c1.py) repaired it: fit ONE tensor-product
not-a-knot tricubic spline S to the samples and evaluate both n = S and
grad n = the exact analytic gradient of S, so momentum/Bouguer
conservation holds at the medium level (no inconsistent independent
gradient fits, docs/PRECISION.md).

Layout is the 3-D extension of media/c1.C1GridMedium's Hermite node form:
per NODE the 8 channels

    (f, f_u, f_v, f_uv, f_w, f_uw, f_vw, f_uvw)        u = x, v = y, w = z

in cell-normalized units (channel bit k set = one derivative in axis k of
(u, v, w)).  Inside a cell the tensor-product spline IS the tricubic
polynomial determined by the 2x2x2 corner nodes' 64 Hermite values, so
device evaluation is 8 corner gathers + Hermite tensor contractions —
pure FMAs and vmappable.

Construction is exact, not approximate: the nodal tangents come from 1-D
not-a-knot cubic-spline solves along each axis (tensor-product
construction — the operators commute), so the per-cell Hermite
reconstruction equals the tensor-product spline to round-off
(tests/test_grid3.py checks tricubic-polynomial reproduction and
gradient/value consistency).
"""
from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np
from raytracing_tpu.utils import struct

from raytracing_tpu.media.c1 import _hermite1, c1_blend, hermite_dbasis
from raytracing_tpu.media.hermite import hermite_basis
from raytracing_tpu.media.spline import _check_axis

#: 2-D c1_blend channel (f, f_v, f_u, f_vu) -> this module's channel index
#: for the w = 0 plane (add 4 for the +w-derivative partner channel)
_CH2D = (0, 2, 1, 3)


def _axis_tangents(F: np.ndarray, axis: int) -> np.ndarray:
    """Nodal derivatives of the not-a-knot cubic spline along ``axis``.

    In INDEX units (grid pitch 1), so the result is directly the
    cell-normalized Hermite tangent; physical derivatives multiply by the
    axis' inv_h at evaluation time.  Vectorized over every other axis.
    """
    from scipy.interpolate import CubicSpline

    Fm = np.moveaxis(np.asarray(F, np.float64), axis, 0)
    t = np.arange(Fm.shape[0], dtype=np.float64)
    d = CubicSpline(t, Fm, bc_type="not-a-knot")(t, 1)
    return np.moveaxis(d, 0, axis)


def check_uniform_grid3(F, x, y, z):
    """Validate user 3-D samples; returns (F, x, y, z, hx, hy, hz) as f64.

    ``F`` is indexed ``[iz, iy, ix]`` — the natural extension of the 2-D
    convention Z[iy, ix] (media/spline.check_uniform_grid, which this
    mirrors so validation semantics cannot drift between ranks).
    """
    F = np.asarray(F, np.float64)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    if F.shape != (len(z), len(y), len(x)):
        raise ValueError(f"F shape {F.shape} != (len(z), len(y), len(x)) = "
                         f"({len(z)}, {len(y)}, {len(x)})")
    if min(len(x), len(y), len(z)) < 4:
        raise ValueError("tricubic fitting needs at least a 4x4x4 grid")
    return (F, x, y, z, _check_axis("x", x), _check_axis("y", y),
            _check_axis("z", z))


@struct.dataclass
class C1Grid3Medium:
    """3-D sampled medium with grad n == the exact gradient of n.

    ``nodes`` is (nz*ny*nx, 8): Hermite node data of one tensor-product
    not-a-knot tricubic spline of the samples, channels as in the module
    docstring.  Queries clamp to the grid range (the FITPACK convention
    every sampled medium here follows, media/spline.GridMedium._cell).
    """

    nodes: Any       # (nz*ny*nx, 8)
    x0: float = struct.field(pytree_node=False)
    y0: float = struct.field(pytree_node=False)
    z0: float = struct.field(pytree_node=False)
    inv_hx: float = struct.field(pytree_node=False)
    inv_hy: float = struct.field(pytree_node=False)
    inv_hz: float = struct.field(pytree_node=False)
    nx: int = struct.field(pytree_node=False)
    ny: int = struct.field(pytree_node=False)
    nz: int = struct.field(pytree_node=False)
    def _cell(self, x, y, z):
        fx = (x - self.x0) * self.inv_hx
        fy = (y - self.y0) * self.inv_hy
        fz = (z - self.z0) * self.inv_hz
        fx = jnp.clip(fx, 0.0, float(self.nx - 1))
        fy = jnp.clip(fy, 0.0, float(self.ny - 1))
        fz = jnp.clip(fz, 0.0, float(self.nz - 1))
        ix = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, self.nx - 2)
        iy = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, self.ny - 2)
        iz = jnp.clip(jnp.floor(fz).astype(jnp.int32), 0, self.nz - 2)
        return ix, iy, iz, fx - ix, fy - iy, fz - iz

    def n_and_grad3(self, x, y, z):
        """Gather-based evaluation (scan tier): 8 corner nodes x 8 channels.

        The w (z) axis collapses first — each of the four xy corners blends
        its z-pair of (value, w-tangent) channel pairs into effective 2-D
        Hermite data — then the shared 2-D C1 blend (media/c1.c1_blend)
        finishes, so the in-plane algebra is bit-identical to the 2-D
        family's.  gz re-runs the w collapse with the derivative basis.
        """
        ix, iy, iz, ux, uy, uz = self._cell(x, y, z)
        flat = (iz * self.ny + iy) * self.nx + ix
        sy, sz = self.nx, self.nx * self.ny
        cs = [self.nodes[flat + dz * sz + dy * sy + dx]
              for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
        # cs order: (z, y, x) minor-to-major x -> index dx + 2*dy + 4*dz
        hw = hermite_basis(uz)
        dw = hermite_dbasis(uz)

        def wblend(basis):
            def corners(ch2d):
                b = _CH2D[ch2d]
                return tuple(
                    _hermite1((cs[k][..., b], cs[k][..., b + 4],
                               cs[k + 4][..., b], cs[k + 4][..., b + 4]),
                              basis)
                    for k in range(4))
            return corners

        n, gx, gy = c1_blend(wblend(hw), ux, uy, self.inv_hx, self.inv_hy)
        gz = c1_blend(wblend(dw), ux, uy,
                      self.inv_hx, self.inv_hy)[0] * self.inv_hz
        return n, (gx, gy, gz)

    def n3(self, x, y, z):
        return self.n_and_grad3(x, y, z)[0]


def nodes3_f64(F: np.ndarray) -> np.ndarray:
    """Float64 Hermite node table (nz, ny, nx, 8) of validated samples.

    One definition of the tensor-product tangent pipeline, shared by the
    f32 medium builder below and the split-word (df32) twin
    (engine/df_grid3.py) so the two can never drift.  Channel order as in
    the module docstring: index = kx + 2*ky + 4*kz with bit k = one
    derivative in that axis.
    """
    fu = _axis_tangents(F, 2)
    fv = _axis_tangents(F, 1)
    fw = _axis_tangents(F, 0)
    fuv = _axis_tangents(fu, 1)
    fuw = _axis_tangents(fu, 0)
    fvw = _axis_tangents(fv, 0)
    fuvw = _axis_tangents(fuv, 0)
    return np.stack([F, fu, fv, fuv, fw, fuw, fvw, fuvw], axis=-1)


def c1_medium3_from_samples(F, x, y, z, *, dtype=np.float32) -> C1Grid3Medium:
    """Tri-Hermite 3-D medium from USER-measured index samples.

    ``F`` is (nz, ny, nx) refractive-index values on the uniform grid
    spanned by coordinate vectors ``x``/``y``/``z``.  The 3-D counterpart
    of :func:`media.c1.c1_medium_from_samples`: measured 3-D fields (ocean
    eddies, atmospheric ducts) become traceable by
    :func:`engine.trace3d.trace3d` and the dynamic/eigenray 3-D tiers with
    no source edits — the entry point the reference's sample->fit->trace
    pipeline (RT_bench.py:412-464) implies but cannot express beyond 2-D.
    """
    F, x, y, z, hx, hy, hz = check_uniform_grid3(F, x, y, z)
    nodes = nodes3_f64(F)
    inv_hx, inv_hy, inv_hz = 1.0 / hx, 1.0 / hy, 1.0 / hz
    nz_, ny_, nx_ = F.shape
    return C1Grid3Medium(
        nodes=jnp.asarray(nodes.reshape(nz_ * ny_ * nx_, 8), dtype),
        x0=float(x[0]), y0=float(y[0]), z0=float(z[0]),
        inv_hx=float(inv_hx), inv_hy=float(inv_hy), inv_hz=float(inv_hz),
        nx=nx_, ny=ny_, nz=nz_)
