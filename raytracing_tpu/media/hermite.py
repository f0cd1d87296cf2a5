"""Hermite node form of the 2-D grid medium: the kernel-friendly layout.

A C1 piecewise-bicubic spline is determined inside each cell by the values
and (normalized) derivatives ``(f, df/dv, df/du, d2f/dvdu)`` at its four
corner nodes — the cubic Hermite form.  Converting the per-cell coefficient
tables of :class:`media.spline.GridMedium` (16 floats/cell/component) to
per-NODE data (4 floats/node/component) shrinks the fisheye medium from
~34 MB to ~9 MB and, crucially, turns the evaluation into *corner-node
gathers*: a ray only ever needs the 2x2 corner nodes of its current cell
instead of three spline evaluations per step (the reference's FITPACK
cost, RT_bench.py:435-464, 141-156).

Packed channel layout (one row per node, ``(ny*nx, 9)``):

    0: Z            (sampled n; bilinear interpolation needs values only)
    1-4: dn/dx spline  f, f_v, f_u, f_vu   (v = normalized y, u = x)
    5-8: dn/dy spline  f, f_v, f_u, f_vu

Within a cell the bicubic value reconstructs from the 2x2 corners with the
standard Hermite basis h00/h10/h01/h11 — exactly equal to the per-cell
polynomial (tested to f64 round-off in tests/test_hermite.py).
"""
from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np
from raytracing_tpu.utils import struct

from raytracing_tpu.media.spline import GridMedium


def _node_data(cells: np.ndarray) -> np.ndarray:
    """(ncy, ncx, 4, 4) power-basis cells -> (ncy+1, ncx+1, 4) node data.

    Node (I, J) takes (f, f_v, f_u, f_vu) from the adjacent cell
    (min(I, ncy-1), min(J, ncx-1)) at in-cell offsets (I - ciy, J - cix)
    in {0, 1}; C1 continuity of the source spline makes the choice of
    adjacent cell immaterial.
    """
    ncy, ncx = cells.shape[:2]
    out = np.empty((ncy + 1, ncx + 1, 4), cells.dtype)

    def powers(t):
        return (np.array([1.0, t, t * t, t ** 3], cells.dtype),
                np.array([0.0, 1.0, 2.0 * t, 3.0 * t * t], cells.dtype))

    p0, d0 = powers(0.0)
    p1, d1 = powers(1.0)
    # interior + bottom/left edge nodes from their own cell at offset 0
    out[:ncy, :ncx, 0] = np.einsum("yxab,a,b->yx", cells, p0, p0)
    out[:ncy, :ncx, 1] = np.einsum("yxab,a,b->yx", cells, d0, p0)
    out[:ncy, :ncx, 2] = np.einsum("yxab,a,b->yx", cells, p0, d0)
    out[:ncy, :ncx, 3] = np.einsum("yxab,a,b->yx", cells, d0, d0)
    # top row from the last cell row at v = 1
    out[ncy, :ncx, 0] = np.einsum("xab,a,b->x", cells[-1], p1, p0)
    out[ncy, :ncx, 1] = np.einsum("xab,a,b->x", cells[-1], d1, p0)
    out[ncy, :ncx, 2] = np.einsum("xab,a,b->x", cells[-1], p1, d0)
    out[ncy, :ncx, 3] = np.einsum("xab,a,b->x", cells[-1], d1, d0)
    # right column at u = 1
    out[:ncy, ncx, 0] = np.einsum("yab,a,b->y", cells[:, -1], p0, p1)
    out[:ncy, ncx, 1] = np.einsum("yab,a,b->y", cells[:, -1], d0, p1)
    out[:ncy, ncx, 2] = np.einsum("yab,a,b->y", cells[:, -1], p0, d1)
    out[:ncy, ncx, 3] = np.einsum("yab,a,b->y", cells[:, -1], d0, d1)
    # far corner at (1, 1)
    c = cells[-1, -1]
    out[ncy, ncx, 0] = np.einsum("ab,a,b->", c, p1, p1)
    out[ncy, ncx, 1] = np.einsum("ab,a,b->", c, d1, p1)
    out[ncy, ncx, 2] = np.einsum("ab,a,b->", c, p1, d1)
    out[ncy, ncx, 3] = np.einsum("ab,a,b->", c, d1, d1)
    return out


@struct.dataclass
class HermiteGridMedium:
    """2-D grid medium in packed Hermite node form.

    Evaluates identically to the source :class:`GridMedium` (same spline,
    different representation).  ``nodes`` is (ny*nx, 9) — see module
    docstring for channels.
    """

    nodes: Any       # (ny*nx, 9)
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
        c00 = self.nodes[flat]                    # (..., 9)
        c01 = self.nodes[flat + 1]
        c10 = self.nodes[flat + self.nx]
        c11 = self.nodes[flat + self.nx + 1]
        n = ((1 - uy) * ((1 - ux) * c00[..., 0] + ux * c01[..., 0])
             + uy * ((1 - ux) * c10[..., 0] + ux * c11[..., 0]))
        gx = _hermite2d(c00[..., 1:5], c01[..., 1:5], c10[..., 1:5],
                        c11[..., 1:5], uy, ux)
        gy = _hermite2d(c00[..., 5:9], c01[..., 5:9], c10[..., 5:9],
                        c11[..., 5:9], uy, ux)
        return n, (gx, gy)

    def n(self, x, y):
        return self.n_and_grad(x, y)[0]


def hermite_basis(t):
    """(h00, h10, h01, h11) at t — value/derivative blending weights."""
    t2 = t * t
    t3 = t2 * t
    return (2 * t3 - 3 * t2 + 1, t3 - 2 * t2 + t,
            -2 * t3 + 3 * t2, t3 - t2)


def _hermite2d(c00, c01, c10, c11, v, u):
    """Bicubic Hermite from 4-corner (f, f_v, f_u, f_vu) stacks."""
    hv0, gv0, hv1, gv1 = hermite_basis(v)
    hu0, gu0, hu1, gu1 = hermite_basis(u)

    def corner(c, hv, gv, hu, gu):
        return (c[..., 0] * hv * hu + c[..., 1] * gv * hu
                + c[..., 2] * hv * gu + c[..., 3] * gv * gu)

    return (corner(c00, hv0, gv0, hu0, gu0) + corner(c01, hv0, gv0, hu1, gu1)
            + corner(c10, hv1, gv1, hu0, gu0) + corner(c11, hv1, gv1, hu1, gu1))


def build_hermite_medium(gm: GridMedium, dtype=np.float32) -> HermiteGridMedium:
    """Convert a GridMedium's per-cell tables to packed Hermite node form."""
    ny, nx = gm.ny, gm.nx
    cx = np.asarray(gm.cx, np.float64).reshape(ny - 1, nx - 1, 4, 4)
    cy = np.asarray(gm.cy, np.float64).reshape(ny - 1, nx - 1, 4, 4)
    nodes = np.empty((ny, nx, 9), np.float64)
    nodes[..., 0] = np.asarray(gm.Z, np.float64)
    nodes[..., 1:5] = _node_data(cx)
    nodes[..., 5:9] = _node_data(cy)
    return HermiteGridMedium(
        nodes=jnp.asarray(nodes.reshape(ny * nx, 9), dtype),
        x0=gm.x0, y0=gm.y0, inv_hx=gm.inv_hx, inv_hy=gm.inv_hy,
        nx=nx, ny=ny)
