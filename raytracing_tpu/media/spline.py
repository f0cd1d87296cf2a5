"""Device-evaluable spline medium with scipy RectBivariateSpline parity.

The reference evaluates its media through FITPACK: a bilinear
RectBivariateSpline for n and bicubic ones for each gradient component
(RT_bench.py:455-458), three spline evaluations per integration step — the
dominant cost of its hot loop (SURVEY.md §3.2).  FITPACK cannot run on an
accelerator, so this module converts each fitted spline into *per-cell polynomial
coefficient tables* once on host, after which device evaluation is a cell
lookup plus a 4x4 tensor Horner — pure gathers and FMAs, vmappable and
Pallas-friendly.

Conversion is sampling-exact: within each grid cell the fitted spline *is* a
bicubic polynomial, so sampling it on a 4x4 interior stencil and solving the
(fixed, well-conditioned) tensor Vandermonde system recovers the exact
polynomial regardless of FITPACK's knot conventions (not-a-knot boundaries
etc.).  Parity with scipy is checked to ~1e-10 in tests/test_spline.py.

Bilinear n needs no fitting at all: a kx=ky=1 interpolating spline *is*
bilinear interpolation of the grid values, evaluated directly from Z.
FITPACK clamps out-of-range queries to the grid boundary (fpbisp.f), and so
does this evaluator.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from raytracing_tpu.utils import struct

from raytracing_tpu import config
from raytracing_tpu.media import grid as _grid

#: normalized in-cell sample offsets for the exact-fit stencil; strictly
#: interior so every sample unambiguously belongs to its cell.
_STENCIL = np.array([1.0, 3.0, 5.0, 7.0]) / 8.0
#: inverse of the 4x4 Vandermonde at the stencil (u^a for a in 0..3).
_VINV = np.linalg.inv(np.vander(_STENCIL, 4, increasing=True))


def _spline_to_cells(spl, y, x):
    """Per-cell coefficients C[iy, ix, a, b]: S = sum C u_y^a u_x^b.

    u_* are cell-normalized offsets in [0, 1).  ``spl`` is a fitted
    scipy RectBivariateSpline over (y, x).
    """
    hy, hx = y[1] - y[0], x[1] - x[0]
    ncy, ncx = len(y) - 1, len(x) - 1
    ys = (y[:-1, None] + _STENCIL[None, :] * hy).ravel()   # (ncy*4,)
    xs = (x[:-1, None] + _STENCIL[None, :] * hx).ravel()   # (ncx*4,)
    vals = spl(ys, xs, grid=True).reshape(ncy, 4, ncx, 4)
    # Solve V C V^T = S for each cell: C = Vinv S Vinv^T.
    c = np.einsum("pa,iajb,qb->ipjq", _VINV, vals, _VINV)
    return np.ascontiguousarray(np.transpose(c, (0, 2, 1, 3)))  # (ncy,ncx,4,4)


@struct.dataclass
class GridMedium:
    """Grid-sampled medium: bilinear n + bicubic gradient, device-evaluable.

    Mirrors the reference's ``(z, grd)`` spline pair (RT_bench.py:435-464,
    141-156) as flat coefficient tables.
    """

    Z: Any            # (ny, nx) index samples, bilinear-interpolated for n
    cx: Any           # (ncy*ncx, 16) bicubic cells of dn/dx
    cy: Any           # (ncy*ncx, 16) bicubic cells of dn/dy
    x0: float = struct.field(pytree_node=False)
    y0: float = struct.field(pytree_node=False)
    inv_hx: float = struct.field(pytree_node=False)
    inv_hy: float = struct.field(pytree_node=False)
    nx: int = struct.field(pytree_node=False)
    ny: int = struct.field(pytree_node=False)

    def _cell(self, x, y):
        """Clamped cell index and normalized in-cell offsets."""
        fx = (x - self.x0) * self.inv_hx
        fy = (y - self.y0) * self.inv_hy
        # FITPACK clamps queries to the grid range (fpbisp.f); so do we.
        fx = jnp.clip(fx, 0.0, float(self.nx - 1))
        fy = jnp.clip(fy, 0.0, float(self.ny - 1))
        ix = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, self.nx - 2)
        iy = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, self.ny - 2)
        return ix, iy, fx - ix, fy - iy

    def n_and_grad(self, x, y):
        ix, iy, ux, uy = self._cell(x, y)

        # bilinear n from Z (== RectBivariateSpline kx=ky=1, RT_bench.py:455)
        z00 = self.Z[iy, ix]
        z01 = self.Z[iy, ix + 1]
        z10 = self.Z[iy + 1, ix]
        z11 = self.Z[iy + 1, ix + 1]
        n = ((1 - uy) * ((1 - ux) * z00 + ux * z01)
             + uy * ((1 - ux) * z10 + ux * z11))

        # bicubic gradient components (RT_bench.py:456-458)
        flat = iy * (self.nx - 1) + ix
        px = jnp.stack([jnp.ones_like(ux), ux, ux * ux, ux * ux * ux], -1)
        py = jnp.stack([jnp.ones_like(uy), uy, uy * uy, uy * uy * uy], -1)
        shape = flat.shape + (4, 4)
        # HIGHEST: a float32 contraction may otherwise run in TF32 on the GPU
        gx = jnp.einsum("...ab,...a,...b->...",
                        self.cx[flat].reshape(shape), py, px,
                        precision=jax.lax.Precision.HIGHEST)
        gy = jnp.einsum("...ab,...a,...b->...",
                        self.cy[flat].reshape(shape), py, px,
                        precision=jax.lax.Precision.HIGHEST)
        return n, (gx, gy)

    def n(self, x, y):
        return self.n_and_grad(x, y)[0]


@struct.dataclass
class StratifiedGridMedium:
    """1-D grid medium for x-independent fields (interface, vert).

    The reference samples these onto the full 2-D grid and fits 2-D splines
    (RT_bench.py:412-464) even though n varies only with y; the tensor-
    product spline of an x-constant field *is* its 1-D y-spline, so a
    (ny,) value table + (ny-1, 4) cubic cells reproduce the same medium with
    ~nx times less memory and one cheap 1-D gather per evaluation.
    """

    Zy: Any          # (ny,) index samples along y
    cy: Any          # (ny-1, 4) cubic cells of dn/dy (normalized offsets)
    y0: float = struct.field(pytree_node=False)
    inv_hy: float = struct.field(pytree_node=False)
    ny: int = struct.field(pytree_node=False)

    def n_and_grad(self, x, y):
        fy = (y - self.y0) * self.inv_hy
        fy = jnp.clip(fy, 0.0, float(self.ny - 1))
        iy = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, self.ny - 2)
        uy = fy - iy
        n = (1 - uy) * self.Zy[iy] + uy * self.Zy[iy + 1]
        c = self.cy[iy]
        gy = c[..., 0] + uy * (c[..., 1] + uy * (c[..., 2] + uy * c[..., 3]))
        return n, (jnp.zeros_like(gy), gy)

    def n(self, x, y):
        return self.n_and_grad(x, y)[0]


def cubic_cells_1d(vals: np.ndarray) -> np.ndarray:
    """(ny,) f64 samples -> (ny-1, 4) not-a-knot cubic cells.

    Power-basis coefficients in the normalized in-cell offset, same fit as
    the 2-D pipeline's y-direction (native builder when present; an
    x-constant bicubic's y-coefficients ARE the 1-D spline's).
    """
    vals = np.asarray(vals, np.float64)
    from raytracing_tpu import native

    if native.available():
        cells = native.bicubic_cells(np.stack([vals] * 4, -1))
        return cells[:, 0, :, 0]
    from scipy.interpolate import CubicSpline

    spl = CubicSpline(np.arange(len(vals)), vals, bc_type="not-a-knot")
    return np.stack([spl.c[3], spl.c[2], spl.c[1], spl.c[0]], axis=-1)


def _check_axis(name: str, v: np.ndarray) -> float:
    """Validate one coordinate vector: uniform AND ascending; returns h.

    Descending axes are rejected rather than silently accepted: a negative
    pitch inverts the (y0, inv_h) cell map and every box derived from the
    endpoints, freezing all rays at launch with no error.
    """
    h = float(v[1] - v[0])
    if h <= 0.0:
        raise ValueError(f"{name} grid must be ascending (got pitch {h}); "
                         "flip the axis and the sample rows")
    if not np.allclose(np.diff(v), h, rtol=1e-6, atol=1e-12):
        raise ValueError(f"{name} grid must be uniformly spaced")
    return h


def check_uniform_grid(Z, x, y):
    """Validate user 2-D samples; returns (Z, x, y, hx, hy) as float64.

    Shared by every from-samples builder (f32 parity/C1 and the df32
    split-word twins) so validation semantics cannot drift between them.
    """
    Z = np.asarray(Z, np.float64)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if Z.shape != (len(y), len(x)):
        raise ValueError(f"Z shape {Z.shape} != (len(y), len(x)) = "
                         f"({len(y)}, {len(x)})")
    if len(x) < 4 or len(y) < 4:
        raise ValueError("bicubic fitting needs at least a 4x4 grid")
    return Z, x, y, _check_axis("x", x), _check_axis("y", y)


def _check_profile(samples, y):
    samples = np.asarray(samples, np.float64)
    y = np.asarray(y, np.float64)
    if samples.ndim != 1 or samples.shape != y.shape:
        raise ValueError(f"samples shape {samples.shape} != y shape "
                         f"{y.shape} (want matching 1-D profiles)")
    if len(y) < 4:
        raise ValueError("cubic fitting needs at least 4 profile samples")
    return samples, y, _check_axis("y", y)


def stratified_medium_from_samples(samples, y, *, dtype=np.float32,
                                   gradient_spacing: float | None = None
                                   ) -> StratifiedGridMedium:
    """1-D parity-pipeline medium from a USER-measured profile.

    ``samples`` is (ny,) refractive-index values on the uniform coordinate
    vector ``y`` — e.g. a sound-speed-vs-depth profile.  Evaluation follows
    the reference pipeline restricted to an x-independent field
    (RT_bench.py:435-464: np.gradient for dn/dy, a not-a-knot cubic fit of
    it, linear interpolation for n), and the result runs at kernel tier
    through fast_trace's stratified family.  The profile counterpart of
    :func:`grid_medium_from_samples`.
    """
    samples, y, hy = _check_profile(samples, y)
    gs = float(gradient_spacing if gradient_spacing is not None else hy)
    dndy = np.gradient(samples, gs, edge_order=2)
    return StratifiedGridMedium(
        Zy=jnp.asarray(samples, dtype),
        cy=jnp.asarray(cubic_cells_1d(dndy), dtype),
        y0=float(y[0]), inv_hy=float(1.0 / hy), ny=len(y))


def build_stratified_medium(field: str, box, delta: float = config.DELTA,
                            dtype=np.float32) -> StratifiedGridMedium:
    """1-D sampled medium for the x-independent fields.

    Uses the same padded grid pitch and np.gradient edge handling as the 2-D
    pipeline (the reference's nominal DELTA spacing, RT_bench.py:450), just
    along a single column.
    """
    if field == "fisheye":
        raise ValueError("fisheye varies in x; use build_grid_medium")
    x, y, Z = _grid.gen_grid(field, box, delta)
    return stratified_medium_from_samples(Z[:, 0], y, dtype=dtype,
                                          gradient_spacing=delta)


def compact_stratified(medium: StratifiedGridMedium, margin: int = 2,
                       y_range: tuple[float, float] | None = None
                       ) -> StratifiedGridMedium:
    """Trim a stratified table to its reachable, nontrivial window.

    Two independent trims compose:

    * **constancy** — sharp-interface media are constant except near the
      transition (the sigmoid saturates within ~20 THCK_PARAM); outside
      that window the sampled n is constant and the gradient cells are
      zero to float32 resolution (not-a-knot ringing decays ~0.27/cell).
      Clamped evaluation on the trimmed table equals the full table within
      f32 rounding (interface: ~681 -> ~35 nodes).
    * **reachability** (``y_range``) — the grid is sampled over the box
      padded by +-3 (RT_bench.py:426-429), but a traced ray can never
      query outside the box plus one step (boundary exit freezes it), so
      rows beyond ``y_range`` (pass the scenario box's y extent) are dead
      weight.  Exact for every reachable query; queries outside the range
      clamp differently than the full table would.

    Returns ``medium`` unchanged when nothing can be trimmed.
    """
    Zy = np.asarray(medium.Zy, np.float64)
    cy = np.asarray(medium.cy, np.float64)
    hy = 1.0 / medium.inv_hy
    lo, hi = 0, len(cy) - 1   # cell window
    eps = float(np.finfo(np.float32).eps)
    tol_c = eps * float(np.abs(cy).max() or 1.0)
    tol_z = eps * float(Zy.max() - Zy.min() or 1.0)
    nz_c = np.nonzero(np.abs(cy).max(1) > tol_c)[0]
    nz_lo = np.nonzero(np.abs(Zy - Zy[0]) > tol_z)[0]
    nz_hi = np.nonzero(np.abs(Zy - Zy[-1]) > tol_z)[0]
    if len(nz_c) and len(nz_lo) and len(nz_hi):
        lo = max(lo, int(min(nz_c.min(), nz_lo.min() - 1)) - margin)
        hi = min(hi, int(max(nz_c.max(), nz_hi.max() + 1)) + margin)
    if y_range is not None:
        y_lo, y_hi = y_range
        lo = max(lo, int(np.floor((y_lo - medium.y0) / hy)) - margin)
        hi = min(hi, int(np.ceil((y_hi - medium.y0) / hy)) + margin)
    lo = max(lo, 0)
    hi = min(hi, len(cy) - 1)
    if (lo <= 0 and hi >= len(cy) - 1) or hi < lo:
        return medium
    return StratifiedGridMedium(
        Zy=medium.Zy[lo:hi + 2], cy=medium.cy[lo:hi + 1],
        y0=float(medium.y0 + lo * hy), inv_hy=medium.inv_hy,
        ny=hi - lo + 2)


def _gradient_tables_f64(Z, x, y, gs: float, backend: str = "auto"):
    """(cx, cy) per-cell bicubic tables of np.gradient(Z) in FULL float64.

    The host-side heart of the reference pipeline (np.gradient ->
    not-a-knot bicubic fit, RT_bench.py:435-464) kept at f64 so callers
    choose their own device precision — GridMedium casts once; the df32
    tier (engine/df_grid.py) splits hi/lo words instead.
    """
    if backend == "auto":
        from raytracing_tpu import native
        backend = "native" if native.available() else "scipy"

    if backend == "native":
        from raytracing_tpu import native
        dndx, dndy = native.gradient2(Z, gs)
        cx = native.bicubic_cells(dndx).reshape(-1, 16)
        cy = native.bicubic_cells(dndy).reshape(-1, 16)
    else:
        from scipy.interpolate import RectBivariateSpline

        dndx, dndy = _grid.gradient_grids(Z, gs)
        sx = RectBivariateSpline(y, x, dndx, kx=3, ky=3)
        sy = RectBivariateSpline(y, x, dndy, kx=3, ky=3)
        cx = _spline_to_cells(sx, y, x).reshape(-1, 16)
        cy = _spline_to_cells(sy, y, x).reshape(-1, 16)
    return cx, cy


def build_grid_medium(field: str, box, delta: float = config.DELTA,
                      dtype=np.float32, backend: str = "auto") -> GridMedium:
    """Sample ``field`` on the padded grid and build device tables.

    Reproduces the reference pipeline genZ -> np.gradient -> bicubic fit
    (RT_bench.py:1587-1588) with the fit converted to per-cell polynomials.

    ``backend``: "native" uses the C++ not-a-knot builder
    (raytracing_tpu/native) — same spline, no scipy; "scipy" forces the
    FITPACK fit; "auto" prefers native when the host can build it.
    """
    x, y, Z = _grid.gen_grid(field, box, delta)
    # the reference differentiates with the NOMINAL pitch regardless of the
    # per-axis linspace spacing (np.gradient(Z, DELTA), RT_bench.py:450)
    return grid_medium_from_samples(Z, x, y, dtype=dtype, backend=backend,
                                    gradient_spacing=delta)


def grid_medium_from_samples(Z, x, y, *, dtype=np.float32,
                             backend: str = "auto",
                             gradient_spacing: float | None = None
                             ) -> GridMedium:
    """Build a 2-D grid medium from USER-measured index samples.

    ``Z`` is (ny, nx) refractive-index values on the uniform grid spanned
    by the coordinate vectors ``x`` (nx,) and ``y`` (ny,).  The result
    evaluates exactly like the reference pipeline applied to those samples
    — np.gradient (edge_order=2) for the gradient grids, bicubic
    not-a-knot splines of each component, bilinear n (RT_bench.py:435-464)
    — and runs on the scan tier through fast_trace.  The
    reference can only sample the fields hard-coded in its source
    (RT_bench.py:104-116); this is the entry point for real measured media
    (e.g. sound-speed profiles), no source edits required.
    """
    Z, x, y, hx, hy = check_uniform_grid(Z, x, y)
    # ``gradient_spacing``: the step fed to np.gradient.  The reference
    # always uses the nominal DELTA even though its linspace pitches differ
    # per axis by ~3e-4 (RT_bench.py:426-433, 450); user grids default to
    # their true mean pitch.
    gs = float(gradient_spacing if gradient_spacing is not None
               else 0.5 * (hx + hy))

    cx, cy = _gradient_tables_f64(Z, x, y, gs, backend)
    return GridMedium(
        Z=jnp.asarray(Z, dtype), cx=jnp.asarray(cx, dtype),
        cy=jnp.asarray(cy, dtype),
        x0=float(x[0]), y0=float(y[0]),
        inv_hx=float(1.0 / hx), inv_hy=float(1.0 / hy),
        nx=len(x), ny=len(y),
    )
