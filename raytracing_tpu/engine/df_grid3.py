"""df32 evaluation of sampled 3-D (tri-Hermite grid3) media.

The split-word accuracy story (engine/df_grid.py: f64 tables split into
hi/lo f32 words, every table evaluation run in double-word arithmetic)
extended to the 3-D 8-channel Hermite node layout of media/grid3.py —
so accuracy-grade MEASURED 3-D work
(the f64-substitute that closed the 2-D eigenray amplitude floor) gets a
path on f32 hardware.  Reference analog: the all-f64 stance of
RT_bench.py (SURVEY §7 hard part #4), which its strictly-2-D splines
(RT_bench.py:435-464) never had to face in three dimensions.

Two surfaces:

* :class:`DfC1Medium3` + :func:`df_c1_medium3_from_samples` — the raw
  hi/lo node tables and a df (n, grad n) evaluator whose value is the
  float64 tensor-product tricubic to ~1e-13 relative (the node pipeline
  is literally media/grid3.nodes3_f64, so the interpolant cannot drift
  from the f32 medium's).
* :class:`DfEvalMedium3` / :func:`df_eval_medium3_from_samples` — an
  ordinary f32 ``n_and_grad3`` medium whose every evaluation is the
  correctly-rounded f32 of the f64 interpolant on ANY backend (the 3-D
  twin of ``rt.df_eval_profile_medium``, docs/PRECISION.md round-4
  addendum): drop-in for ``trace3d`` / ``trace_dynamic3`` /
  ``find_eigenrays3`` on the device, killing both coefficient quantization and
  backend fma variance.  Positions enter with a zero lo word — the
  facade cannot recover sub-f32 position detail; that residual is the
  non-accumulating per-eval landing floor, exactly as in 2-D.

Evaluation is a sequential tensor contraction in df arithmetic: collapse
the z axis (8 corners x 8 channels -> 4 columns x 4 channels), then y,
then x, with the Hermite basis polynomials themselves evaluated in df —
so the result is the f64 polynomial's value, not an f32 re-association
of it.  Scan-tier only (vmapped HBM gathers, 128 hi/lo channel reads per
point): its purpose is the accuracy artifact, not throughput.

The facade's ``n_and_grad3`` carries a ``custom_jvp``: the dynamic /
eigenray tiers push tangents through every medium eval, and AD through
the df contraction is both catastrophically slow to compile (tens of
minutes on XLA:CPU).  The rule returns the closed-form tangent of
the same tricubic — dn = g . dp (df-grade g, free) and dg = H dp with a
compact plain-f32 Hessian contraction (:func:`_hess3`).
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from raytracing_tpu.utils import struct

from raytracing_tpu.engine.df_grid import (_df_add, _df_mul, _split64,
                                           _split_scalar, _df_cell_coord)
from raytracing_tpu.kernels.df import _fast_two_sum, _two_prod


def _df_scale(ah, al, c: float):
    """(a * c) for a df number and an exact f32 scalar c."""
    ph, pe = _two_prod(ah, jnp.float32(c))
    return _fast_two_sum(ph, pe + al * jnp.float32(c))


def _df_scale_df(ah, al, ch, cl):
    """(a * c) for a df number and a df SCALAR (hi, lo python floats)."""
    ph, pe = _two_prod(ah, jnp.float32(ch))
    return _fast_two_sum(ph, pe + al * jnp.float32(ch) + ah * jnp.float32(cl))


def _df_hermite_bases(th, tl):
    """Value and derivative Hermite bases of a df coordinate t.

    Returns ``(B, D)`` where ``B[k][d]`` is the df basis weight for
    channel-bit ``k`` (0 = value, 1 = tangent) at corner ``d`` (0/1):
    B[0][0] = h00, B[1][0] = h10, B[0][1] = h01, B[1][1] = h11 of
    media/hermite.hermite_basis, and D the same for hermite_dbasis — all
    evaluated in double-word arithmetic so the basis polynomials carry
    f64-grade values into the contraction.
    """
    t2 = _df_mul(th, tl, th, tl)
    t3 = _df_mul(*t2, th, tl)
    one = (jnp.ones_like(th), jnp.zeros_like(th))
    t = (th, tl)

    def lin(*terms):
        """sum of (coeff, df) terms, df-accumulated."""
        (c0, a0), rest = terms[0], terms[1:]
        acc = _df_scale(*a0, c0)
        for c, a in rest:
            acc = _df_add(*acc, *_df_scale(*a, c))
        return acc

    h00 = lin((2.0, t3), (-3.0, t2), (1.0, one))
    h10 = lin((1.0, t3), (-2.0, t2), (1.0, t))
    h01 = lin((-2.0, t3), (3.0, t2))
    h11 = lin((1.0, t3), (-1.0, t2))
    g00 = lin((6.0, t2), (-6.0, t))
    g10 = lin((3.0, t2), (-4.0, t), (1.0, one))
    g01 = lin((-6.0, t2), (6.0, t))
    g11 = lin((3.0, t2), (-2.0, t))
    return ((h00, h01), (h10, h11)), ((g00, g01), (g10, g11))


@struct.dataclass
class DfC1Medium3:
    """3-D tri-Hermite medium with hi/lo split node tables.

    ``Nh``/``Nl`` are the (nz*ny*nx, 8) Hermite node table of ONE
    tensor-product not-a-knot tricubic spline (media/grid3.nodes3_f64)
    split f64 -> hi+lo f32.  Evaluation reconstructs the f64 interpolant
    (and its exact analytic gradient) to ~1e-13 relative in pure f32
    double-word arithmetic.
    """

    Nh: Any          # (nz*ny*nx, 8) hi words
    Nl: Any          # lo words
    x0h: float = struct.field(pytree_node=False)
    x0l: float = struct.field(pytree_node=False)
    y0h: float = struct.field(pytree_node=False)
    y0l: float = struct.field(pytree_node=False)
    z0h: float = struct.field(pytree_node=False)
    z0l: float = struct.field(pytree_node=False)
    ihxh: float = struct.field(pytree_node=False)
    ihxl: float = struct.field(pytree_node=False)
    ihyh: float = struct.field(pytree_node=False)
    ihyl: float = struct.field(pytree_node=False)
    ihzh: float = struct.field(pytree_node=False)
    ihzl: float = struct.field(pytree_node=False)
    nx: int = struct.field(pytree_node=False)
    ny: int = struct.field(pytree_node=False)
    nz: int = struct.field(pytree_node=False)


def df_c1_medium3_from_samples(F, x, y, z) -> DfC1Medium3:
    """Split-word tri-Hermite tables from USER-measured 3-D samples.

    The df32 twin of :func:`media.grid3.c1_medium3_from_samples`: the
    SAME f64 node pipeline (``nodes3_f64`` — tensor-product not-a-knot
    tangent solves), split hi/lo instead of cast to f32.
    """
    from raytracing_tpu.media.grid3 import check_uniform_grid3, nodes3_f64

    F, x, y, z, hx, hy, hz = check_uniform_grid3(F, x, y, z)
    nodes = nodes3_f64(F).reshape(-1, 8)
    Nh, Nl = _split64(nodes)
    x0h, x0l = _split_scalar(float(x[0]))
    y0h, y0l = _split_scalar(float(y[0]))
    z0h, z0l = _split_scalar(float(z[0]))
    ihxh, ihxl = _split_scalar(1.0 / hx)
    ihyh, ihyl = _split_scalar(1.0 / hy)
    ihzh, ihzl = _split_scalar(1.0 / hz)
    return DfC1Medium3(
        Nh=jnp.asarray(Nh), Nl=jnp.asarray(Nl),
        x0h=x0h, x0l=x0l, y0h=y0h, y0l=y0l, z0h=z0h, z0l=z0l,
        ihxh=ihxh, ihxl=ihxl, ihyh=ihyh, ihyl=ihyl, ihzh=ihzh, ihzl=ihzl,
        nx=len(x), ny=len(y), nz=len(z))


def _make_df_nag3(med: DfC1Medium3):
    """df (n, gx, gy, gz) evaluator of the split tri-Hermite tables.

    Sequential z -> y -> x contraction; each axis' collapse uses the df
    value basis except the differentiated axis, which uses the df
    derivative basis and scales by that axis' df 1/h.
    """

    def nag(pxh, pxl, pyh, pyl, pzh, pzl):
        ix, uxh, uxl = _df_cell_coord(pxh, pxl, med.x0h, med.x0l,
                                      med.ihxh, med.ihxl, med.nx)
        iy, uyh, uyl = _df_cell_coord(pyh, pyl, med.y0h, med.y0l,
                                      med.ihyh, med.ihyl, med.ny)
        iz, uzh, uzl = _df_cell_coord(pzh, pzl, med.z0h, med.z0l,
                                      med.ihzh, med.ihzl, med.nz)
        ixi, iyi, izi = (v.astype(jnp.int32) for v in (ix, iy, iz))
        flat = (izi * med.ny + iyi) * med.nx + ixi
        sy, sz = med.nx, med.nx * med.ny

        # corner index = dx + 2*dy + 4*dz; channel index = kx + 2*ky + 4*kz
        nodes = [(med.Nh[flat + dz * sz + dy * sy + dx],
                  med.Nl[flat + dz * sz + dy * sy + dx])
                 for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]

        Bx, Dx = _df_hermite_bases(uxh, uxl)
        By, Dy = _df_hermite_bases(uyh, uyl)
        Bz, Dz = _df_hermite_bases(uzh, uzl)

        def collapse_z(basis):
            """(4 xy-corners) x (4 xy-channels) df values after z-blend."""
            out = {}
            for dy in (0, 1):
                for dx in (0, 1):
                    for ky in (0, 1):
                        for kx in (0, 1):
                            acc = None
                            for dz in (0, 1):
                                nd = nodes[dx + 2 * dy + 4 * dz]
                                for kz in (0, 1):
                                    ch = kx + 2 * ky + 4 * kz
                                    w = basis[kz][dz]
                                    t = _df_mul(nd[0][..., ch],
                                                nd[1][..., ch], *w)
                                    acc = t if acc is None \
                                        else _df_add(*acc, *t)
                            out[(dx, dy, kx, ky)] = acc
            return out

        def collapse_y(zc, basis):
            out = {}
            for dx in (0, 1):
                for kx in (0, 1):
                    acc = None
                    for dy in (0, 1):
                        for ky in (0, 1):
                            t = _df_mul(*zc[(dx, dy, kx, ky)],
                                        *basis[ky][dy])
                            acc = t if acc is None else _df_add(*acc, *t)
                    out[(dx, kx)] = acc
            return out

        def collapse_x(yc, basis):
            acc = None
            for dx in (0, 1):
                for kx in (0, 1):
                    t = _df_mul(*yc[(dx, kx)], *basis[kx][dx])
                    acc = t if acc is None else _df_add(*acc, *t)
            return acc

        zc_v = collapse_z(Bz)
        yc_vv = collapse_y(zc_v, By)
        n = collapse_x(yc_vv, Bx)
        gx = _df_scale_df(*collapse_x(yc_vv, Dx), med.ihxh, med.ihxl)
        gy = _df_scale_df(*collapse_x(collapse_y(zc_v, Dy), Bx),
                          med.ihyh, med.ihyl)
        gz = _df_scale_df(*collapse_x(collapse_y(collapse_z(Dz), By), Bx),
                          med.ihzh, med.ihzl)
        return n, gx, gy, gz

    return nag


def _regroup(basis):
    """(h00, h10, h01, h11) -> b[k][d]: channel bit k, corner d."""
    h00, h10, h01, h11 = basis
    return ((h00, h01), (h10, h11))


def _b_val(t):
    """media/c1's canonical Hermite bases regrouped — ONE polynomial
    definition (c1.hermite_basis/_dbasis/_d2basis) shared with every
    primal tier, so a truncation fix there cannot leave these tangents
    evaluating a different polynomial."""
    from raytracing_tpu.media.hermite import hermite_basis
    return _regroup(hermite_basis(t))


def _b_d1(t):
    from raytracing_tpu.media.c1 import hermite_dbasis
    return _regroup(hermite_dbasis(t))


def _b_d2(t):
    from raytracing_tpu.media.c1 import hermite_d2basis
    return _regroup(hermite_d2basis(t))


def _hess3(med: DfC1Medium3, x, y, z):
    """Plain-f32 Hessian of the tri-Hermite interpolant (6 components).

    Tangent-grade only: the dynamic tier's paraxial tangents are first
    derivatives of the ray map, so f32 rounding here perturbs dq at
    O(eps) RELATIVE — unlike the primal n/grad, which integrate and need
    the df words.  Uses the hi node words (the correctly-rounded f32 of
    the f64 table) and the SAME cell selection as the df contraction
    (``_df_cell_coord``), so primal and tangent never straddle a cell
    boundary differently.
    """
    zero = jnp.zeros_like(x)
    ix, uxh, _ = _df_cell_coord(x, zero, med.x0h, med.x0l,
                                med.ihxh, med.ihxl, med.nx)
    iy, uyh, _ = _df_cell_coord(y, zero, med.y0h, med.y0l,
                                med.ihyh, med.ihyl, med.ny)
    iz, uzh, _ = _df_cell_coord(z, zero, med.z0h, med.z0l,
                                med.ihzh, med.ihzl, med.nz)
    ixi, iyi, izi = (v.astype(jnp.int32) for v in (ix, iy, iz))
    flat = (izi * med.ny + iyi) * med.nx + ixi
    sy, sz = med.nx, med.nx * med.ny
    nodes = [med.Nh[flat + dz * sz + dy * sy + dx]
             for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]

    def contract(bx, by, bz):
        acc = None
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    nd = nodes[dx + 2 * dy + 4 * dz]
                    for kz in (0, 1):
                        wzy = bz[kz][dz]
                        for ky in (0, 1):
                            wy = wzy * by[ky][dy]
                            for kx in (0, 1):
                                t = nd[..., kx + 2 * ky + 4 * kz] \
                                    * (wy * bx[kx][dx])
                                acc = t if acc is None else acc + t
        return acc

    bx, dx_, d2x = _b_val(uxh), _b_d1(uxh), _b_d2(uxh)
    by, dy_, d2y = _b_val(uyh), _b_d1(uyh), _b_d2(uyh)
    bz, dz_, d2z = _b_val(uzh), _b_d1(uzh), _b_d2(uzh)
    ihx = jnp.float32(med.ihxh)
    ihy = jnp.float32(med.ihyh)
    ihz = jnp.float32(med.ihzh)
    return (contract(d2x, by, bz) * (ihx * ihx),
            contract(dx_, dy_, bz) * (ihx * ihy),
            contract(dx_, by, dz_) * (ihx * ihz),
            contract(bx, d2y, bz) * (ihy * ihy),
            contract(bx, dy_, dz_) * (ihy * ihz),
            contract(bx, by, d2z) * (ihz * ihz))


@jax.custom_jvp
def _df_nag3_eval(med: DfC1Medium3, x, y, z):
    """(n, gx, gy, gz) via the df contraction, rounded once to f32."""
    nag = _make_df_nag3(med)
    zero = jnp.zeros_like(x)
    (nh, nl), (gxh, gxl), (gyh, gyl), (gzh, gzl) = nag(
        x, zero, y, zero, z, zero)
    return nh + nl, gxh + gxl, gyh + gyl, gzh + gzl


@_df_nag3_eval.defjvp
def _df_nag3_eval_jvp(primals, tangents):
    """Analytic tangent: dn = g . dp, dg = H dp (plain-f32 Hessian).

    WITHOUT this rule, ``jax.jvp`` differentiates THROUGH the df
    contraction — a graph ~20x the primal's that XLA:CPU takes tens of
    minutes to compile per dynamic-trace variant.  The rule replaces it with the closed-form
    derivative of the SAME tricubic polynomial: the gradient the primal
    already computes at df grade plus a compact plain-f32 Hessian
    contraction — exactly the accuracy split the dynamic tier wants
    (primal integrals at f64 grade, tangents at f32 grade).  Table
    tangents are ignored: node words are constants in every use.
    """
    med, x, y, z = primals
    _, dx, dy, dz = tangents
    n, gx, gy, gz = _df_nag3_eval(med, x, y, z)
    hxx, hxy, hxz, hyy, hyz, hzz = _hess3(med, x, y, z)
    dn = gx * dx + gy * dy + gz * dz
    dgx = hxx * dx + hxy * dy + hxz * dz
    dgy = hxy * dx + hyy * dy + hyz * dz
    dgz = hxz * dx + hyz * dy + hzz * dz
    return (n, gx, gy, gz), (dn, dgx, dgy, dgz)


@struct.dataclass
class DfEvalMedium3:
    """An ordinary f32 ``n_and_grad3`` medium, evaluated via df32 tables.

    Every evaluation runs the split-word tri-Hermite contraction and
    rounds ONCE to f32 (hi + lo folds the half-ulp cases in), so the
    returned (n, grad n) are the correctly-rounded values of the float64
    tensor-product interpolant on ANY backend — the 3-D twin of
    :class:`engine.df_grid.DfEvalProfile` and the accuracy-grade medium
    for device ``find_eigenrays3`` / ``trace_dynamic3`` work.  Drop-in
    for the scan/dynamic/eigenray 3-D tiers (``n_and_grad3``, ``n3``);
    NOT a kernel-tier medium (no single-word Hermite node table).
    """

    med: DfC1Medium3

    @property
    def dtype(self):
        return np.float32

    def n_and_grad3(self, x, y, z):
        n, gx, gy, gz = _df_nag3_eval(
            self.med, jnp.asarray(x, jnp.float32),
            jnp.asarray(y, jnp.float32), jnp.asarray(z, jnp.float32))
        return n, (gx, gy, gz)

    def n3(self, x, y, z):
        return self.n_and_grad3(x, y, z)[0]


def df_eval_medium3_from_samples(F, x, y, z) -> DfEvalMedium3:
    """f32 3-D medium whose evaluations are f64-grade (df32 tables).

    Built straight from USER-measured (F, x, y, z) like
    ``c1_medium3_from_samples`` — same validation, same tensor-product
    node pipeline — but the nodes stay split-word so every
    ``n_and_grad3`` call returns the correctly-rounded f32 of the f64
    interpolant on any backend.  The accuracy-grade 3-D medium for float32
    eigenray work; see docs/PRECISION.md.
    """
    return DfEvalMedium3(med=df_c1_medium3_from_samples(F, x, y, z))
