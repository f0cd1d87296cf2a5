"""df32 tracing on the SAMPLED media: double-word spline evaluation.

The analytic df32 tier (kernels/df.py) carries positions and tangent in
two-float (hi+lo) arithmetic and evaluates the field from closed forms;
the reference's production medium, however, is the FITPACK spline pair
fitted to a sampled grid (RT_bench.py:435-464).  This module extends the
df32 accuracy story to that exact pipeline: the per-cell polynomial tables
are built in float64 (media/spline._gradient_tables_f64) and SPLIT into
hi/lo float32 words, and every table evaluation — bilinear n, bicubic
tensor Horner for each gradient component — runs in double-word f32, so
the medium the df RK4 integrates is the f64 spline to ~1e-14 relative.

The integration step is literally the analytic kernel's
(kernels.df.make_df_rk4_body — one definition of the compensation
choreography); only the angle-rate callback differs.  Unlike the analytic
tier this runs at the jnp level (vmapped gathers from HBM) in bounded
segments rather than as a Pallas kernel: per-evaluation it needs 72
hi/lo channel gathers, and its purpose is the accuracy artifact, not
throughput — and scan+gather-over-large-table programs compile in time
that grows with the scan length, so segments stay short.

Accuracy (measured, see tests/test_df_grid.py and docs/PRECISION.md):
df32-vs-f64-scan trajectory agreement ~1e-7 per turn on the exact sampled
fisheye spline; ten-turn closure is then limited by the MEDIUM (the
sampled spline's own departure from the analytic fisheye, ~1.5e-4 in n —
RT_bench.py:455's bilinear fit), not by arithmetic.
"""
from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from raytracing_tpu.utils import struct

from raytracing_tpu import config
from raytracing_tpu.kernels.df import (_df_recip, _fast_two_sum, _two_prod,
                                       _two_sum, make_df_rk4_body)
from raytracing_tpu.media import grid as _grid
from raytracing_tpu.media.spline import (_gradient_tables_f64,
                                          check_uniform_grid)


# -- double-word helpers beyond kernels/df.py's ------------------------------
def _df_add(ah, al, bh, bl):
    """(a + b) for two df numbers."""
    sh, se = _two_sum(ah, bh)
    return _fast_two_sum(sh, se + al + bl)


def _df_mul(ah, al, bh, bl):
    """(a * b) for two df numbers (low-order cross term dropped)."""
    ph, pe = _two_prod(ah, bh)
    return _fast_two_sum(ph, pe + ah * bl + al * bh)


def _split64(a: np.ndarray):
    """float64 array -> (hi, lo) float32 words with hi + lo == a to f64."""
    a = np.asarray(a, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _split_scalar(v: float):
    hi = np.float32(v)
    return float(hi), float(np.float32(v - float(hi)))


@struct.dataclass
class DfGridMedium:
    """2-D sampled medium with hi/lo split tables (df32 evaluation)."""

    Zh: Any          # (ny*nx,) bilinear n samples, hi words
    Zl: Any          # lo words
    cxh: Any         # (ncells, 16) bicubic dn/dx cells, hi
    cxl: Any
    cyh: Any         # (ncells, 16) bicubic dn/dy cells, hi
    cyl: Any
    x0h: float = struct.field(pytree_node=False)
    x0l: float = struct.field(pytree_node=False)
    y0h: float = struct.field(pytree_node=False)
    y0l: float = struct.field(pytree_node=False)
    ihxh: float = struct.field(pytree_node=False)   # 1/hx hi/lo
    ihxl: float = struct.field(pytree_node=False)
    ihyh: float = struct.field(pytree_node=False)
    ihyl: float = struct.field(pytree_node=False)
    nx: int = struct.field(pytree_node=False)
    ny: int = struct.field(pytree_node=False)


def df_grid_medium_from_samples(Z, x, y, *,
                                gradient_spacing: float | None = None
                                ) -> DfGridMedium:
    """Parity-pipeline hi/lo split tables from USER-measured samples.

    The df32 twin of media/spline.grid_medium_from_samples: same host
    pipeline (np.gradient -> not-a-knot bicubic fit, RT_bench.py:435-464)
    kept in float64 and split into double words instead of cast to f32.
    ``gradient_spacing`` defaults to the true mean pitch, matching the
    single-f32 builder.
    """
    Z, x, y, hx, hy = check_uniform_grid(Z, x, y)
    gs = float(gradient_spacing if gradient_spacing is not None
               else 0.5 * (hx + hy))
    cx, cy = _gradient_tables_f64(Z, x, y, gs)
    Zh, Zl = _split64(Z.reshape(-1))
    cxh, cxl = _split64(cx)
    cyh, cyl = _split64(cy)
    x0h, x0l = _split_scalar(float(x[0]))
    y0h, y0l = _split_scalar(float(y[0]))
    ihxh, ihxl = _split_scalar(1.0 / hx)
    ihyh, ihyl = _split_scalar(1.0 / hy)
    return DfGridMedium(
        Zh=jnp.asarray(Zh), Zl=jnp.asarray(Zl),
        cxh=jnp.asarray(cxh), cxl=jnp.asarray(cxl),
        cyh=jnp.asarray(cyh), cyl=jnp.asarray(cyl),
        x0h=x0h, x0l=x0l, y0h=y0h, y0l=y0l,
        ihxh=ihxh, ihxl=ihxl, ihyh=ihyh, ihyl=ihyl,
        nx=len(x), ny=len(y))


def build_df_grid_medium(field: str, box,
                         delta: float = config.DELTA) -> DfGridMedium:
    """Sample ``field`` and build hi/lo split tables (f64 host pipeline).

    Mirrors media/spline.build_grid_medium exactly — same grid, same
    np.gradient spacing (the reference's nominal DELTA, RT_bench.py:450),
    same not-a-knot fit.
    """
    x, y, Z = _grid.gen_grid(field, box, delta)
    return df_grid_medium_from_samples(Z, x, y, gradient_spacing=delta)


def _df_cell_coord(ph, pl, o_h, o_l, ih_h, ih_l, n):
    """df grid coordinate f = (p - origin) / h, clamped like FITPACK.

    Returns (cell index i as f32, df in-cell offset (uh, ul)).  The
    scalar constants MUST become f32 values here: a Dekker split of two
    python floats runs in f64 and produces a zero error word, silently
    degrading ``_two_prod`` to single precision (measured: 4e-6 in the
    cell coordinate instead of 1e-12).
    """
    ih_h = jnp.float32(ih_h)
    ih_l = jnp.float32(ih_l)
    th, tl = _df_add(ph, pl, jnp.float32(-o_h), jnp.float32(-o_l))
    fh, fl = _df_mul(th, tl, ih_h, ih_l)
    lim = float(n - 1)
    out = (fh < 0.0) | (fh > lim)
    fh = jnp.clip(fh, 0.0, lim)
    fl = jnp.where(out, 0.0, fl)
    i = jnp.minimum(jnp.floor(fh), float(n - 2))
    # fh - i is exact (Sterbenz: fh in [i, i+1]); the lo word rides along
    return i, fh - i, fl


def _df_horner4(c_h, c_l, uh, ul):
    """Cubic df Horner: sum c[k] u^k, coefficients (..., 4) hi/lo."""
    rh, rl = c_h[..., 3], c_l[..., 3]
    for k in (2, 1, 0):
        rh, rl = _df_mul(rh, rl, uh, ul)
        rh, rl = _df_add(rh, rl, c_h[..., k], c_l[..., k])
    return rh, rl


def _df_tensor_horner(C_h, C_l, uh, ul, vh, vl):
    """Bicubic df Horner: sum C[a, b] v^a u^b, C (..., 16) row-major."""
    rows_h, rows_l = [], []
    for a in range(4):
        h, l = _df_horner4(C_h[..., 4 * a:4 * a + 4],
                           C_l[..., 4 * a:4 * a + 4], uh, ul)
        rows_h.append(h)
        rows_l.append(l)
    rh, rl = rows_h[3], rows_l[3]
    for a in (2, 1, 0):
        rh, rl = _df_mul(rh, rl, vh, vl)
        rh, rl = _df_add(rh, rl, rows_h[a], rows_l[a])
    return rh, rl


def _make_df_nag(med: DfGridMedium):
    """df (n, gx, gy) evaluator: bilinear Z + bicubic cx/cy tables."""

    def nag(pxh, pxl, pyh, pyl):
        ix, uxh, uxl = _df_cell_coord(pxh, pxl, med.x0h, med.x0l,
                                      med.ihxh, med.ihxl, med.nx)
        iy, uyh, uyl = _df_cell_coord(pyh, pyl, med.y0h, med.y0l,
                                      med.ihyh, med.ihyl, med.ny)
        ixi = ix.astype(jnp.int32)
        iyi = iy.astype(jnp.int32)
        flat = iyi * med.nx + ixi

        def zc(off):
            return med.Zh[flat + off], med.Zl[flat + off]

        z00h, z00l = zc(0)
        z01h, z01l = zc(1)
        z10h, z10l = zc(med.nx)
        z11h, z11l = zc(med.nx + 1)
        # bilinear in df: n = (1-v)*((1-u)z00 + u z01) + v*((1-u)z10 + u z11)
        cu_h, cu_l = _df_add(1.0, 0.0, -uxh, -uxl)
        cv_h, cv_l = _df_add(1.0, 0.0, -uyh, -uyl)

        def lerp(ah, al, bh, bl):
            th, tl = _df_mul(cu_h, cu_l, ah, al)
            sh, sl = _df_mul(uxh, uxl, bh, bl)
            return _df_add(th, tl, sh, sl)

        lo_h, lo_l = lerp(z00h, z00l, z01h, z01l)
        hi_h, hi_l = lerp(z10h, z10l, z11h, z11l)
        t1h, t1l = _df_mul(cv_h, cv_l, lo_h, lo_l)
        t2h, t2l = _df_mul(uyh, uyl, hi_h, hi_l)
        nh, nl = _df_add(t1h, t1l, t2h, t2l)

        cflat = iyi * (med.nx - 1) + ixi
        gxh, gxl = _df_tensor_horner(med.cxh[cflat], med.cxl[cflat],
                                     uxh, uxl, uyh, uyl)
        gyh, gyl = _df_tensor_horner(med.cyh[cflat], med.cyl[cflat],
                                     uxh, uxl, uyh, uyl)
        return (nh, nl), (gxh, gxl), (gyh, gyl)

    return nag


@struct.dataclass
class DfC1Medium:
    """2-D C1 (consistent-gradient) medium with hi/lo split tables.

    Power-basis per-cell tables of ONE spline (media/c1.py) plus its exact
    derivative tables, all split f64 -> hi+lo f32 on host: n from C,
    gx from Cu = d/du C / hx, gy from Cv = d/dv C / hy — consistency holds
    to table precision (~1e-14 relative).  The C1 counterpart of
    :class:`DfGridMedium`, and the combination that finally lets df32
    arithmetic SHOW on sampled media: the C1 interpolant tracks the true
    field to O(h^4) (~1e-6 on the reference fisheye grid) where the parity
    medium's bilinear n floors at ~1.5e-4.
    """

    Ch: Any          # (ncells, 16) n-spline cells, hi words
    Cl: Any
    Cuh: Any         # d/du tables (pre-scaled by 1/hx)
    Cul: Any
    Cvh: Any         # d/dv tables (pre-scaled by 1/hy)
    Cvl: Any
    x0h: float = struct.field(pytree_node=False)
    x0l: float = struct.field(pytree_node=False)
    y0h: float = struct.field(pytree_node=False)
    y0l: float = struct.field(pytree_node=False)
    ihxh: float = struct.field(pytree_node=False)
    ihxl: float = struct.field(pytree_node=False)
    ihyh: float = struct.field(pytree_node=False)
    ihyl: float = struct.field(pytree_node=False)
    nx: int = struct.field(pytree_node=False)
    ny: int = struct.field(pytree_node=False)


def df_c1_medium_from_samples(Z, x, y) -> DfC1Medium:
    """Consistent-gradient hi/lo split tables from USER-measured samples.

    The df32 twin of media/c1.c1_medium_from_samples — the combination
    PRECISION.md names the f64-substitute for measured media: one
    not-a-knot spline of the lab's own Z samples, its exact derivative
    tables pre-scaled in float64, everything split hi/lo.
    """
    from raytracing_tpu.media.c1 import _n_spline_cells

    Z, x, y, hx, hy = check_uniform_grid(Z, x, y)
    cells = np.asarray(_n_spline_cells(Z, y, x), np.float64)  # (ncy,ncx,4,4)
    b = np.arange(4, dtype=np.float64)
    cu = np.zeros_like(cells)
    cu[..., :, :3] = cells[..., :, 1:] * b[1:] / hx     # d/du, u-power shift
    cv = np.zeros_like(cells)
    cv[..., :3, :] = cells[..., 1:, :] * b[1:, None] / hy
    Ch, Cl = _split64(cells.reshape(-1, 16))
    Cuh, Cul = _split64(cu.reshape(-1, 16))
    Cvh, Cvl = _split64(cv.reshape(-1, 16))
    x0h, x0l = _split_scalar(float(x[0]))
    y0h, y0l = _split_scalar(float(y[0]))
    ihxh, ihxl = _split_scalar(1.0 / hx)
    ihyh, ihyl = _split_scalar(1.0 / hy)
    return DfC1Medium(
        Ch=jnp.asarray(Ch), Cl=jnp.asarray(Cl),
        Cuh=jnp.asarray(Cuh), Cul=jnp.asarray(Cul),
        Cvh=jnp.asarray(Cvh), Cvl=jnp.asarray(Cvl),
        x0h=x0h, x0l=x0l, y0h=y0h, y0l=y0l,
        ihxh=ihxh, ihxl=ihxl, ihyh=ihyh, ihyl=ihyl,
        nx=len(x), ny=len(y))


def build_df_c1_medium(field: str, box,
                       delta: float = config.DELTA) -> DfC1Medium:
    """Sample ``field``, fit the C1 spline, split everything hi/lo."""
    x, y, Z = _grid.gen_grid(field, box, delta)
    return df_c1_medium_from_samples(Z, x, y)


def _make_df_c1_nag(med: DfC1Medium):
    """df (n, gx, gy) evaluator — three tensor Horners of ONE spline."""

    def nag(pxh, pxl, pyh, pyl):
        ix, uxh, uxl = _df_cell_coord(pxh, pxl, med.x0h, med.x0l,
                                      med.ihxh, med.ihxl, med.nx)
        iy, uyh, uyl = _df_cell_coord(pyh, pyl, med.y0h, med.y0l,
                                      med.ihyh, med.ihyl, med.ny)
        cflat = iy.astype(jnp.int32) * (med.nx - 1) + ix.astype(jnp.int32)
        nh, nl = _df_tensor_horner(med.Ch[cflat], med.Cl[cflat],
                                   uxh, uxl, uyh, uyl)
        gxh, gxl = _df_tensor_horner(med.Cuh[cflat], med.Cul[cflat],
                                     uxh, uxl, uyh, uyl)
        gyh, gyl = _df_tensor_horner(med.Cvh[cflat], med.Cvl[cflat],
                                     uxh, uxl, uyh, uyl)
        return (nh, nl), (gxh, gxl), (gyh, gyl)

    return nag


@struct.dataclass
class DfC1Profile:
    """1-D consistent-gradient PROFILE with hi/lo split cells.

    The df32 twin of media/c1.C1StratifiedMedium for x-independent
    measured data (e.g. sound speed vs depth): per-cell power
    coefficients of one not-a-knot cubic of the samples, plus its exact
    derivative cells pre-scaled by 1/hy in float64, all split hi/lo.
    Long-range propagation through a waveguide is exactly where single
    f32 drifts (10^5+ steps); this keeps trajectories at the f64 grade
    of the interpolant.
    """

    Ch: Any          # (ny-1, 4) n-spline cells, hi words
    Cl: Any
    Cvh: Any         # d/dy cells (pre-scaled by 1/hy)
    Cvl: Any
    y0h: float = struct.field(pytree_node=False)
    y0l: float = struct.field(pytree_node=False)
    ihyh: float = struct.field(pytree_node=False)
    ihyl: float = struct.field(pytree_node=False)
    ny: int = struct.field(pytree_node=False)


def df_c1_profile_from_samples(samples, y) -> DfC1Profile:
    """Split-word C1 profile tables from USER-measured (samples, y)."""
    from raytracing_tpu.media.spline import _check_profile, cubic_cells_1d

    samples, y, hy = _check_profile(samples, y)
    cn = np.asarray(cubic_cells_1d(samples), np.float64)      # (ny-1, 4)
    b = np.arange(4, dtype=np.float64)
    cv = np.zeros_like(cn)
    cv[:, :3] = cn[:, 1:] * b[1:] / hy
    Ch, Cl = _split64(cn)
    Cvh, Cvl = _split64(cv)
    y0h, y0l = _split_scalar(float(y[0]))
    ihyh, ihyl = _split_scalar(1.0 / hy)
    return DfC1Profile(Ch=jnp.asarray(Ch), Cl=jnp.asarray(Cl),
                       Cvh=jnp.asarray(Cvh), Cvl=jnp.asarray(Cvl),
                       y0h=y0h, y0l=y0l, ihyh=ihyh, ihyl=ihyl, ny=len(y))


def _make_df_profile_nag(med: DfC1Profile):
    """df (n, gx, gy): two cubic df Horners of ONE 1-D spline; gx = 0."""

    def nag(pxh, pxl, pyh, pyl):
        iy, uyh, uyl = _df_cell_coord(pyh, pyl, med.y0h, med.y0l,
                                      med.ihyh, med.ihyl, med.ny)
        cell = iy.astype(jnp.int32)
        nh, nl = _df_horner4(med.Ch[cell], med.Cl[cell], uyh, uyl)
        gyh, gyl = _df_horner4(med.Cvh[cell], med.Cvl[cell], uyh, uyl)
        zero = jnp.zeros_like(nh)
        return (nh, nl), (zero, zero), (gyh, gyl)

    return nag


def _make_df_k(med):
    """df angle rate k = (u x grad n)/n from the split tables."""
    nag = (_make_df_c1_nag(med) if isinstance(med, DfC1Medium)
           else _make_df_profile_nag(med) if isinstance(med, DfC1Profile)
           else _make_df_nag(med))

    def df_k(pxh, pxl, pyh, pyl, vxh, vxl, vyh, vyl):
        (nh, nl), (gxh, gxl), (gyh, gyl) = nag(pxh, pxl, pyh, pyl)
        ah, al = _df_mul(vxh, vxl, gyh, gyl)
        bh, bl = _df_mul(vyh, vyl, gxh, gxl)
        ch, cl = _df_add(ah, al, -bh, -bl)
        rh, rl = _df_recip(nh, nl)
        return _df_mul(ch, cl, rh, rl)

    return df_k


@functools.partial(jax.jit, static_argnames=("steps",))
def _df_grid_segment(med, st, ds, *, steps: int):
    body = make_df_rk4_body(_make_df_k(med), ds)
    return jax.lax.fori_loop(0, steps, body, st)


def df_grid_trace(pos0, theta0, delta_s, medium, *,
                  steps: int, segment: int = 512) -> np.ndarray:
    """Double-word RK4 through the sampled 2-D spline; f64 final positions.

    The sampled-media counterpart of kernels.df.df_trace: same RK4 body,
    angle rate from the df table evaluator.  ``medium`` is a
    :class:`DfGridMedium` (parity tables), :class:`DfC1Profile`
    (1-D measured profiles) or :class:`DfC1Medium`
    (consistent-gradient — the combination where df32 arithmetic shows,
    the medium no longer flooring at the bilinear-n ~1.5e-4).  Chained
    ``segment``-step jits bound the compile (scan+gather one-shots are a
    compile hazard).  No boundary mask or traveltime — accuracy tier (the
    fisheye workloads it certifies never exit the box).
    """
    theta64 = np.asarray(theta0, np.float64)
    cxh, cxl = _split64(np.cos(theta64))
    cyh, cyl = _split64(np.sin(theta64))
    pos0 = np.asarray(pos0, np.float64)
    xh, xl = _split64(pos0[:, 0])
    yh, yl = _split64(pos0[:, 1])
    st = tuple(jnp.asarray(a) for a in
               (xh, xl, yh, yl, cxh, cxl, cyh, cyl))
    ds = jnp.float32(delta_s)
    done = 0
    while done < steps:
        n = min(segment, steps - done)
        st = _df_grid_segment(medium, st, ds, steps=int(n))
        done += n

    def comb(h, l):
        return np.asarray(h, np.float64) + np.asarray(l, np.float64)

    return np.stack([comb(st[0], st[1]), comb(st[2], st[3])], axis=-1)


# -- df32-evaluated media behind the plain n_and_grad surface ----------------
@struct.dataclass
class DfEvalProfile:
    """An ordinary f32 ``n_and_grad`` medium, evaluated via df32 tables.

    The dynamic/eigenray scan keeps single-f32 positions (the compensated
    carries hold their ACCUMULATION at the increment level,
    engine/dynamic.hand_step), so the remaining backend-dependent error is
    the per-evaluation table arithmetic: f32 cell coefficients plus
    whatever fma/ordering the compiler picks, which differs between
    backends.  This facade evaluates the f64-grade split-word profile
    (``DfC1Profile`` tables) at f32 query points and rounds ONCE to f32 —
    the returned (n, gy) are the correctly-rounded values of the f64
    interpolant, identical on every backend, killing both the coefficient
    quantization and the fma variance.  Positions enter with a zero lo
    word: the facade does not (cannot) recover sub-f32 position detail —
    that is the landing-curve floor proper, ~ulp(|pos|) per eval,
    non-accumulating under the compensated carries.

    Drop-in for the scan/dynamic/eigenray tiers (``n_and_grad``,
    ``n``); NOT a kernel-tier medium (no Hermite node table).
    """

    prof: DfC1Profile

    @property
    def dtype(self):
        return np.float32

    def n_and_grad(self, x, y):
        nag = _make_df_profile_nag(self.prof)
        zero = jnp.zeros_like(jnp.asarray(y, jnp.float32))
        (nh, nl), (gxh, _), (gyh, gyl) = nag(
            jnp.asarray(x, jnp.float32), zero,
            jnp.asarray(y, jnp.float32), zero)
        # hi + lo collapses to the correctly-rounded f32 of the f64 value
        # (the pair is normalized; adding lo folds the half-ulp cases in)
        return nh + nl, (gxh, gyh + gyl)

    def n(self, x, y):
        return self.n_and_grad(x, y)[0]


def df_eval_profile_medium(samples, y) -> DfEvalProfile:
    """f32 scan-tier medium whose evaluations are f64-grade (df32 tables).

    Built straight from USER-measured (samples, y) like
    ``c1_stratified_from_samples`` — same not-a-knot cubic, same
    validation — but the cells stay split-word so every ``n_and_grad``
    call returns the correctly-rounded f32 of the float64 interpolant on
    any backend.  The accuracy-grade medium for float32 eigenray/TL work
    on the device (RT_TL_DEVICE paths); docs/PRECISION.md.
    """
    return DfEvalProfile(prof=df_c1_profile_from_samples(samples, y))
