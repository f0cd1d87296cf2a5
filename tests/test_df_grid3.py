"""Split-word (df32) tri-Hermite 3-D tables: engine/df_grid3.py.

The 3-D extension of tests/test_df_grid.py's strategy: every claim is
df32-vs-FLOAT64 (the x64 evaluation of the same tensor-product spline),
never f32-vs-f32.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raytracing_tpu.engine.df_grid3 import (DfEvalMedium3, _make_df_nag3,
                                            df_c1_medium3_from_samples,
                                            df_eval_medium3_from_samples)
from raytracing_tpu.media.grid3 import c1_medium3_from_samples


def _samples(n=17, lim=1.6):
    ax = np.linspace(-lim, lim, n)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    F = 1.0 / (1.0 + X ** 2 + Y ** 2 + Z ** 2)
    # grid3 convention: F indexed [iz, iy, ix]; meshgrid ij gives [ix,iy,iz]
    return np.transpose(F, (2, 1, 0)), ax


def _points(rng, lim=1.45, m=400):
    return (rng.uniform(-lim, lim, m), rng.uniform(-lim, lim, m),
            rng.uniform(-lim, lim, m))


def test_split_fidelity():
    """hi + lo reconstructs the f64 node table to double-word precision
    (~2^-48 relative: the lo word's own rounding is the only loss)."""
    F, ax = _samples()
    dfm = df_c1_medium3_from_samples(F, ax, ax, ax)
    from raytracing_tpu.media.grid3 import check_uniform_grid3, nodes3_f64

    F64, x, y, z, *_ = check_uniform_grid3(F, ax, ax, ax)
    nodes = nodes3_f64(F64).reshape(-1, 8)
    rec = (np.asarray(dfm.Nh, np.float64) + np.asarray(dfm.Nl, np.float64))
    assert np.abs(rec - nodes).max() < 2e-14


def test_df_eval_matches_f64_interpolant():
    """The df contraction reproduces the x64 spline to ~1e-6 ulp-scale.

    n is O(1) so 1e-12 absolute ~ 1e-12 relative; gradients are O(1)
    too on this field.  The floor is the df arithmetic's O(eps_f32^2)
    ~ 1e-14 plus the zero-lo-word query quantization (exact here: the
    SAME f32 query points feed both sides).
    """
    F, ax = _samples()
    dfm = df_c1_medium3_from_samples(F, ax, ax, ax)
    nag = _make_df_nag3(dfm)
    rng = np.random.default_rng(7)
    xs, ys, zs = _points(rng)
    xs32 = xs.astype(np.float32)
    ys32 = ys.astype(np.float32)
    zs32 = zs.astype(np.float32)
    zero = jnp.zeros_like(jnp.asarray(xs32))
    (nh, nl), (gxh, gxl), (gyh, gyl), (gzh, gzl) = nag(
        jnp.asarray(xs32), zero, jnp.asarray(ys32), zero,
        jnp.asarray(zs32), zero)

    with jax.enable_x64(True):
        m64 = c1_medium3_from_samples(F, ax, ax, ax, dtype=np.float64)
        n64, (gx64, gy64, gz64) = m64.n_and_grad3(
            xs32.astype(np.float64), ys32.astype(np.float64),
            zs32.astype(np.float64))

    def comb(h, l):
        return np.asarray(h, np.float64) + np.asarray(l, np.float64)

    assert np.abs(comb(nh, nl) - np.asarray(n64)).max() < 2e-12
    assert np.abs(comb(gxh, gxl) - np.asarray(gx64)).max() < 2e-11
    assert np.abs(comb(gyh, gyl) - np.asarray(gy64)).max() < 2e-11
    assert np.abs(comb(gzh, gzl) - np.asarray(gz64)).max() < 2e-11


def test_df_eval_facade_correctly_rounded():
    """DfEvalMedium3 returns f32 within 1 ulp of the f64 interpolant —
    and beats the plain-f32 medium's evaluation error on the same grid."""
    F, ax = _samples()
    m = df_eval_medium3_from_samples(F, ax, ax, ax)
    assert isinstance(m, DfEvalMedium3)
    rng = np.random.default_rng(11)
    xs, ys, zs = (v.astype(np.float32) for v in _points(rng))
    n32, (gx32, gy32, gz32) = m.n_and_grad3(xs, ys, zs)

    with jax.enable_x64(True):
        m64 = c1_medium3_from_samples(F, ax, ax, ax, dtype=np.float64)
        n64, (gx64, gy64, gz64) = m64.n_and_grad3(
            xs.astype(np.float64), ys.astype(np.float64),
            zs.astype(np.float64))
        m32 = c1_medium3_from_samples(F, ax, ax, ax, dtype=np.float32)
        n32p, (gx32p, _, _) = m32.n_and_grad3(xs, ys, zs)

    # correctly-rounded: within 1 ulp of f64 (n is ~0.1-1.0 here)
    err_df = np.abs(np.asarray(n32, np.float64) - np.asarray(n64)).max()
    assert err_df < 1.2e-7
    gerr = np.abs(np.asarray(gx32, np.float64) - np.asarray(gx64)).max()
    assert gerr < 1.2e-7
    # and strictly better than the single-f32 tables on the same points
    err_f32 = np.abs(np.asarray(n32p, np.float64) - np.asarray(n64)).max()
    assert err_df < err_f32


def test_facade_drops_into_trace3d():
    """trace3d accepts the facade as a Custom3D-grade medium and the
    trajectory tracks the x64 run through the f64 medium."""
    from raytracing_tpu.engine.trace3d import trace3d

    F, ax = _samples(21)
    m = df_eval_medium3_from_samples(F, ax, ax, ax)
    r = 8
    th = np.pi / 2 + np.linspace(-0.02, 0.02, r)
    dir0 = np.stack([np.cos(th), np.sin(th), np.full(r, 1e-2)], -1)
    pos0 = np.tile([[1.0, 0.0, 0.0]], (r, 1))
    box = (-1.5, 1.5, -1.5, 1.5, -1.5, 1.5)
    res = trace3d("op6", m, pos0=pos0.astype(np.float32),
                  dir0=dir0.astype(np.float32),
                  delta_s=2 * np.pi / 600, steps=250, box=box,
                  dtype=np.float32)
    with jax.enable_x64(True):
        m64 = c1_medium3_from_samples(F, ax, ax, ax, dtype=np.float64)
        res64 = trace3d("op6", m64, pos0=pos0, dir0=dir0,
                        delta_s=2 * np.pi / 600, steps=250, box=box,
                        dtype=np.float64)
    d = np.abs(np.asarray(res.final.pos, np.float64)
               - np.asarray(res64.final.pos)).max()
    # f32 POSITION accumulation is now the only error source; the medium
    # itself is f64-grade (vs ~1e-4 coefficient floors on plain f32)
    assert d < 5e-6


def test_eigenray3_f32_solve_plain_medium():
    """find_eigenrays3's dtype=np.float32 plumbing end-to-end: an f32
    solve over a plain f32 grid3 medium finds the SAME arrival as the
    all-f64 one (tt to f32 grade).  The receiver must sit INSIDE the
    fan's landing disk: a +-0.35 rad fisheye fan from (1,0,0) lands
    within ~+-0.035 in (y, z) at the x=-0.9 plane (the field focuses),
    so (0.02, 0.01) is reachable while (0.1, 0.05) is provably not
    (0 arrivals by design)."""
    from raytracing_tpu.engine.eigenray3d import find_eigenrays3

    F, ax = _samples(21)
    kw = dict(source=(1.0, 0.0, 0.0), receivers=[(-0.9, 0.02, 0.01)],
              delta_s=2 * np.pi / 500, max_size=1200,
              box=(-1.4, 1.4, -1.4, 1.4, -1.4, 1.4),
              fan=(-0.35, 0.35, 13, -0.35, 0.35, 13), iters=8, tol=3e-6)
    m32 = c1_medium3_from_samples(F, ax, ax, ax, dtype=np.float32)
    eig32 = find_eigenrays3("op6", m32, dtype=np.float32, **kw)
    with jax.enable_x64(True):
        m64 = c1_medium3_from_samples(F, ax, ax, ax, dtype=np.float64)
        eig64 = find_eigenrays3("op6", m64, **kw)
    assert len(np.asarray(eig32.traveltime)) == len(
        np.asarray(eig64.traveltime)) >= 1
    tt32 = np.sort(np.asarray(eig32.traveltime))
    tt64 = np.sort(np.asarray(eig64.traveltime))
    # plain-f32 tables: coefficient quantization floors this at ~1e-5;
    # the df facade (below) removes that floor at equal launch
    assert np.abs(tt32 - tt64).max() < 5e-5 * (1.0 + np.abs(tt64).max())


@pytest.mark.slow
def test_facade_pick_rows_f64_grade():
    """Crossing-pick rows through the facade at f32 match the all-f64
    rows AT EQUAL LAUNCH DIRECTION — the 2-D tier's attribution
    methodology (per-arrival deviations are dominated by the
    theta0 root shift through dq/dtheta0, NOT arithmetic; compare at
    equal launch).  This is the f64-substitute claim for float32 3-D
    eigenray work, testable on any backend."""
    from raytracing_tpu.engine.dynamic3d import (CROSS3_COLS,
                                                 trace_crossings_pick3)

    F, ax = _samples(21)
    m = df_eval_medium3_from_samples(F, ax, ax, ax)
    r = 8
    th = np.linspace(-0.03, 0.03, r)
    dir0 = np.stack([-np.cos(th), np.sin(th), np.full(r, 0.01)], -1)
    pos0 = np.tile([[1.0, 0.0, 0.0]], (r, 1))
    kw = dict(pos0=pos0, dir0=dir0, delta_s=2 * np.pi / 500, steps=700,
              box=(-1.4, 1.4, -1.4, 1.4, -1.4, 1.4),
              xr=np.full(r, -0.9), ordk=np.zeros(r, np.int32))
    p32 = trace_crossings_pick3("op6", m, dtype=np.float32, **kw)
    with jax.enable_x64(True):
        m64 = c1_medium3_from_samples(F, ax, ax, ax, dtype=np.float64)
        p64 = trace_crossings_pick3("op6", m64, dtype=np.float64, **kw)
    f32s = np.asarray(p32.found)
    assert f32s.all() and np.asarray(p64.found).all()
    s32 = np.asarray(p32.state, np.float64)
    s64 = np.asarray(p64.state)
    iTT = CROSS3_COLS.index("traveltime")
    iDQ = CROSS3_COLS.index("detq")
    iY, iZ = CROSS3_COLS.index("y"), CROSS3_COLS.index("z")
    assert np.abs(s32[:, iTT] / s64[:, iTT] - 1.0).max() < 2e-6
    assert np.abs(s32[:, [iY, iZ]] - s64[:, [iY, iZ]]).max() < 1e-5
    # det Q is a DERIVED second-derivative quantity: f32 tangent carries
    # floor it at ~1e-4 relative; the plain-f32 medium's inconsistent
    # gradients are 10-100x worse on the same rays
    assert np.abs(s32[:, iDQ] / s64[:, iDQ] - 1.0).max() < 5e-4
