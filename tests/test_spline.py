"""GridMedium parity with scipy RectBivariateSpline (the reference's media)."""
import numpy as np
import pytest
from scipy.interpolate import RectBivariateSpline

import raytracing_tpu as rt
from raytracing_tpu import config
from raytracing_tpu.media import grid as gridmod
from raytracing_tpu.media.medium import analytic_medium
from raytracing_tpu.media.spline import build_grid_medium

BOX = {"interface": (-2.0, 20.0, -2.0, 4.0),
       "fisheye": (-1.5, 1.5, -1.5, 1.5),
       "vert_heterogeneous": (-2.0, 5.0, -2.5, 1.0)}


def test_gen_grid_reference_truncation():
    # genZ's exact int() point-count truncation (RT_bench.py:426-427).
    box = BOX["fisheye"]
    x, y, Z = gridmod.gen_grid("fisheye", box)
    span = box[1] - box[0] + 6.0
    assert len(x) == int(span / config.DELTA + 1)
    assert np.isclose(x[0], -4.5) and np.isclose(x[-1], 4.5)
    assert Z.shape == (len(y), len(x))


@pytest.mark.parametrize("field", ["fisheye", "vert_heterogeneous"])
def test_grid_medium_matches_scipy(field):
    box = BOX[field]
    med = build_grid_medium(field, box, dtype=np.float64)

    x, y, Z = gridmod.gen_grid(field, box)
    dndx, dndy = gridmod.gradient_grids(Z)
    z_lin = RectBivariateSpline(y, x, Z, kx=1, ky=1)
    sx = RectBivariateSpline(y, x, dndx, kx=3, ky=3)
    sy = RectBivariateSpline(y, x, dndy, kx=3, ky=3)

    rng = np.random.default_rng(3)
    qx = rng.uniform(box[0] - 1, box[1] + 1, 500)
    qy = rng.uniform(box[2] - 1, box[3] + 1, 500)

    n, (gx, gy) = med.n_and_grad(qx, qy)
    want_n = z_lin(qy, qx, grid=False)
    want_gx = sx(qy, qx, grid=False)
    want_gy = sy(qy, qx, grid=False)
    np.testing.assert_allclose(np.asarray(n), want_n, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(gx), want_gx, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(gy), want_gy, rtol=1e-8, atol=1e-10)


def test_grid_medium_clamps_like_fitpack():
    """Out-of-range queries clamp to the grid boundary (fpbisp.f semantics)."""
    field = "fisheye"
    box = BOX[field]
    med = build_grid_medium(field, box, dtype=np.float64)
    x, y, Z = gridmod.gen_grid(field, box)
    n_out = float(med.n(np.array(100.0), np.array(0.0)))
    n_edge = float(med.n(np.array(x[-1]), np.array(0.0)))
    assert n_out == pytest.approx(n_edge, abs=1e-12)


def test_grid_medium_approximates_analytic():
    """On the fine reference grid the spline tracks the analytic field."""
    field = "vert_heterogeneous"
    med = build_grid_medium(field, BOX[field], dtype=np.float64)
    ana = analytic_medium(field)
    rng = np.random.default_rng(5)
    qx = rng.uniform(-1.0, 4.0, 200)
    qy = rng.uniform(-2.0, 0.5, 200)
    n_g, (gx_g, gy_g) = med.n_and_grad(qx, qy)
    n_a, (gx_a, gy_a) = ana.n_and_grad(qx, qy)
    np.testing.assert_allclose(np.asarray(n_g), np.asarray(n_a), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gy_g), np.asarray(gy_a),
                               rtol=1e-3, atol=1e-8)


def test_stratified_medium_matches_2d_grid_medium():
    from raytracing_tpu.media.spline import build_stratified_medium
    box = BOX["vert_heterogeneous"]
    m1 = build_stratified_medium("vert_heterogeneous", box, dtype=np.float64)
    m2 = build_grid_medium("vert_heterogeneous", box, dtype=np.float64)
    rng = np.random.default_rng(7)
    qx = rng.uniform(box[0] - 1, box[1] + 1, 300)
    qy = rng.uniform(box[2] - 1, box[3] + 1, 300)
    n1, (gx1, gy1) = m1.n_and_grad(qx, qy)
    n2, (gx2, gy2) = m2.n_and_grad(qx, qy)
    np.testing.assert_allclose(np.asarray(n1), np.asarray(n2),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(gy1), np.asarray(gy2),
                               rtol=1e-6, atol=1e-10)
    assert np.all(np.asarray(gx1) == 0.0)


def test_stratified_interface_meets_snell_oracle():
    import raytracing_tpu as rt
    from raytracing_tpu import calibrated, config as cfg
    from raytracing_tpu.engine import oracles
    from raytracing_tpu.media.spline import build_stratified_medium
    scen = rt.scenario("interface")
    med = build_stratified_medium("interface", scen.box, dtype=np.float64)
    ds, _ = calibrated.calibrated("op6", "interface")
    res = rt.trace("op6", scen, med, delta_s=ds, dtype=np.float64)
    errs = np.asarray(oracles.snell_errors_deg(res, scen.theta0))
    assert errs.mean() < cfg.MAX_DEVIATION
    assert errs.max() < cfg.MAX_DEVIATION_SINGLE_RAY


def test_stratified_rejects_fisheye():
    from raytracing_tpu.media.spline import build_stratified_medium
    with pytest.raises(ValueError, match="varies in x"):
        build_stratified_medium("fisheye", BOX["fisheye"])


def _measured_profile():
    """A lab-style profile: thermocline-like index vs depth, uniform y."""
    y = np.linspace(-3.0, 1.0, 97)
    col = 1.0 + 0.3 * np.tanh(2.0 * y) + 0.05 * y
    return col, y


def test_stratified_from_samples_matches_2d_pipeline():
    """A measured profile equals the 2-D pipeline on its tiled grid: the
    tensor spline of an x-constant field IS its 1-D spline, so the cheap
    profile entry loses nothing vs grid_medium_from_samples."""
    col, y = _measured_profile()
    hy = y[1] - y[0]
    x = y[0] + np.arange(8) * hy          # same pitch -> same np.gradient
    Z = np.tile(col[:, None], (1, len(x)))
    m1 = rt.stratified_medium_from_samples(col, y, dtype=np.float64)
    m2 = rt.grid_medium_from_samples(Z, x, y, dtype=np.float64)
    rng = np.random.default_rng(11)
    qx = x[0] + rng.uniform(0, 1, 300) * (x[-1] - x[0])
    qy = rng.uniform(y[0] - 1, y[-1] + 1, 300)
    n1, (gx1, gy1) = m1.n_and_grad(qx, qy)
    n2, (gx2, gy2) = m2.n_and_grad(qx, qy)
    np.testing.assert_allclose(np.asarray(n1), np.asarray(n2),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(gy1), np.asarray(gy2),
                               rtol=1e-6, atol=1e-10)
    assert np.all(np.asarray(gx1) == 0.0)


def test_c1_stratified_from_samples_matches_2d_c1():
    col, y = _measured_profile()
    hy = y[1] - y[0]
    x = y[0] + np.arange(8) * hy
    Z = np.tile(col[:, None], (1, len(x)))
    m1 = rt.c1_stratified_from_samples(col, y, dtype=np.float64)
    m2 = rt.c1_medium_from_samples(Z, x, y, dtype=np.float64)
    rng = np.random.default_rng(11)
    qx = x[0] + rng.uniform(0, 1, 300) * (x[-1] - x[0])
    qy = rng.uniform(y[0], y[-1], 300)
    n1, (_, gy1) = m1.n_and_grad(qx, qy)
    n2, (gx2, gy2) = m2.n_and_grad(qx, qy)
    np.testing.assert_allclose(np.asarray(n1), np.asarray(n2),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(gy1), np.asarray(gy2),
                               rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(np.asarray(gx2), 0.0, atol=1e-9)


def test_profile_from_samples_validation():
    col, y = _measured_profile()
    with pytest.raises(ValueError, match="uniformly spaced"):
        rt.stratified_medium_from_samples(col[:5], np.array([0, 1, 2, 4, 5.]))
    with pytest.raises(ValueError, match="matching 1-D"):
        rt.c1_stratified_from_samples(col[:6], y[:5])
    with pytest.raises(ValueError, match="at least 4"):
        rt.stratified_medium_from_samples(col[:3], y[:3])
    # descending axes are rejected, not silently box-inverted: a lab grid
    # recorded surface-to-bottom must be flipped, every builder agrees
    with pytest.raises(ValueError, match="ascending"):
        rt.stratified_medium_from_samples(col[::-1], y[::-1])
    Z2 = np.tile(col[:, None], (1, 8))
    x8 = y[0] + np.arange(8) * (y[1] - y[0])
    for build in (rt.grid_medium_from_samples, rt.c1_medium_from_samples,
                  rt.df_grid_medium_from_samples,
                  rt.df_c1_medium_from_samples):
        with pytest.raises(ValueError, match="ascending"):
            build(Z2[::-1], x8, y[::-1])


@pytest.mark.slow
def test_profile_from_samples_runs_kernel_tier():
    """fast_trace routes a from-samples profile through the stratified
    kernels (interpret mode on CPU) and agrees with the scan engine."""
    import dataclasses

    from raytracing_tpu.engine.fast import fast_trace

    col, y = _measured_profile()
    scen = dataclasses.replace(
        rt.scenario("vert_heterogeneous"), name="profile",
        box=(-2.0, 6.0, float(y[0]), float(y[-1])))
    r, steps, ds = 256, 200, np.float32(0.01)
    pos0 = np.stack([np.zeros(r, np.float32),
                     np.linspace(-1.5, 0.5, r, dtype=np.float32)], -1)
    theta0 = np.full(r, 0.3, np.float32)
    for med in (rt.stratified_medium_from_samples(col, y),
                rt.c1_stratified_from_samples(col, y)):
        out = fast_trace("op6", scen, med, delta_s=ds, pos0=pos0,
                         theta0=theta0, steps=steps, block_rays=256)
        assert "scan" not in out.engine, out.engine
        ref = rt.trace("op6", scen, med, delta_s=float(ds), mode="metrics",
                       dtype=np.float32, max_size=steps + 1,
                       pos0=pos0, theta0=theta0)
        np.testing.assert_allclose(np.asarray(out.pos),
                                   np.asarray(ref.final.pos), atol=5e-5)


def test_compact_stratified_equivalent():
    """Trimmed table == full table within f32 rounding; vert untouched."""
    import jax.numpy as jnp
    from raytracing_tpu.media.spline import (build_stratified_medium,
                                             compact_stratified)
    scen = rt.scenario("interface")
    full = build_stratified_medium("interface", scen.box, dtype=np.float32)
    comp = compact_stratified(full)
    assert comp.ny < full.ny // 4  # the sigmoid table really shrinks
    y = np.linspace(-5.0, 7.0, 4001).astype(np.float32)
    x = np.zeros_like(y)
    nf, (_, gf) = full.n_and_grad(jnp.asarray(x), jnp.asarray(y))
    nc, (_, gc) = comp.n_and_grad(jnp.asarray(x), jnp.asarray(y))
    # agreement is limited by f32 *query* quantization, not the trim: the
    # full table's cell coordinate fy ~ 280 has ~3e-5 ulps, and one ulp of
    # fy moves n by (per-cell jump ~0.1) -> ~1e-5 noise in BOTH directions;
    # the compact table (fy ~ 10) is the more accurate of the two
    np.testing.assert_allclose(np.asarray(nc), np.asarray(nf), atol=2e-5)
    np.testing.assert_allclose(np.asarray(gc), np.asarray(gf), atol=5e-4)

    vscen = rt.scenario("vert")
    vfull = build_stratified_medium("vert_heterogeneous", vscen.box,
                                    dtype=np.float32)
    assert compact_stratified(vfull) is vfull  # varies everywhere


def test_compact_stratified_kernel_route():
    """fast_trace on the full interface table == the scan tier."""
    from raytracing_tpu.engine.fast import fast_trace
    from raytracing_tpu.media.spline import build_stratified_medium
    scen = rt.scenario("interface")
    med = build_stratified_medium("interface", scen.box, dtype=np.float32)
    r = 128
    theta0 = np.linspace(scen.theta0[0], scen.theta0[-1], r).astype(np.float32)
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    out = fast_trace("op6", scen, med, delta_s=0.01, steps=400,
                     pos0=pos0, theta0=theta0, block_rays=128)
    assert out.engine == "fused-strat-seg-skip"
    ref = rt.trace("op6", scen, med, delta_s=0.01, mode="metrics",
                   dtype=np.float32, max_size=401, pos0=pos0, theta0=theta0)
    np.testing.assert_allclose(np.asarray(out.pos),
                               np.asarray(ref.final.pos), atol=3e-4)


def test_compact_stratified_range_trim_vert():
    """Reachability trim: the vert table spans the padded grid, but only
    box-reachable rows matter — kernel results unchanged vs the full table."""
    import jax.numpy as jnp
    from raytracing_tpu.engine.fast import fast_trace
    from raytracing_tpu.media.spline import (build_stratified_medium,
                                             compact_stratified)
    scen = rt.scenario("vert")
    full = build_stratified_medium("vert_heterogeneous", scen.box,
                                   dtype=np.float32)
    comp = compact_stratified(full, y_range=(scen.box[2] - 0.1,
                                             scen.box[3] + 0.1))
    assert comp.ny < full.ny // 2
    # in-range evaluation is bit-identical (same slice, new origin)
    y = np.linspace(scen.box[2], scen.box[3], 1001).astype(np.float32)
    x = np.zeros_like(y)
    nf, (_, gf) = full.n_and_grad(jnp.asarray(x), jnp.asarray(y))
    nc, (_, gc) = comp.n_and_grad(jnp.asarray(x), jnp.asarray(y))
    # f32 query quantization only (the compact fy is the more accurate)
    np.testing.assert_allclose(np.asarray(nc), np.asarray(nf), atol=2e-6)
    np.testing.assert_allclose(np.asarray(gc), np.asarray(gf), atol=2e-6)
    # end-to-end through the kernels on the full table
    r = 128
    theta0 = np.linspace(0.2, 1.3, r).astype(np.float32)
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    out = fast_trace("op8", scen, full, delta_s=0.02, steps=200,
                     pos0=pos0, theta0=theta0, block_rays=128)
    ref = rt.trace("op8", scen, full, delta_s=0.02, mode="metrics",
                   dtype=np.float32, max_size=201, pos0=pos0, theta0=theta0)
    np.testing.assert_allclose(np.asarray(out.pos),
                               np.asarray(ref.final.pos), atol=3e-4)


def test_grid_medium_from_samples_matches_builder():
    """User-supplied samples produce the same medium as the built-in
    sampler, and reject malformed grids with named errors."""
    import pytest

    import raytracing_tpu as rt
    from raytracing_tpu.media import grid as _grid
    from raytracing_tpu.media.spline import (build_grid_medium,
                                             grid_medium_from_samples)

    from raytracing_tpu import config

    scen = rt.scenario("fisheye")
    x, y, Z = _grid.gen_grid("fisheye", scen.box)
    a = build_grid_medium("fisheye", scen.box, dtype=np.float32)
    # gradient_spacing=DELTA reproduces the reference's np.gradient call
    # exactly (the builder's own convention); the default (true mean
    # pitch) differs at ~3e-4 relative
    b = grid_medium_from_samples(Z, x, y, dtype=np.float32,
                                 gradient_spacing=config.DELTA)
    np.testing.assert_array_equal(np.asarray(a.Z), np.asarray(b.Z))
    np.testing.assert_array_equal(np.asarray(a.cx), np.asarray(b.cx))
    assert (a.x0, a.y0, a.nx, a.ny) == (b.x0, b.y0, b.nx, b.ny)

    with pytest.raises(ValueError, match="shape"):
        grid_medium_from_samples(Z[:-1], x, y)
    with pytest.raises(ValueError, match="uniformly"):
        grid_medium_from_samples(Z[:4, :4], x[:4] ** 1.1, y[:4])
    with pytest.raises(ValueError, match="4x4"):
        grid_medium_from_samples(Z[:3, :3], x[:3], y[:3])


def test_user_samples_trace_at_kernel_tier():
    """A user-measured index grid (Gaussian lens — a field the reference
    cannot express without source edits) traces through fast_trace, which
    routes 2-D grid media to the scan tier, and matches the scan engine on
    the same medium."""
    import raytracing_tpu as rt
    from raytracing_tpu.engine.fast import fast_trace
    from raytracing_tpu.media.spline import grid_medium_from_samples

    h = 0.05
    x = np.arange(-3.0, 3.0 + h / 2, h)
    y = np.arange(-3.0, 3.0 + h / 2, h)
    X, Y = np.meshgrid(x, y)
    Z = 1.0 + 0.4 * np.exp(-(X ** 2 + Y ** 2) / 0.8)   # Gaussian lens
    gm = grid_medium_from_samples(Z, x, y, dtype=np.float32)

    import dataclasses
    scen = dataclasses.replace(rt.scenario("fisheye"),
                               box=(-2.5, 2.5, -2.5, 2.5))
    r = 128
    pos0 = np.tile(np.array([[-2.0, -0.3]], np.float32), (r, 1))
    theta0 = np.linspace(0.1, 0.2, r).astype(np.float32)
    out = fast_trace("op6", scen, gm, delta_s=0.01, steps=300,
                     pos0=pos0, theta0=theta0, interpret=True)
    assert out.engine == "scan"
    ref = rt.trace("op6", scen, gm, delta_s=0.01, mode="metrics",
                   dtype=np.float32, max_size=301, pos0=pos0,
                   theta0=theta0)
    np.testing.assert_allclose(np.asarray(out.pos),
                               np.asarray(ref.final.pos), atol=5e-4)


def test_medium_from_samples_shared_dispatch():
    """media/samples.medium_from_samples is the ONE samples->medium
    dispatch behind serve /v1/trace_samples and the CLI --medium-file;
    its four (rank, family) corners and its named errors."""
    from raytracing_tpu.media.c1 import C1GridMedium, C1StratifiedMedium
    from raytracing_tpu.media.samples import medium_from_samples
    from raytracing_tpu.media.spline import GridMedium, StratifiedGridMedium

    y = np.linspace(-1.0, 1.0, 21)
    prof = 1.3 - 0.1 * y * y
    x = np.linspace(-2.0, 2.0, 17)
    Z = 1.0 + np.add.outer(0.05 * y * y, 0.02 * x * x)

    m, box, kind = medium_from_samples(prof, None, y)
    assert isinstance(m, StratifiedGridMedium) and kind == "profile"
    assert box[2:] == (-1.0, 1.0) and box[0] < -1e20 < 1e20 < box[1]
    m, _, _ = medium_from_samples(prof, None, y, family="c1")
    assert isinstance(m, C1StratifiedMedium)
    m, box, kind = medium_from_samples(Z, x, y)
    assert isinstance(m, GridMedium) and kind == "grid"
    assert box == (-2.0, 2.0, -1.0, 1.0)
    m, _, _ = medium_from_samples(Z, x, y, family="c1")
    assert isinstance(m, C1GridMedium)

    with pytest.raises(ValueError, match="family"):
        medium_from_samples(prof, None, y, family="cubic")
    with pytest.raises(ValueError, match="'x' coordinate"):
        medium_from_samples(Z, None, y)
    with pytest.raises(ValueError, match="'y' coordinate"):
        medium_from_samples(prof, None, None)
    with pytest.raises(ValueError, match="1-D or 2-D"):
        medium_from_samples(Z[None], x, y)
