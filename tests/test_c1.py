"""Consistent-gradient (C1) media: exactness, consistency, conservation.

Three claims pinned here (media/c1.py):

1. the 2-D medium IS the not-a-knot bicubic interpolant of the samples
   (scipy RectBivariateSpline parity to ~1e-9 at f64), and its reported
   gradient IS that spline's analytic derivative;
2. grad n is consistent with n — jax.grad of medium.n reproduces
   n_and_grad's gradient (the property the reference's sampled pipeline
   lacks, RT_bench.py:455-458);
3. consistency repairs the sampled-media momentum-CV floor documented in
   docs/PRECISION.md: the vert scenario's CV at the reference grid pitch
   drops from ~6e-3 % (parity medium) to the analytic path's territory.
"""
import jax
import numpy as np
import pytest

import raytracing_tpu as rt
from raytracing_tpu.media.c1 import (
    build_c1_medium,
    build_c1_stratified,
    c1_medium_from_samples,
)

scipy = pytest.importorskip("scipy")


def _sample_grid():
    x = np.linspace(-2.0, 2.0, 25)
    y = np.linspace(-1.5, 1.5, 19)
    X, Y = np.meshgrid(x, y)
    Z = 1.0 / (1.0 + 0.3 * X * X + 0.5 * Y * Y) + 0.05 * np.sin(1.7 * X)
    return Z, x, y


def test_c1_matches_scipy_spline_and_derivatives():
    from scipy.interpolate import RectBivariateSpline

    Z, x, y = _sample_grid()
    med = c1_medium_from_samples(Z, x, y, dtype=np.float64, backend="scipy")
    spl = RectBivariateSpline(y, x, Z, kx=3, ky=3)

    rng = np.random.default_rng(1)
    qx = rng.uniform(x[0], x[-1], 257)
    qy = rng.uniform(y[0], y[-1], 257)
    n, (gx, gy) = med.n_and_grad(qx, qy)
    np.testing.assert_allclose(np.asarray(n), spl(qy, qx, grid=False),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(gx),
                               spl(qy, qx, dx=0, dy=1, grid=False),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(gy),
                               spl(qy, qx, dx=1, dy=0, grid=False),
                               rtol=0, atol=1e-8)


def test_c1_native_builder_matches_scipy_builder():
    from raytracing_tpu import native

    if not native.available():
        pytest.skip("native builder unavailable")
    Z, x, y = _sample_grid()
    a = c1_medium_from_samples(Z, x, y, dtype=np.float64, backend="native")
    b = c1_medium_from_samples(Z, x, y, dtype=np.float64, backend="scipy")
    np.testing.assert_allclose(np.asarray(a.nodes), np.asarray(b.nodes),
                               rtol=0, atol=1e-9)


def test_c1_gradient_is_gradient_of_n():
    Z, x, y = _sample_grid()
    med = c1_medium_from_samples(Z, x, y, dtype=np.float64)

    rng = np.random.default_rng(2)
    qx = rng.uniform(x[1], x[-2], 64)
    qy = rng.uniform(y[1], y[-2], 64)
    _, (gx, gy) = med.n_and_grad(qx, qy)
    ax = jax.vmap(jax.grad(lambda a, b: med.n(a, b), argnums=0))(qx, qy)
    ay = jax.vmap(jax.grad(lambda a, b: med.n(a, b), argnums=1))(qx, qy)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(ax),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.asarray(gy), np.asarray(ay),
                               rtol=0, atol=1e-10)


def test_c1_stratified_matches_1d_spline():
    from scipy.interpolate import CubicSpline

    scen = rt.scenario("vert")
    med = build_c1_stratified("vert_heterogeneous", scen.box,
                              dtype=np.float64)
    ny = med.ny
    ys = np.linspace(med.y0, med.y0 + (ny - 1) / med.inv_hy, 501)
    n, (gx, gy) = med.n_and_grad(np.zeros_like(ys), ys)

    from raytracing_tpu.media import grid as _grid
    x, y, Z = _grid.gen_grid("vert_heterogeneous", scen.box)
    spl = CubicSpline(y, np.asarray(Z[:, 0], np.float64),
                      bc_type="not-a-knot")
    np.testing.assert_allclose(np.asarray(n), spl(ys), rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(gy), spl(ys, 1), rtol=0, atol=1e-8)
    assert np.all(np.asarray(gx) == 0.0)


def test_c1_repairs_vert_momentum_cv():
    """The headline: consistency beats the parity medium's CV floor.

    docs/PRECISION.md table (op8, vert, scan engine, f64): analytic
    1.1e-5 %, sampled-parity 5.7e-3 %.  The C1 medium uses the same grid
    pitch and samples but a consistent (n, grad n) pair; its CV must land
    well below the parity floor.
    """
    from raytracing_tpu.engine.oracles import momentum_cv_pct_from_history
    from raytracing_tpu.media.spline import build_stratified_medium

    from raytracing_tpu import config

    scen = rt.scenario("vert")
    # op8's calibrated step; protocol as in benchmarks/strat_cv_probe.py
    # (scenario-average over interior rays, RT_bench.py:1352-1360)
    kw = dict(delta_s=config.SIGMA / 2.74, mode="history", dtype=np.float64)
    ref = rt.trace("op8", scen,
                   build_stratified_medium("vert_heterogeneous", scen.box,
                                           dtype=np.float64), **kw)
    c1 = rt.trace("op8", scen,
                  build_c1_stratified("vert_heterogeneous", scen.box,
                                      dtype=np.float64), **kw)

    def cv(res):
        per_ray = np.asarray(momentum_cv_pct_from_history(res))
        return float(np.mean(per_ray[1:-1]))

    cv_ref, cv_c1 = cv(ref), cv(c1)
    assert cv_c1 < cv_ref / 10.0, (cv_c1, cv_ref)
    assert cv_c1 < 5e-4, cv_c1


@pytest.fixture(scope="module")
def c1_fisheye():
    scen = rt.scenario("fisheye")
    med = build_c1_medium("fisheye", scen.box, dtype=np.float32)
    r = 1024
    pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (r, 1))
    theta0 = (np.pi / 2 + np.linspace(-0.02, 0.02, r)).astype(np.float32)
    return scen, med, pos0, theta0


@pytest.mark.slow
def test_fast_trace_routes_c1_to_tiled(c1_fisheye):
    from raytracing_tpu.engine.fast import fast_trace

    scen, med, pos0, theta0 = c1_fisheye
    out = fast_trace("op1", scen, med, delta_s=2 * np.pi / 303,
                     pos0=pos0, theta0=theta0, steps=48, block_rays=1024,
                     interpret=True)
    # 2-D grid media run on the scan tier
    assert out.engine == "scan"
    assert np.all(np.isfinite(np.asarray(out.pos)))


@pytest.mark.slow
def test_c1_strat_kernel_matches_scan():
    """The 4-channel stratified kernel (one cubic for n AND dn/dy) agrees
    with the scan tier on the same C1 medium; fast_trace routes it."""
    from raytracing_tpu.engine.fast import fast_trace

    scen = rt.scenario("interface")
    med = build_c1_stratified("interface", scen.box, dtype=np.float32)
    r = 256
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    theta0 = np.sort(np.resize(np.asarray(scen.theta0, np.float32), r))
    out = fast_trace("op6", scen, med, delta_s=0.01, pos0=pos0,
                     theta0=theta0, steps=300, block_rays=128,
                     interpret=True)
    assert out.engine == "fused-strat-seg-skip"
    ref = rt.trace("op6", scen, med, delta_s=0.01, mode="metrics",
                   dtype=np.float32, max_size=301, pos0=pos0, theta0=theta0)
    np.testing.assert_allclose(np.asarray(out.pos),
                               np.asarray(ref.final.pos), atol=3e-4)


@pytest.mark.slow
def test_c1_strat_golden_on_device_cv():
    """The on-device Welford CV oracle through the golden kernel reads the
    C1 medium's repaired conservation: ~1e-4 % where the parity medium
    floors at ~5e-3 % (docs/PRECISION.md)."""
    from raytracing_tpu.kernels.golden import golden_trace_final

    vs = rt.scenario("vert")
    med = build_c1_stratified("vert_heterogeneous", vs.box,
                              dtype=np.float32)
    r = 256
    pos0 = np.tile(vs.pos0[:1].astype(np.float32), (r, 1))
    # interior launch angles: theta near 0 / pi/2 make p_x ~ 0 and CV
    # meaningless (the reference masks those, RT_bench.py:957-958)
    theta0 = np.linspace(0.2, 1.2, r).astype(np.float32)
    g = golden_trace_final(pos0, theta0, np.float32(0.0193),
                           np.float32(1.0), field="vert_heterogeneous",
                           op="op5", steps=200, box=tuple(vs.box),
                           block_rays=128, interpret=True, medium=med,
                           with_stats=True)
    cv = (100.0 * np.sqrt(np.asarray(g.mom_m2) / np.asarray(g.mom_count))
          / np.abs(np.asarray(g.mom_mean)))
    assert float(np.nanmax(cv)) < 5e-4, float(np.nanmax(cv))


@pytest.mark.slow
def test_c1_model_zoo_and_diff_tier():
    """models.get exposes the C1 backends; trace_diff differentiates
    through the C1 gather evaluation."""
    import jax.numpy as jnp

    from raytracing_tpu import models
    from raytracing_tpu.engine.diff import trace_diff

    m = models.get("vert", medium="c1-stratified")
    out = m.run("op8", block_rays=128)
    assert out.engine == "fused-strat-seg-skip"
    assert np.all(np.isfinite(np.asarray(out.pos)))
    m2 = models.get("fisheye", medium="c1")
    out2 = m2.run("op1", block_rays=128)
    assert out2.engine == "scan"

    scen = rt.scenario("fisheye")
    c1 = build_c1_medium("fisheye", scen.box, dtype=np.float32)
    pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (8, 1))
    th = np.full(8, np.pi / 2, np.float32)

    def loss(ds):
        r = trace_diff("op1", c1, pos0, th, ds, steps=32,
                       box=tuple(scen.box))
        return jnp.sum(r.pos ** 2)

    g = jax.grad(loss)(jnp.float32(0.02))
    assert np.isfinite(float(g)) and float(g) != 0.0


@pytest.mark.slow
def test_c1_sweep_paths():
    """The fused candidate sweep covers the stratified C1 form; the 2-D
    C1 grid sweeps on the scan tier."""
    from raytracing_tpu.parallel.sweep import (fused_sweep_supported,
                                               run_candidates_fused)

    scen = rt.scenario("fisheye")
    c1 = build_c1_medium("fisheye", scen.box, dtype=np.float32)
    assert not fused_sweep_supported("op1", scen, c1)

    vs = rt.scenario("vert")
    vc1 = build_c1_stratified("vert_heterogeneous", vs.box,
                              dtype=np.float32)
    assert fused_sweep_supported("op8", vs, vc1)
    m = run_candidates_fused("op8", vs, np.array([0.02, 0.015], np.float32),
                             np.array([50, 60], np.float32), 60, medium=vc1,
                             rays=128, block_rays=128, interpret=True)
    cv = np.asarray(m["cv_pct"])
    assert np.all(np.isfinite(cv)) and np.all(cv < 1e-3)


def test_compact_c1_stratified():
    """The C1 table trim (media.c1.compact_c1_stratified): interface's
    681-row padded table collapses to at most 128 rows, and trimmed
    evaluation matches the full table over the reachable range."""
    from raytracing_tpu.media.c1 import compact_c1_stratified

    scen = rt.scenario("interface")
    full = build_c1_stratified("interface", scen.box, dtype=np.float32)
    trim = compact_c1_stratified(full, y_range=(scen.box[2] - 0.05,
                                                scen.box[3] + 0.05))
    assert trim.ny <= 128, trim.ny
    ys = np.linspace(scen.box[2], scen.box[3], 2001)
    nf, (_, gf) = full.n_and_grad(np.zeros_like(ys), ys)
    nt, (_, gt) = trim.n_and_grad(np.zeros_like(ys), ys)
    np.testing.assert_allclose(np.asarray(nt), np.asarray(nf), atol=1e-5)
    np.testing.assert_allclose(np.asarray(gt), np.asarray(gf), atol=1e-3)
    # nothing to trim -> same object back
    assert compact_c1_stratified(trim) is trim


@pytest.mark.slow
def test_c1_grid_sharded_entry(c1_fisheye):
    """fast_trace_sharded accepts the 2-D C1 medium (the scan tier under
    the mesh), not just the 1-D stratified form."""
    from raytracing_tpu.engine.fast import fast_trace, fast_trace_sharded
    from raytracing_tpu.parallel.mesh import make_mesh

    n_dev = jax.device_count()
    scen, med, _, _ = c1_fisheye
    r = n_dev * 128
    pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (r, 1))
    theta0 = np.full(r, np.pi / 2, np.float32)
    g = fast_trace_sharded("op1", scen, med, delta_s=2 * np.pi / 64,
                           pos0=pos0, theta0=theta0, mesh=make_mesh(n_dev),
                           steps=16, block_rays=128, interpret=True)
    assert g.engine == "scan-sharded"
    single = fast_trace("op1", scen, med, delta_s=2 * np.pi / 64,
                        pos0=pos0, theta0=theta0, steps=16)
    np.testing.assert_array_equal(np.asarray(g.pos), np.asarray(single.pos))


def test_c1_grid_fisheye_closure():
    """2-D C1 medium closure is at least as good as the parity medium's."""
    from raytracing_tpu.engine.oracles import closure_error_pct
    from raytracing_tpu.media.spline import build_grid_medium

    scen = rt.scenario("fisheye")
    div = 300
    kw = dict(delta_s=2 * np.pi / div, divisor=div + 1, n_turns=1,
              dtype=np.float64, mode="metrics")
    ref = rt.trace("op1", scen,
                   build_grid_medium("fisheye", scen.box, dtype=np.float64),
                   **kw)
    c1 = rt.trace("op1", scen,
                  build_c1_medium("fisheye", scen.box, dtype=np.float64),
                  **kw)
    e_ref = float(np.max(np.asarray(closure_error_pct(ref))))
    e_c1 = float(np.max(np.asarray(closure_error_pct(c1))))
    assert e_c1 <= e_ref * 1.5, (e_c1, e_ref)
