"""fast_trace dispatch: routing, padding, fallback."""
import dataclasses

import numpy as np
import pytest

import raytracing_tpu as rt
from raytracing_tpu.engine.fast import fast_trace, supports

# heavyweight module: segmented chains / sharded meshes / full sweeps /
# interpret-mode kernel parity.  Deselect with -m 'not slow' (CLAUDE.md).
pytestmark = pytest.mark.slow


def _batch(r):
    theta0 = np.full(r, np.pi / 2.0, np.float32)
    pos0 = np.stack([np.ones(r), np.zeros(r)], -1).astype(np.float32)
    return pos0, theta0


def test_routes_and_pads():
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    pos0, theta0 = _batch(200)   # not a multiple of any block
    out = fast_trace("op1", scen, med, delta_s=2 * np.pi / 64, steps=64,
                     pos0=pos0, theta0=theta0, block_rays=128, interpret=True)
    assert out.engine == "fused"
    assert out.pos.shape == (200, 2)
    ref = rt.trace("op1", scen, med, delta_s=2 * np.pi / 64, max_size=65,
                   mode="metrics", dtype=np.float32, pos0=pos0, theta0=theta0)
    np.testing.assert_allclose(np.asarray(out.pos),
                               np.asarray(ref.final.pos), atol=1e-5)


def test_routes_golden():
    scen = dataclasses.replace(rt.scenario("aniso"), s_max=1.0)
    med = rt.analytic_medium("vert_heterogeneous")
    pos0 = np.tile(np.array([[-2.0, -2.0]], np.float32), (64, 1))
    theta0 = np.linspace(0.1, 1.4, 64).astype(np.float32)
    out = fast_trace("op11", scen, med, delta_s=0.02, pos0=pos0, theta0=theta0,
                     block_rays=128, interpret=True)
    assert out.engine == "golden"
    assert out.pos.shape == (64, 2)


def test_grid_medium_coarse_steps_stay_on_kernel_tier():
    """2-D grid media run on the scan tier at every step size, coarse
    steps included, and match the scan engine."""
    from raytracing_tpu.models import get
    m = get("fisheye", medium="grid")
    assert not supports("op1", m.medium)
    pos0, theta0 = _batch(8)
    out = fast_trace("op1", m.scenario, m.medium, delta_s=2 * np.pi / 32,
                     steps=32, pos0=pos0, theta0=theta0)
    assert out.engine == "scan"
    assert out.pos.shape == (8, 2)
    ref = rt.trace("op1", m.scenario, m.medium, delta_s=2 * np.pi / 32,
                   mode="metrics", dtype=np.float32, max_size=33,
                   pos0=pos0, theta0=theta0)
    np.testing.assert_allclose(np.asarray(out.pos),
                               np.asarray(ref.final.pos), atol=1e-3)


def test_fast_trace_sharded_matches_single():
    from raytracing_tpu.engine.fast import fast_trace_sharded
    from raytracing_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    r = 8 * 128
    pos0, theta0 = _batch(r)
    out = fast_trace_sharded("op6", scen, med, delta_s=2 * np.pi / 64,
                             steps=64, pos0=pos0, theta0=theta0, mesh=mesh,
                             block_rays=128)
    assert out.engine == "fused-sharded"
    assert len(out.pos.sharding.device_set) == 8
    single = fast_trace("op6", scen, med, delta_s=2 * np.pi / 64, steps=64,
                        pos0=pos0, theta0=theta0, block_rays=128,
                        interpret=True)
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(single.pos),
                               atol=1e-6)


def test_fast_trace_sharded_rejects_bad_batch():
    from raytracing_tpu.engine.fast import fast_trace_sharded
    from raytracing_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    pos0, theta0 = _batch(100)
    with pytest.raises(ValueError, match="must divide"):
        fast_trace_sharded("op6", scen, med, delta_s=0.1, steps=4,
                           pos0=pos0, theta0=theta0, mesh=mesh, block_rays=128)


def test_fast_trace_high_precision():
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    pos0, theta0 = _batch(200)
    out = fast_trace("op12", scen, med, delta_s=2 * np.pi / 300, steps=300,
                     pos0=pos0, theta0=theta0, block_rays=128,
                     precision="high")
    assert out.engine == "df32"
    # ~1e-7 closure in pure f32 (truncation ~1e-9 at this divisor)
    closure = np.linalg.norm(np.asarray(out.pos)[0] - [1, 0])
    assert closure < 1e-6, closure
    with pytest.raises(ValueError, match="df32 RK4"):
        fast_trace("op6", scen, med, delta_s=0.1, steps=4, pos0=pos0,
                   theta0=theta0, precision="high")
    with pytest.raises(ValueError, match="precision must be"):
        fast_trace("op12", scen, med, delta_s=0.1, steps=4, pos0=pos0,
                   theta0=theta0, precision="banana")


def test_fast_trace_routes_hermite_grid():
    """HermiteGridMedium routes to the scan tier at any step size."""
    import numpy as np
    import raytracing_tpu as rt
    from raytracing_tpu.engine.fast import fast_trace
    from raytracing_tpu.media.hermite import build_hermite_medium
    from raytracing_tpu.media.spline import build_grid_medium
    scen = rt.scenario("fisheye")
    hm = build_hermite_medium(build_grid_medium("fisheye", scen.box,
                                                dtype=np.float32))
    r = 128
    pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (r, 1))
    theta0 = np.full(r, np.pi / 2, np.float32)
    fine = fast_trace("op6", scen, hm, delta_s=0.003, steps=100,
                      pos0=pos0, theta0=theta0, block_rays=128)
    assert fine.engine == "scan"
    coarse = fast_trace("op6", scen, hm, delta_s=0.05, steps=50,
                        pos0=pos0, theta0=theta0, block_rays=128)
    assert coarse.engine == "scan"
    assert np.all(np.isfinite(np.asarray(fine.pos)))
    assert np.all(np.isfinite(np.asarray(coarse.pos)))


def test_fast_trace_custom_medium_kernel():
    """A user-defined medium runs through the fused kernel tier, gradient by
    autodiff inlined into the Pallas body (interpret mode here)."""
    import jax.numpy as jnp
    import numpy as np
    import raytracing_tpu as rt
    from raytracing_tpu.engine.fast import fast_trace
    from raytracing_tpu.media.medium import CustomMedium

    med = CustomMedium(n_fn=lambda x, y: 1.2 + 0.1 * jnp.sin(x) * jnp.cos(y))
    scen = rt.scenario("fisheye")  # box only
    r = 128
    pos0 = np.tile(np.array([[0.2, -0.1]], np.float32), (r, 1))
    theta0 = np.linspace(0.0, np.pi, r).astype(np.float32)
    out = fast_trace("op6", scen, med, delta_s=0.01, steps=200,
                     pos0=pos0, theta0=theta0, block_rays=128)
    assert out.engine == "fused-custom"
    ref = rt.trace("op6", scen, med, delta_s=0.01, mode="metrics",
                   dtype=np.float32, max_size=201, pos0=pos0, theta0=theta0)
    np.testing.assert_allclose(np.asarray(out.pos),
                               np.asarray(ref.final.pos), atol=2e-5)


def test_fast_trace_long_traces_use_segments():
    """Trip counts beyond SEGMENT_THRESHOLD chain bounded
    segments (identical results) instead of a one-shot kernel."""
    import numpy as np
    import raytracing_tpu as rt
    from raytracing_tpu.engine import fast as fastmod
    from raytracing_tpu.engine.fast import fast_trace

    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    r = 128
    pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (r, 1))
    theta0 = np.full(r, np.pi / 2, np.float32)
    old = fastmod.SEGMENT_THRESHOLD
    try:
        fastmod.SEGMENT_THRESHOLD = 100   # force the route at test scale
        seg = fast_trace("op6", scen, med, delta_s=0.02, steps=300,
                         pos0=pos0, theta0=theta0, block_rays=128)
        assert seg.engine == "fused-seg"
        # golden past the threshold segments too (resume kernels)
        g = fast_trace("op5", scen, med, delta_s=0.02, steps=300,
                       pos0=pos0, theta0=theta0, block_rays=128)
        assert g.engine == "golden-seg"
    finally:
        fastmod.SEGMENT_THRESHOLD = old
    one = fast_trace("op6", scen, med, delta_s=0.02, steps=300,
                     pos0=pos0, theta0=theta0, block_rays=128)
    assert one.engine == "fused"
    np.testing.assert_array_equal(np.asarray(seg.pos), np.asarray(one.pos))
    gone = fast_trace("op5", scen, med, delta_s=0.02, steps=300,
                      pos0=pos0, theta0=theta0, block_rays=128)
    assert gone.engine == "golden"
    # golden production mode derives the tangent by rotation; each segment
    # start resets it to cos/sin of the carried angle, so the segmented
    # chain agrees with one-shot to rotation-drift level, not bitwise
    # (segmented_trace docstring; exact under gold_schedule=(16, 0))
    np.testing.assert_allclose(np.asarray(g.pos), np.asarray(gone.pos),
                               atol=2e-5)


def test_fast_trace_small_user_grid_falls_back():
    """A small user grid traces on the scan tier instead of raising."""
    from raytracing_tpu.media.spline import grid_medium_from_samples
    x = np.linspace(-1.5, 1.5, 9)
    y = np.linspace(-1.5, 1.5, 9)
    X, Y = np.meshgrid(x, y)
    Z = 1.0 / (1.0 + X ** 2 + Y ** 2)
    med = grid_medium_from_samples(Z, x, y, dtype=np.float32)
    scen = rt.scenario("fisheye")
    pos0, theta0 = _batch(8)
    out = fast_trace("op1", scen, med, delta_s=0.05, steps=20,
                     pos0=pos0, theta0=theta0, block_rays=128,
                     interpret=True)
    assert out.engine == "scan"
    assert out.pos.shape == (8, 2)


def test_fast_trace_custom_medium_golden():
    """CustomMedium through the golden kernels (cost autodiffed in-kernel)."""
    import jax.numpy as jnp
    import numpy as np
    import raytracing_tpu as rt
    from raytracing_tpu.engine.fast import fast_trace
    from raytracing_tpu.media.medium import CustomMedium

    med = CustomMedium(n_fn=lambda x, y: 1.0 / (18.0 + 2.0 * y))
    ref_med = rt.analytic_medium("vert_heterogeneous")
    scen = rt.scenario("vert")
    r = 128
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    theta0 = np.linspace(0.2, 1.2, r).astype(np.float32)
    out = fast_trace("op5", scen, med, delta_s=0.02, steps=150,
                     pos0=pos0, theta0=theta0, block_rays=128)
    assert out.engine == "golden-custom"
    ref = fast_trace("op5", scen, ref_med, delta_s=0.02, steps=150,
                     pos0=pos0, theta0=theta0, block_rays=128)
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                               atol=2e-3)


def test_fast_trace_gridmedium_auto_hermite():
    """Plain GridMedium traces on the scan tier as it is."""
    import numpy as np
    import raytracing_tpu as rt
    from raytracing_tpu.engine.fast import fast_trace
    from raytracing_tpu.media.spline import build_grid_medium

    scen = rt.scenario("fisheye")
    gm = build_grid_medium("fisheye", scen.box, dtype=np.float32)
    r = 128
    pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (r, 1))
    theta0 = np.full(r, np.pi / 2, np.float32)
    out = fast_trace("op6", scen, gm, delta_s=0.003, steps=100,
                     pos0=pos0, theta0=theta0, block_rays=128)
    assert out.engine == "scan"
    ref = rt.trace("op6", scen, gm, delta_s=0.003, mode="metrics",
                   dtype=np.float32, max_size=101, pos0=pos0, theta0=theta0)
    np.testing.assert_array_equal(np.asarray(out.pos),
                                  np.asarray(ref.final.pos))


def test_fast_trace_sharded_grid_medium():
    """fast_trace_sharded runs 2-D grid media on the scan tier with the
    rays laid out over the mesh, bit-identical to the single-device path."""
    import numpy as np
    import raytracing_tpu as rt
    from raytracing_tpu.engine.fast import fast_trace, fast_trace_sharded
    from raytracing_tpu.media.spline import build_grid_medium
    from raytracing_tpu.parallel.mesh import make_mesh

    scen = rt.scenario("fisheye")
    gm = build_grid_medium("fisheye", scen.box, dtype=np.float32)
    mesh = make_mesh(8)
    r = 8 * 1024
    pos0 = np.tile(np.array([1.0, 0.0], np.float32), (r, 1))
    theta0 = (np.pi / 2 + np.linspace(-0.01, 0.01, r)).astype(np.float32)
    s = fast_trace_sharded("op6", scen, gm, delta_s=0.01, pos0=pos0,
                           theta0=theta0, mesh=mesh, steps=100)
    assert s.engine == "scan-sharded"
    assert len(s.pos.sharding.device_set) == 8
    single = fast_trace("op6", scen, gm, delta_s=0.01, pos0=pos0,
                        theta0=theta0, steps=100, interpret=True)
    np.testing.assert_array_equal(np.asarray(s.pos), np.asarray(single.pos))


def test_fast_trace_exit_scenarios_default_skip():
    """interface/vert batches route through segmented block-skipping by
    default: the fan is sorted by launch angle on the way
    in, frozen blocks bypass the step loop, the sort is undone on the way
    out, and results are bit-identical to the plain segmented path."""
    from raytracing_tpu.engine.segmented import segmented_trace

    scen = rt.scenario("interface")
    med = rt.analytic_medium("interface")
    r = 128
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    rng = np.random.default_rng(0)
    theta0 = rng.permutation(np.linspace(0.3, 1.2, r)).astype(np.float32)
    out = fast_trace("op6", scen, med, delta_s=0.02, steps=200,
                     pos0=pos0, theta0=theta0, block_rays=128,
                     interpret=True)
    assert out.engine == "fused-seg-skip"
    ref = segmented_trace("op6", pos0, theta0, np.float32(0.02), steps=200,
                          box=tuple(scen.box), field=scen.field,
                          segment=1024, block_rays=128, interpret=True)
    np.testing.assert_array_equal(np.asarray(out.pos), np.asarray(ref.pos))
    np.testing.assert_array_equal(np.asarray(out.traveltime),
                                  np.asarray(ref.traveltime))

    vscen = rt.scenario("vert")
    vmed = rt.analytic_medium("vert_heterogeneous")
    vpos = np.tile(vscen.pos0[:1].astype(np.float32), (r, 1))
    vth = rng.permutation(np.linspace(0.2, 1.2, r)).astype(np.float32)
    g = fast_trace("op5", vscen, vmed, delta_s=0.02, steps=120,
                   pos0=vpos, theta0=vth, block_rays=128, interpret=True)
    assert g.engine == "golden-seg-skip"
    gref = segmented_trace("op5", vpos, vth, np.float32(0.02), steps=120,
                           box=tuple(vscen.box), field=vscen.field,
                           segment=256, block_rays=128, interpret=True)
    np.testing.assert_array_equal(np.asarray(g.pos), np.asarray(gref.pos))


def test_fast_trace_stats_on_profile():
    """stats=True rides the kernels' Welford tracker: CV(p_x) from the
    kernel matches the scan-history oracle on the same profile, and the
    C1 family conserves to the analytic floor."""
    import dataclasses

    from raytracing_tpu.engine import oracles
    from raytracing_tpu.engine.fast import fast_trace

    y = np.linspace(-1.5, 1.5, 61)
    med = rt.c1_stratified_from_samples(1.2 - 0.25 * y * y, y)
    scen = dataclasses.replace(rt.scenario("fisheye"), name="profile",
                               gamma=1.0, box=(-1e6, 1e6, -1.5, 1.5))
    r, steps, ds = 256, 300, np.float32(0.01)
    pos0 = np.stack([np.zeros(r, np.float32),
                     np.linspace(-0.1, 0.1, r, dtype=np.float32)], -1)
    theta0 = np.full(r, 0.3, np.float32)
    out = fast_trace("op6", scen, med, delta_s=ds, pos0=pos0,
                     theta0=theta0, steps=steps, block_rays=128, stats=True)
    assert out.mom_count is not None
    from raytracing_tpu.engine.oracles import momentum_cv_pct_from_welford

    cv = momentum_cv_pct_from_welford(out.mom_count, out.mom_mean, out.mom_m2)
    assert cv.max() < 0.05               # the reference's conservation bar

    # both sides sit at the f32 rounding floor (~3e-5 %), so per-ray values
    # are noise — the tracker must agree at the distribution level
    res = rt.trace("op6", scen, med, delta_s=float(ds), mode="history",
                   max_size=steps + 1, pos0=pos0[:64], theta0=theta0[:64])
    ref_cv = np.asarray(oracles.momentum_cv_pct_from_history(res))
    assert 1 / 3 < cv[:64].mean() / ref_cv.mean() < 3, (
        cv[:64].mean(), ref_cv.mean())

    with pytest.raises(ValueError, match="stratified"):
        fast_trace("op6", scen, rt.analytic_medium("fisheye"), delta_s=ds,
                   pos0=pos0, theta0=theta0, steps=steps, stats=True)


def test_fast_trace_sharded_golden_matches_single():
    """The golden/momentum family (incl. the reference's headline aniso
    ops) now shards over the mesh like the fused family — bit-identical
    per-ray results (rays are independent; tables replicate)."""
    from raytracing_tpu.engine.fast import fast_trace_sharded
    from raytracing_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    r = 8 * 128

    # anisotropic op11 on the analytic vert field
    scen = rt.scenario("aniso")
    med = rt.analytic_medium("vert_heterogeneous")
    theta0 = np.resize(np.asarray(scen.theta0, np.float32), r)
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    out = fast_trace_sharded("op11", scen, med, delta_s=0.02, steps=64,
                             pos0=pos0, theta0=theta0, mesh=mesh,
                             block_rays=128)
    assert out.engine == "golden-sharded"
    assert len(out.pos.sharding.device_set) == 8
    single = fast_trace("op11", scen, med, delta_s=0.02, steps=64,
                        pos0=pos0, theta0=theta0, block_rays=128,
                        interpret=True)
    np.testing.assert_array_equal(np.asarray(out.pos),
                                  np.asarray(single.pos))

    # iso golden op5 on a measured stratified profile
    y = np.linspace(-1.5, 1.5, 41)
    smed = rt.stratified_medium_from_samples(1.3 - 0.1 * y * y, y)
    vscen = rt.scenario("vert")
    pos0v = np.stack([np.zeros(r), np.linspace(-0.5, 0.5, r)],
                     -1).astype(np.float32)
    theta0v = np.linspace(-0.3, 0.3, r).astype(np.float32)
    outs = fast_trace_sharded("op5", vscen, smed, delta_s=0.01, steps=64,
                              pos0=pos0v, theta0=theta0v, mesh=mesh,
                              block_rays=128)
    assert outs.engine == "golden-strat-sharded"
    singles = fast_trace("op5", vscen, smed, delta_s=0.01, steps=64,
                         pos0=pos0v, theta0=theta0v, block_rays=128,
                         interpret=True)
    np.testing.assert_array_equal(np.asarray(outs.pos),
                                  np.asarray(singles.pos))


def test_fast_trace_sharded_stats_matches_single():
    """Welford conservation aggregates ride the sharded kernels too —
    identical to the single-device tracker, sharded like the result."""
    from raytracing_tpu.engine.fast import fast_trace_sharded
    from raytracing_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    r = 8 * 128
    y = np.linspace(-1.5, 1.5, 41)
    med = rt.stratified_medium_from_samples(1.3 - 0.1 * y * y, y)
    scen = rt.scenario("vert")
    pos0 = np.stack([np.zeros(r), np.linspace(-0.5, 0.5, r)],
                    -1).astype(np.float32)
    theta0 = np.linspace(-0.3, 0.3, r).astype(np.float32)
    kw = dict(delta_s=0.01, steps=64, pos0=pos0, theta0=theta0,
              block_rays=128)
    out = fast_trace_sharded("op6", scen, med, mesh=mesh, stats=True, **kw)
    single = fast_trace("op6", scen, med, interpret=True, stats=True, **kw)
    np.testing.assert_array_equal(np.asarray(out.mom_count),
                                  np.asarray(single.mom_count))
    # interpret-mode XLA may fuse FMAs differently inside shard_map (the
    # fused-sharded pos test carries the same 1-ulp allowance)
    np.testing.assert_allclose(np.asarray(out.mom_mean),
                               np.asarray(single.mom_mean), rtol=3e-7)
    # m2 is the *residual* spread of a conserved invariant — pure rounding
    # noise (~1e-7 here) — so fusion-order differences move it at the
    # absolute rounding floor, not relatively
    np.testing.assert_allclose(np.asarray(out.mom_m2),
                               np.asarray(single.mom_m2),
                               rtol=1e-5, atol=1e-9)

    # non-stratified media keep the named contract
    with pytest.raises(ValueError, match="stats=True"):
        fast_trace_sharded("op6", rt.scenario("fisheye"),
                           rt.analytic_medium("fisheye"), mesh=mesh,
                           stats=True, **kw)
