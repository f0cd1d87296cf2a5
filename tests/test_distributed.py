"""Ray-batch sharding over the virtual 8-device CPU mesh."""
import jax
import numpy as np

import raytracing_tpu as rt
from raytracing_tpu.parallel.distributed import (
    ray_batch_sharding, summarize_sharded, trace_sharded)
from raytracing_tpu.parallel.mesh import make_mesh
import pytest

# heavyweight module: segmented chains / sharded meshes / full sweeps /
# interpret-mode kernel parity.  Deselect with -m 'not slow' (CLAUDE.md).
pytestmark = pytest.mark.slow


def _batch(r):
    theta0 = np.full(r, np.pi / 2.0)
    pos0 = np.stack([np.ones(r), np.zeros(r)], -1)
    return pos0, theta0


def test_trace_sharded_matches_single_device():
    mesh = make_mesh(8)
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    div = 64
    ds = 2 * np.pi / div
    pos0, theta0 = _batch(64)
    sharded = trace_sharded("op1", scen, med, delta_s=ds, mesh=mesh,
                            pos0=pos0, theta0=theta0, divisor=div + 1,
                            n_turns=1, dtype=np.float64)
    single = rt.trace("op1", scen, med, delta_s=ds, divisor=div + 1,
                      n_turns=1, mode="metrics", dtype=np.float64,
                      pos0=pos0, theta0=theta0)
    np.testing.assert_allclose(np.asarray(sharded.final.pos),
                               np.asarray(single.final.pos), rtol=1e-12)
    # the result really is distributed over all 8 devices
    assert len(sharded.final.pos.sharding.device_set) == 8


def test_summarize_reduces_on_device():
    mesh = make_mesh(8)
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    div = 64
    ds = 2 * np.pi / div
    pos0, theta0 = _batch(64)
    res = trace_sharded("op1", scen, med, delta_s=ds, mesh=mesh,
                        pos0=pos0, theta0=theta0, divisor=div + 1,
                        n_turns=1, dtype=np.float64)
    s = summarize_sharded(res)
    assert s.rays == 64
    assert float(s.mean_closure_pct) < 1.0
    assert float(s.total_distance) > 0


def test_trace_sharded_rejects_indivisible_batch():
    mesh = make_mesh(8)
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    pos0, theta0 = _batch(63)
    try:
        trace_sharded("op1", scen, med, delta_s=0.1, mesh=mesh,
                      pos0=pos0, theta0=theta0, divisor=10, n_turns=1)
    except ValueError as e:
        assert "not divisible" in str(e)
    else:
        raise AssertionError("expected ValueError")


def test_mesh_sharding_helpers():
    from raytracing_tpu.parallel.mesh import (
        candidate_ray_sharding, ray_sharding, replicated, sweep_sharding)
    mesh = make_mesh(8)
    import jax.numpy as jnp
    a = jax.device_put(np.zeros((4, 16)), candidate_ray_sharding(mesh))
    assert len(a.sharding.device_set) == 8
    b = jax.device_put(np.zeros(16), ray_sharding(mesh))
    assert len(b.sharding.device_set) in (4, 8)  # rays axis extent
    c = jax.device_put(np.zeros(4), replicated(mesh))
    assert c.sharding.is_fully_replicated
    d = jax.device_put(np.zeros(8), sweep_sharding(mesh))
    assert not d.sharding.is_fully_replicated


def test_fast_trace_sharded_stratified():
    """The sampled production medium under shard_map over the CPU mesh."""
    from raytracing_tpu.engine.fast import fast_trace, fast_trace_sharded
    from raytracing_tpu.media.spline import build_stratified_medium
    mesh = make_mesh(8)
    scen = rt.scenario("interface")
    med = build_stratified_medium("interface", scen.box, dtype=np.float32)
    r = 8 * 128
    theta0 = np.resize(np.asarray(scen.theta0, np.float32), r)
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    sharded = fast_trace_sharded("op6", scen, med, delta_s=0.01,
                                 pos0=pos0, theta0=theta0, mesh=mesh,
                                 steps=200, block_rays=128, interpret=True)
    assert sharded.engine == "fused-strat-sharded"
    assert len(sharded.pos.sharding.device_set) == 8
    local = fast_trace("op6", scen, med, delta_s=0.01, steps=200,
                       pos0=pos0, theta0=theta0, block_rays=128)
    np.testing.assert_allclose(np.asarray(sharded.pos),
                               np.asarray(local.pos), atol=1e-6)


def test_fast_trace_sharded_custom_medium_correct_physics():
    """Regression: fast_trace_sharded used to silently trace the SCENARIO's
    analytic field for non-analytic media; a constant custom medium must
    produce straight rays, and grid media must trace their own tables."""
    import jax.numpy as jnp
    from raytracing_tpu.engine.fast import fast_trace_sharded
    from raytracing_tpu.media.medium import CustomMedium
    mesh = make_mesh(8)
    scen = rt.scenario("fisheye")
    const = CustomMedium(n_fn=lambda x, y: jnp.full_like(x, 2.0))
    r = 8 * 128
    pos0, theta0 = _batch(r)
    out = fast_trace_sharded("op1", scen, const, delta_s=0.01, mesh=mesh,
                             pos0=pos0, theta0=theta0, steps=36,
                             block_rays=128, interpret=True)
    assert out.engine == "fused-custom-sharded"
    # constant n -> straight line: x stays 1.0, y advances 36*0.01
    p = np.asarray(out.pos)
    np.testing.assert_allclose(p[:, 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(p[:, 1], 0.36, atol=1e-5)
    # 2-D grid media run the scan tier over the mesh (NOT silently
    # swapped for the analytic field — their tables are the spline)
    from raytracing_tpu.engine.fast import fast_trace
    from raytracing_tpu.media.hermite import build_hermite_medium
    from raytracing_tpu.media.spline import build_grid_medium
    hm = build_hermite_medium(build_grid_medium("fisheye", scen.box,
                                                dtype=np.float32))
    g = fast_trace_sharded("op1", scen, hm, delta_s=0.01, mesh=mesh,
                           pos0=pos0, theta0=theta0, steps=8,
                           block_rays=128, interpret=True)
    assert g.engine == "scan-sharded"
    single = fast_trace("op1", scen, hm, delta_s=0.01, pos0=pos0,
                        theta0=theta0, steps=8)
    np.testing.assert_array_equal(np.asarray(g.pos), np.asarray(single.pos))
