"""Generic fused Pallas kernels vs the jnp engine (interpret mode, CPU)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import raytracing_tpu as rt
from raytracing_tpu.kernels.fused import FUSED_OPS, fused_trace_final


@pytest.mark.parametrize("op", FUSED_OPS)
def test_fused_fisheye_matches_engine(op):
    R = 256
    div = 101
    ds = np.float32(2 * np.pi / div)
    theta0 = np.full(R, np.pi / 2.0, np.float32)
    pos0 = np.stack([np.ones(R), np.zeros(R)], -1).astype(np.float32)
    scen = rt.scenario("fisheye")

    pos, _tang, tt, dsim, act, *_ = fused_trace_final(
        pos0, theta0, ds, field="fisheye", op=op, steps=div,
        box=tuple(scen.box), block_rays=256, interpret=True)

    med = rt.analytic_medium("fisheye")
    res = rt.trace(op, scen, med, delta_s=ds, max_size=div + 1,
                   mode="metrics", dtype=np.float32, pos0=pos0, theta0=theta0)
    # op7's 11a-18b+9c-2d combination of near-equal positions amplifies
    # float32 rounding; the float64 truth lies between kernel and engine.
    np.testing.assert_allclose(np.asarray(pos), np.asarray(res.final.pos),
                               atol=2e-4 if op == "op7" else 1e-5)
    np.testing.assert_allclose(np.asarray(tt), np.asarray(res.final.traveltime),
                               atol=5e-5)
    assert np.all(np.asarray(act))


@pytest.mark.parametrize("op", ["op6", "op8"])
def test_fused_vert_boundary_exit_matches_engine(op):
    """Rays leave the shrunken box at different steps; the fused kernel's
    freeze mask must reproduce the engine's masked early exit exactly."""
    scen = dataclasses.replace(rt.scenario("vert"),
                               box=(-2.0, -1.0, -2.5, -1.5), s_max=3.0)
    med = rt.analytic_medium("vert_heterogeneous")
    ds = np.float32(0.05)
    steps = scen.max_size(float(ds)) - 1
    r0 = scen.ray_count
    pad = (-r0) % 128
    pos0 = np.concatenate([scen.pos0, np.tile(scen.pos0[-1:], (pad, 1))]).astype(np.float32)
    theta0 = np.concatenate([scen.theta0, np.tile(scen.theta0[-1:], pad)]).astype(np.float32)

    pos, _tang, tt, dsim, act, *_ = fused_trace_final(
        pos0, theta0, ds, field="vert_heterogeneous", op=op, steps=steps,
        box=tuple(scen.box), block_rays=128, interpret=True)

    res = rt.trace(op, scen, med, delta_s=float(ds), mode="metrics",
                   dtype=np.float32, pos0=pos0, theta0=theta0)
    np.testing.assert_allclose(np.asarray(pos)[:r0],
                               np.asarray(res.final.pos)[:r0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(dsim)[:r0],
                               np.asarray(res.final.dist_sim)[:r0], atol=1e-4)
    # every ray exits the tiny box in both implementations
    assert not np.any(np.asarray(act)[:r0])
    assert np.all(np.asarray(res.exit_step)[:r0] < steps)


def test_fused_interface_matches_engine():
    scen = dataclasses.replace(rt.scenario("interface"), s_max=5.0)
    med = rt.analytic_medium("interface")
    ds = np.float32(0.02)
    steps = scen.max_size(float(ds)) - 1
    r0 = scen.ray_count
    pad = (-r0) % 128
    pos0 = np.concatenate([scen.pos0, np.tile(scen.pos0[-1:], (pad, 1))]).astype(np.float32)
    theta0 = np.concatenate([scen.theta0, np.tile(scen.theta0[-1:], pad)]).astype(np.float32)
    pos, _tang, tt, dsim, act, *_ = fused_trace_final(
        pos0, theta0, ds, field="interface", op="op6", steps=steps,
        box=tuple(scen.box), block_rays=128, interpret=True)
    res = rt.trace("op6", scen, med, delta_s=float(ds), mode="metrics",
                   dtype=np.float32, pos0=pos0, theta0=theta0)
    np.testing.assert_allclose(np.asarray(pos)[:r0],
                               np.asarray(res.final.pos)[:r0], atol=2e-4)
    np.testing.assert_allclose(np.asarray(tt)[:r0],
                               np.asarray(res.final.traveltime)[:r0], atol=2e-4)


def test_fused_rejects_unsupported():
    pos0 = np.zeros((128, 2), np.float32)
    theta0 = np.zeros(128, np.float32)
    with pytest.raises(ValueError, match="supports ops"):
        fused_trace_final(pos0, theta0, 0.1, field="fisheye", op="op5",
                          steps=3, box=(-1, 1, -1, 1), block_rays=128,
                          interpret=True)
    with pytest.raises(ValueError, match="supports fields"):
        fused_trace_final(pos0, theta0, 0.1, field="warp", op="op1",
                          steps=3, box=(-1, 1, -1, 1), block_rays=128,
                          interpret=True)


def test_step_limit_freeze_does_not_phantom_exit():
    """A ray frozen by the traced step_limit must stay active even when its
    phantom (masked) next step would cross the box boundary."""
    import jax.numpy as jnp
    from raytracing_tpu.kernels.fused import fused_trace_final

    r = 128
    pos0 = np.tile(np.array([[17.0, 1.0]], np.float32), (r, 1))
    theta0 = np.zeros(r, np.float32)  # heading +x toward the x=20 wall
    ds = 2.0
    box = (-2.0, 20.0, -2.0, 4.0)
    pos, _tang, _tt, _dsim, act, *_ = fused_trace_final(
        pos0, theta0, jnp.float32(ds), field="interface", op="op1",
        steps=4, box=box, block_rays=128, interpret=True,
        step_limit=jnp.float32(1.0))
    # frozen at x=19 (inside); phantom step to x=21 must not deactivate
    np.testing.assert_allclose(np.asarray(pos)[:, 0], 19.0, atol=1e-3)
    assert bool(np.all(np.asarray(act)))


def _strat_setup(field, scen_name, r=128):
    import raytracing_tpu as rt
    from raytracing_tpu.media.spline import build_stratified_medium
    scen = rt.scenario(scen_name)
    med = build_stratified_medium(field, scen.box, dtype=np.float32)
    theta0 = np.linspace(scen.theta0[0], scen.theta0[-1], r).astype(np.float32)
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    return scen, med, pos0, theta0


@pytest.mark.parametrize("op", ["op1", "op2", "op3", "op4", "op6", "op7",
                                "op8", "op12"])
def test_strat_kernel_matches_scan_engine_interface(op):
    """The table-gather kernel equals the scan engine on the sampled
    stratified interface medium (the reference's production medium for
    x-independent fields, RT_bench.py:435-464)."""
    import raytracing_tpu as rt
    from raytracing_tpu.kernels.fused import fused_trace_final_strat
    scen, med, pos0, theta0 = _strat_setup("interface", "interface")
    ds, steps = 0.01, 400
    pos, _tang, tt, dsim, act, *_ = fused_trace_final_strat(
        jnp.asarray(pos0), jnp.asarray(theta0), jnp.float32(ds), med,
        op=op, steps=steps, box=tuple(scen.box), block_rays=128,
        interpret=True)
    res = rt.trace(op, scen, med, delta_s=ds, mode="metrics",
                   dtype=np.float32, max_size=steps + 1,
                   pos0=pos0, theta0=theta0)
    # op7's backward-difference combination amplifies f32 noise; cell-edge
    # crossings at slightly different f32 positions add table-value jitter
    atol = 2e-2 if op == "op7" else 2e-4
    np.testing.assert_allclose(np.asarray(pos), np.asarray(res.final.pos),
                               atol=atol)
    np.testing.assert_allclose(np.asarray(tt),
                               np.asarray(res.final.traveltime), atol=atol)
    # kernel active == "never left the box" == scan's exit_step at limit
    np.testing.assert_array_equal(np.asarray(act),
                                  np.asarray(res.exit_step) == steps)


def test_strat_kernel_vert_and_exits():
    """Vert medium (full-range table, multiple lane chunks) + box exits."""
    import dataclasses
    import raytracing_tpu as rt
    from raytracing_tpu.kernels.fused import fused_trace_final_strat
    from raytracing_tpu.media.spline import build_stratified_medium
    scen = rt.scenario("vert")
    scen = dataclasses.replace(scen, box=(-2.0, 5.0, -2.5, 0.2))
    med = build_stratified_medium("vert_heterogeneous", scen.box,
                                  dtype=np.float32)
    r = 128
    theta0 = np.linspace(scen.theta0[0], scen.theta0[-1], r).astype(np.float32)
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    ds, steps = 0.05, 120
    pos, _tang, tt, dsim, act, *_ = fused_trace_final_strat(
        jnp.asarray(pos0), jnp.asarray(theta0), jnp.float32(ds), med,
        op="op8", steps=steps, box=tuple(scen.box), block_rays=128,
        interpret=True)
    res = rt.trace("op8", scen, med, delta_s=ds, mode="metrics",
                   dtype=np.float32, max_size=steps + 1,
                   pos0=pos0, theta0=theta0)
    np.testing.assert_allclose(np.asarray(pos), np.asarray(res.final.pos),
                               atol=2e-4)
    np.testing.assert_array_equal(np.asarray(act),
                                  np.asarray(res.exit_step) == steps)
    assert 0 < np.asarray(act).sum() < r  # some rays exited, some survived


def test_fast_trace_routes_stratified_to_kernel():
    import raytracing_tpu as rt
    from raytracing_tpu.engine.fast import fast_trace
    scen, med, pos0, theta0 = _strat_setup("interface", "interface")
    out = fast_trace("op6", scen, med, delta_s=0.01, steps=200,
                     pos0=pos0, theta0=theta0, block_rays=128)
    # exit scenarios default to segmented block skipping
    assert out.engine == "fused-strat-seg-skip"
    assert np.all(np.isfinite(np.asarray(out.pos)))


def test_tangent_and_welford_stats_match_scan():
    """Final tangent == scan engine's exit angle; in-kernel Welford momentum
    stats == the scan carry's tracker (vert scenario, gamma=1)."""
    import raytracing_tpu as rt
    from raytracing_tpu.engine import oracles
    scen = rt.scenario("vert")
    med = rt.analytic_medium("vert_heterogeneous")
    r = 128
    theta0 = np.linspace(0.1, np.pi / 2 - 0.1, r).astype(np.float32)
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    ds, steps = 0.01, 300
    f = fused_trace_final(jnp.asarray(pos0), jnp.asarray(theta0),
                          jnp.float32(ds), field="vert_heterogeneous",
                          op="op8", steps=steps, box=tuple(scen.box),
                          block_rays=128, interpret=True, with_stats=True)
    res = rt.trace("op8", scen, med, delta_s=ds, mode="metrics",
                   dtype=np.float32, max_size=steps + 1,
                   pos0=pos0, theta0=theta0)
    tang_ref = np.stack([np.cos(np.asarray(res.final.angle)),
                         np.sin(np.asarray(res.final.angle))], -1)
    np.testing.assert_allclose(np.asarray(f.tangent), tang_ref, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(f.mom_count),
                                  np.asarray(res.final.mom_count))
    np.testing.assert_allclose(np.asarray(f.mom_mean),
                               np.asarray(res.final.mom_mean), rtol=2e-4)
    cv_kernel = 100.0 * np.sqrt(np.asarray(f.mom_m2) / np.asarray(f.mom_count)) \
        / np.asarray(f.mom_mean)
    cv_scan = np.asarray(oracles.momentum_cv_pct_from_stats(res))
    # CVs at this step size are f32 noise floor (~1e-5 %); the oracle
    # threshold is 5e-2 %, so agreement to 5e-3 is decisive
    np.testing.assert_allclose(cv_kernel, cv_scan, atol=5e-3)
