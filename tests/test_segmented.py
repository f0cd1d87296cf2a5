"""Segmented (resumable-kernel) tracing == one-shot kernels; compaction."""
import jax.numpy as jnp
import numpy as np
import pytest

import raytracing_tpu as rt
from raytracing_tpu.engine.segmented import segmented_trace
from raytracing_tpu.kernels.fused import fused_trace_final

# heavyweight module: segmented chains / sharded meshes / full sweeps /
# interpret-mode kernel parity.  Deselect with -m 'not slow' (CLAUDE.md).
pytestmark = pytest.mark.slow


def _fan(scen, r):
    theta0 = np.linspace(scen.theta0[0], scen.theta0[-1], r).astype(np.float32)
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    return pos0, theta0


@pytest.mark.parametrize("op", ["op1", "op6", "op7", "op12"])
def test_segmented_equals_oneshot(op):
    """Chained resumable segments reproduce the one-shot kernel bit-for-bit
    (full state incl. Kahan compensations and the op7 window rides along)."""
    scen = rt.scenario("fisheye")
    r = 128
    pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (r, 1))
    theta0 = np.full(r, np.pi / 2.0, np.float32)
    ds, steps = np.float32(2 * np.pi / 100), 230
    one = fused_trace_final(jnp.asarray(pos0), jnp.asarray(theta0), ds,
                            field="fisheye", op=op, steps=steps,
                            box=tuple(scen.box), block_rays=128,
                            interpret=True)
    seg = segmented_trace(op, pos0, theta0, ds, steps=steps,
                          box=tuple(scen.box), field="fisheye", segment=37,
                          block_rays=128, interpret=True)
    np.testing.assert_array_equal(np.asarray(seg.pos), np.asarray(one.pos))
    np.testing.assert_array_equal(np.asarray(seg.traveltime),
                                  np.asarray(one.traveltime))
    np.testing.assert_array_equal(np.asarray(seg.tangent),
                                  np.asarray(one.tangent))


def test_segmented_with_stats_and_strat():
    from raytracing_tpu.media.spline import build_stratified_medium
    scen = rt.scenario("vert")
    med = build_stratified_medium("vert_heterogeneous", scen.box,
                                  dtype=np.float32)
    pos0, theta0 = _fan(scen, 128)
    from raytracing_tpu.kernels.fused import fused_trace_final_strat
    ds, steps = np.float32(0.02), 150
    one = fused_trace_final_strat(jnp.asarray(pos0), jnp.asarray(theta0), ds,
                                  med, op="op8", steps=steps,
                                  box=tuple(scen.box), block_rays=128,
                                  interpret=True, with_stats=True)
    seg = segmented_trace("op8", pos0, theta0, ds, steps=steps,
                          box=tuple(scen.box), medium=med, segment=40,
                          block_rays=128, interpret=True, with_stats=True)
    np.testing.assert_array_equal(np.asarray(seg.pos), np.asarray(one.pos))
    np.testing.assert_array_equal(np.asarray(seg.mom_mean),
                                  np.asarray(one.mom_mean))
    np.testing.assert_array_equal(np.asarray(seg.mom_m2),
                                  np.asarray(one.mom_m2))


def test_compaction_preserves_results():
    """Live-ray compaction must not change any ray's final state.  Shrunken
    vert box makes most rays exit early at staggered times."""
    import dataclasses
    scen = dataclasses.replace(rt.scenario("vert"), box=(-2.0, 5.0, -2.5, 0.0))
    pos0, theta0 = _fan(scen, 256)
    ds, steps = np.float32(0.05), 100
    plain = segmented_trace("op8", pos0, theta0, ds, steps=steps,
                            box=tuple(scen.box), field="vert_heterogeneous",
                            segment=16, block_rays=128, interpret=True)
    comp = segmented_trace("op8", pos0, theta0, ds, steps=steps,
                           box=tuple(scen.box), field="vert_heterogeneous",
                           segment=16, block_rays=128, interpret=True,
                           compact=True, compact_every=2,
                           compact_threshold=0.9)
    assert 0 < np.asarray(plain.active).sum() < 256  # staggered exits happened
    np.testing.assert_array_equal(np.asarray(comp.pos), np.asarray(plain.pos))
    np.testing.assert_array_equal(np.asarray(comp.traveltime),
                                  np.asarray(plain.traveltime))
    np.testing.assert_array_equal(np.asarray(comp.active),
                                  np.asarray(plain.active))


def test_skip_frozen_bit_identical():
    """Per-program liveness skipping (pl.when bypass of all-frozen
    programs) changes nothing but the wasted work: results are bit-identical to the
    plain segmented run, on an exit-ordered interface fan where most
    blocks freeze early (RT_bench.py:878-879's loop break, device-side)."""
    scen = rt.scenario("interface")
    r = 1024
    theta_v = np.asarray(scen.theta0, np.float32)
    theta0 = np.repeat(theta_v, -(-r // len(theta_v)))[:r].astype(np.float32)
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    kw = dict(steps=1200, box=tuple(scen.box), field="interface",
              segment=128, block_rays=128, interpret=True, with_stats=True)
    a = segmented_trace("op6", pos0, theta0, np.float32(0.02), **kw)
    b = segmented_trace("op6", pos0, theta0, np.float32(0.02),
                        skip_frozen=True, **kw)
    assert not np.asarray(a.active).any()   # every ray exited: skip engaged
    for fa, fb in zip(a, b):
        if fa is not None:
            np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_golden_segmented_equals_oneshot():
    """The golden family through segmented_trace (resume + skip + compact)
    reproduces the one-shot golden kernel bit-for-bit under the parity
    bracket schedule, incl. the Welford anisotropic-momentum stats
    (gamma=3, RT_bench.py:702-764).  The production (polished) schedule
    carries the tangent by rotation and resets it per segment, so it is
    checked separately at rotation-drift tolerance."""
    from raytracing_tpu.config import golden_iters
    from raytracing_tpu.kernels.golden import golden_trace_final
    scen = rt.scenario("aniso")
    r = 512
    theta_v = np.linspace(0.1, 1.4, 32).astype(np.float32)
    theta0 = np.repeat(theta_v, r // 32).astype(np.float32)
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    ds, steps = 0.0193, 700
    parity = (golden_iters(np.float32), 0)
    one = golden_trace_final(pos0, theta0, np.float32(ds), np.float32(3.0),
                             field="vert_heterogeneous", op="op11",
                             steps=steps, box=tuple(scen.box),
                             block_rays=128, interpret=True, with_stats=True,
                             polish=0)
    one_pol = golden_trace_final(pos0, theta0, np.float32(ds),
                                 np.float32(3.0),
                                 field="vert_heterogeneous", op="op11",
                                 steps=steps, box=tuple(scen.box),
                                 block_rays=128, interpret=True,
                                 with_stats=True)
    for kw in (dict(), dict(skip_frozen=True), dict(compact=True)):
        seg_pol = segmented_trace("op11", pos0, theta0, np.float32(ds),
                                  steps=steps, box=tuple(scen.box),
                                  field="vert_heterogeneous", segment=128,
                                  block_rays=128, interpret=True,
                                  with_stats=True, gamma=3.0, **kw)
        np.testing.assert_allclose(np.asarray(one_pol.pos),
                                   np.asarray(seg_pol.pos), atol=1e-4)
        seg = segmented_trace("op11", pos0, theta0, np.float32(ds),
                              steps=steps, box=tuple(scen.box),
                              field="vert_heterogeneous", segment=128,
                              block_rays=128, interpret=True,
                              with_stats=True, gamma=3.0,
                              gold_schedule=parity, **kw)
        np.testing.assert_array_equal(np.asarray(one.pos),
                                      np.asarray(seg.pos))
        # m2 rides the Welford update `m2 + delta*(x - mean)` — one-shot and
        # resume kernels are different HLO programs, so XLA's FMA
        # contraction of that expression may differ by an ulp; positions,
        # counts and means stay bit-identical (asserted exactly)
        np.testing.assert_allclose(np.asarray(one.mom_m2),
                                   np.asarray(seg.mom_m2), rtol=1e-3,
                                   atol=1e-12)
        np.testing.assert_array_equal(np.asarray(one.mom_count),
                                      np.asarray(seg.mom_count))
        np.testing.assert_array_equal(np.asarray(one.mom_mean),
                                      np.asarray(seg.mom_mean))
        np.testing.assert_array_equal(np.asarray(one.dist_sim),
                                      np.asarray(seg.dist_sim))
