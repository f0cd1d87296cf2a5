"""Chunk-streamed history equals one-shot history."""
import dataclasses

import numpy as np

import raytracing_tpu as rt
from raytracing_tpu.engine.streaming import stream_history
import pytest

# heavyweight module: segmented chains / sharded meshes / full sweeps /
# interpret-mode kernel parity.  Deselect with -m 'not slow' (CLAUDE.md).
pytestmark = pytest.mark.slow


def test_streamed_equals_oneshot_fisheye():
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    div = 100
    ds = 2 * np.pi / div
    pos0 = np.repeat(scen.pos0, 2, 0)
    theta0 = np.repeat(scen.theta0, 2)
    chunks = list(stream_history("op6", scen, med, delta_s=ds, divisor=div + 1,
                                 n_turns=1, chunk=17, dtype=np.float64,
                                 pos0=pos0, theta0=theta0))
    streamed = np.concatenate(chunks, axis=0)
    ref = rt.trace("op6", scen, med, delta_s=ds, divisor=div + 1, n_turns=1,
                   dtype=np.float64, pos0=pos0, theta0=theta0)
    np.testing.assert_allclose(streamed, np.asarray(ref.history), atol=0)


def test_streamed_equals_oneshot_vert_with_exits():
    scen = dataclasses.replace(rt.scenario("vert"),
                               box=(-2.0, -1.0, -2.5, -1.5), s_max=3.0)
    med = rt.analytic_medium("vert_heterogeneous")
    chunks = list(stream_history("op8", scen, med, delta_s=0.05, chunk=13,
                                 dtype=np.float64))
    streamed = np.concatenate(chunks, axis=0)
    ref = rt.trace("op8", scen, med, delta_s=0.05, dtype=np.float64)
    np.testing.assert_allclose(streamed, np.asarray(ref.history), atol=0)


def test_streamed_equals_oneshot_op7_window_ramp():
    """op7's order ramp keys off the *global* step index; chunk=2 forces
    segment restarts inside the priming region (steps 1 and 2)."""
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    div = 60
    ds = 2 * np.pi / div
    pos0 = np.repeat(scen.pos0, 2, 0)
    theta0 = np.repeat(scen.theta0, 2)
    chunks = list(stream_history("op7", scen, med, delta_s=ds, divisor=div + 1,
                                 n_turns=1, chunk=2, dtype=np.float64,
                                 pos0=pos0, theta0=theta0))
    streamed = np.concatenate(chunks, axis=0)
    ref = rt.trace("op7", scen, med, delta_s=ds, divisor=div + 1, n_turns=1,
                   dtype=np.float64, pos0=pos0, theta0=theta0)
    np.testing.assert_allclose(streamed, np.asarray(ref.history), atol=0)


def test_all_eleven_ops_stream():
    """Every reference step method can stream."""
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    div = 24
    ds = 2 * np.pi / div
    pos0 = np.repeat(scen.pos0, 2, 0)
    theta0 = np.repeat(scen.theta0, 2)
    for op in [f"op{i}" for i in range(1, 12)]:
        chunks = list(stream_history(op, scen, med, delta_s=ds,
                                     divisor=div + 1, n_turns=1, chunk=7,
                                     dtype=np.float64,
                                     pos0=pos0, theta0=theta0))
        streamed = np.concatenate(chunks, axis=0)
        ref = rt.trace(op, scen, med, delta_s=ds, divisor=div + 1, n_turns=1,
                       dtype=np.float64, pos0=pos0, theta0=theta0)
        np.testing.assert_allclose(streamed, np.asarray(ref.history), atol=0,
                                   err_msg=op)


def test_trace_chunked_matches_oneshot_metrics():
    """Bounded-compile chunked scan == one-shot metrics trace, incl.
    exit_step bookkeeping across segment re-arms (grid medium, exits)."""
    import dataclasses
    from raytracing_tpu.engine.streaming import trace_chunked
    from raytracing_tpu.media.spline import build_grid_medium
    scen = dataclasses.replace(rt.scenario("vert"), box=(-2.0, 5.0, -2.5, 0.0))
    med = build_grid_medium("vert_heterogeneous", scen.box, dtype=np.float64)
    kw = dict(delta_s=0.05, dtype=np.float64)
    one = rt.trace("op8", scen, med, mode="metrics", **kw)
    chk = trace_chunked("op8", scen, med, chunk=13, **kw)
    np.testing.assert_array_equal(np.asarray(chk.final.pos),
                                  np.asarray(one.final.pos))
    np.testing.assert_array_equal(np.asarray(chk.exit_step),
                                  np.asarray(one.exit_step))
    np.testing.assert_array_equal(np.asarray(chk.final.traveltime),
                                  np.asarray(one.final.traveltime))
    assert 0 < np.asarray(one.exit_step).min() < np.asarray(one.exit_step).max()


def test_trace_chunked_fisheye_grid():
    """The 2-D sampled-spline medium through bounded scans (the
    bounded-compile path for the reference's production medium)."""
    from raytracing_tpu.engine.streaming import trace_chunked
    from raytracing_tpu.media.spline import build_grid_medium
    scen = rt.scenario("fisheye")
    med = build_grid_medium("fisheye", scen.box, dtype=np.float32)
    div = 100
    pos0 = np.repeat(scen.pos0, 2, 0)
    theta0 = np.repeat(scen.theta0, 2)
    res = trace_chunked("op1", scen, med, delta_s=2 * np.pi / div,
                        divisor=div + 1, n_turns=1, chunk=32,
                        dtype=np.float32, pos0=pos0, theta0=theta0)
    clo = 100 * np.linalg.norm(np.asarray(res.final.pos)[0] - [1, 0]) / (2 * np.pi)
    assert clo < 1.0, clo
