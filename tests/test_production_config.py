"""Production-dtype (x32) coverage of the hot paths.

The whole suite runs under conftest's forced ``jax_enable_x64=True`` so the
float64 mirror can be exact — but production (bench.py, serving, fast_trace
on the GPU) runs with x64 OFF, where integer widening and weak-type
promotion behave differently (e.g. ``astype(int64)`` silently truncates to
int32).  These tests re-run the production entry points
under ``jax.enable_x64(False)`` and check them against their x64-config
twins at f32 tolerance.  Everything here is interpret-mode CPU; compute is
f32 in BOTH configs (the engines pin their dtypes), so results should agree
closely — the assertion is about config-sensitivity, not precision.
"""
import jax
import numpy as np
import pytest

import raytracing_tpu as rt
from raytracing_tpu.engine.fast import fast_trace

pytestmark = pytest.mark.slow


def _fisheye_batch(r):
    pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (r, 1))
    theta0 = (np.pi / 2 + np.linspace(-0.02, 0.02, r)).astype(np.float32)
    return pos0, theta0


def test_fast_trace_analytic_matches_across_configs():
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    pos0, theta0 = _fisheye_batch(64)
    kw = dict(delta_s=2 * np.pi / 64, pos0=pos0, theta0=theta0,
              steps=64, block_rays=1024, interpret=True)
    ref = fast_trace("op1", scen, med, **kw)
    with jax.enable_x64(False):
        got = fast_trace("op1", scen, med, **kw)
    assert np.all(np.isfinite(np.asarray(got.pos)))
    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(ref.pos),
                               atol=1e-6)


def test_grid_tiled_matches_across_configs():
    """The 2-D grid medium's production path (the scan tier under
    fast_trace) gives the same rays with x64 on and off."""
    from raytracing_tpu.media.hermite import build_hermite_medium
    from raytracing_tpu.media.spline import build_grid_medium

    scen = rt.scenario("fisheye")
    hm = build_hermite_medium(
        build_grid_medium("fisheye", scen.box, dtype=np.float32))
    pos0, theta0 = _fisheye_batch(1024)
    kw = dict(delta_s=np.float32(2 * np.pi / 303), pos0=pos0, theta0=theta0,
              steps=48)
    ref = fast_trace("op1", scen, hm, **kw)
    with jax.enable_x64(False):
        got = fast_trace("op1", scen, hm, **kw)
    assert got.engine == ref.engine == "scan"
    assert np.all(np.isfinite(np.asarray(got.pos)))
    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(ref.pos),
                               atol=1e-6)


def test_golden_aniso_kernel_across_configs():
    from raytracing_tpu.kernels.golden import golden_trace_final

    scen = rt.scenario("aniso")
    r = 1024
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    theta0 = np.resize(np.asarray(scen.theta0, np.float32), r)
    kw = dict(field="vert_heterogeneous", op="op10", steps=64,
              box=tuple(scen.box), block_rays=1024, interpret=True)
    ref = golden_trace_final(pos0, theta0, np.float32(0.01),
                             np.float32(scen.gamma), **kw)
    with jax.enable_x64(False):
        got = golden_trace_final(pos0, theta0, np.float32(0.01),
                                 np.float32(scen.gamma), **kw)
    assert np.all(np.isfinite(np.asarray(got.pos)))
    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(ref.pos),
                               atol=1e-6)


def test_scan_sweep_selection_across_configs():
    from raytracing_tpu.parallel.sweep import delta_s_search

    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    divisors = np.array([40.0, 32.0, 24.0, 16.0])
    kw = dict(n_turns=1, engine="scan", rays=8, divisors=divisors)
    ref = delta_s_search("op1", scen, med, **kw)
    with jax.enable_x64(False):
        got = delta_s_search("op1", scen, med, **kw)
    assert got.index == ref.index
    assert got.metrics.keys() == ref.metrics.keys()
    for k in ref.metrics:
        np.testing.assert_allclose(got.metrics[k], ref.metrics[k], rtol=1e-4)


def test_segmented_skip_frozen_across_configs():
    from raytracing_tpu.engine.segmented import segmented_trace

    scen = rt.scenario("interface")
    r = 1024
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    theta0 = np.sort(np.resize(np.asarray(scen.theta0, np.float32), r))
    kw = dict(steps=96, box=tuple(scen.box), field="interface", segment=32,
              block_rays=1024, interpret=True, skip_frozen=True)
    ref = segmented_trace("op6", pos0, theta0, np.float32(0.02), **kw)
    with jax.enable_x64(False):
        got = segmented_trace("op6", pos0, theta0, np.float32(0.02), **kw)
    assert np.all(np.isfinite(np.asarray(got.pos)))
    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(ref.pos),
                               atol=1e-6)
