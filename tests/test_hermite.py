"""Hermite node form == the source GridMedium spline."""
import numpy as np

import raytracing_tpu as rt
from raytracing_tpu.media.hermite import build_hermite_medium
from raytracing_tpu.media.spline import build_grid_medium


def test_hermite_equals_gridmedium_fisheye():
    scen = rt.scenario("fisheye")
    gm = build_grid_medium("fisheye", scen.box, dtype=np.float64)
    hm = build_hermite_medium(gm, dtype=np.float64)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1.5, 1.5, 512)
    y = rng.uniform(-1.5, 1.5, 512)
    n_g, (gx_g, gy_g) = gm.n_and_grad(x, y)
    n_h, (gx_h, gy_h) = hm.n_and_grad(x, y)
    np.testing.assert_allclose(np.asarray(n_h), np.asarray(n_g), atol=1e-12)
    np.testing.assert_allclose(np.asarray(gx_h), np.asarray(gx_g), atol=1e-10)
    np.testing.assert_allclose(np.asarray(gy_h), np.asarray(gy_g), atol=1e-10)


def test_hermite_clamps_like_fitpack():
    """Out-of-grid queries clamp to the boundary (fpbisp semantics)."""
    scen = rt.scenario("fisheye")
    gm = build_grid_medium("fisheye", scen.box, dtype=np.float64)
    hm = build_hermite_medium(gm, dtype=np.float64)
    x = np.array([-99.0, 99.0, 0.0])
    y = np.array([0.0, 99.0, -99.0])
    n_g, (gx_g, gy_g) = gm.n_and_grad(x, y)
    n_h, (gx_h, gy_h) = hm.n_and_grad(x, y)
    np.testing.assert_allclose(np.asarray(n_h), np.asarray(n_g), atol=1e-12)
    np.testing.assert_allclose(np.asarray(gx_h), np.asarray(gx_g), atol=1e-10)


def test_hermite_trace_matches_gridmedium():
    """Scan-engine trace through the Hermite form == through the cell form."""
    scen = rt.scenario("fisheye")
    gm = build_grid_medium("fisheye", scen.box, dtype=np.float64)
    hm = build_hermite_medium(gm, dtype=np.float64)
    div = 80
    pos0 = np.repeat(scen.pos0, 2, 0)
    theta0 = np.repeat(scen.theta0, 2)
    kw = dict(delta_s=2 * np.pi / div, divisor=div + 1, n_turns=1,
              mode="metrics", dtype=np.float64, pos0=pos0, theta0=theta0)
    a = rt.trace("op6", scen, gm, **kw)
    b = rt.trace("op6", scen, hm, **kw)
    np.testing.assert_allclose(np.asarray(b.final.pos),
                               np.asarray(a.final.pos), atol=1e-9)
