"""op12 (joint RK4): order of convergence and north-star RMS accuracy."""
import numpy as np
import pytest

import raytracing_tpu as rt
from raytracing_tpu.engine import oracles
from raytracing_tpu.kernels.fused import fused_trace_final


def _rms(div, dtype=np.float64, op="op12"):
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    ds = 2 * np.pi / div
    res = rt.trace(op, scen, med, delta_s=ds, max_size=div + 1, dtype=dtype,
                   pos0=np.repeat(scen.pos0, 2, 0),
                   theta0=np.repeat(scen.theta0, 2))
    return oracles.fisheye_rms_error(res, ds)


def test_rk4_meets_north_star_rms():
    """North star: RMS trajectory error <= 1e-6 vs the analytic circle."""
    assert _rms(300) < 1e-6


def test_rk4_fourth_order_convergence():
    r1, r2 = _rms(100), _rms(200)
    order = np.log2(r1 / r2)
    assert 3.5 < order < 4.5, (r1, r2, order)


def test_rk4_much_more_accurate_than_reference_best():
    """At the same step, RK4 beats the reference's 2nd-order methods by
    orders of magnitude."""
    assert _rms(300) < _rms(300, op="op8") / 100


def test_rk4_fused_kernel_matches_engine():
    scen = rt.scenario("fisheye")
    div = 301
    ds = np.float32(2 * np.pi / div)
    R = 256
    theta0 = np.full(R, np.pi / 2.0, np.float32)
    pos0 = np.stack([np.ones(R), np.zeros(R)], -1).astype(np.float32)
    pos, _tang, tt, dsim, act, *_ = fused_trace_final(
        pos0, theta0, ds, field="fisheye", op="op12", steps=div,
        box=tuple(scen.box), block_rays=256, interpret=True)
    med = rt.analytic_medium("fisheye")
    res = rt.trace("op12", scen, med, delta_s=float(ds), max_size=div + 1,
                   mode="metrics", dtype=np.float32, pos0=pos0, theta0=theta0)
    # truncation is ~1e-9 here; the difference is two float32 rounding paths
    # (the kernel's Kahan+rotation carry is the *more* accurate of the two)
    np.testing.assert_allclose(np.asarray(pos), np.asarray(res.final.pos),
                               atol=1e-4)


def test_rk4_fused_kernel_f32_closure_is_roundoff_limited():
    """In float32 with Kahan positions the fused RK4 closure error is at the
    rounding floor, far below any truncation scale."""
    scen = rt.scenario("fisheye")
    div = 1000
    ds = np.float32(2 * np.pi / div)
    R = 256
    theta0 = np.full(R, np.pi / 2.0, np.float32)
    pos0 = np.stack([np.ones(R), np.zeros(R)], -1).astype(np.float32)
    pos, *_ = fused_trace_final(
        pos0, theta0, ds, field="fisheye", op="op12", steps=div,
        box=tuple(scen.box), block_rays=256, interpret=True)
    closure = np.linalg.norm(np.asarray(pos)[0] - [1, 0])
    # ~2.6e-5 observed: pure float32 rounding accumulation — RK4 truncation
    # at this step is ~1e-11, and op8's truncation alone would be ~4e-5.
    assert closure < 1e-4, closure
