"""Dynamic ray tracing tier: spreading, KMAH caustics, amplitudes.

Oracles, strongest first:

* homogeneous medium — q(s) == s EXACTLY (the jvp tangent of straight-line
  stepping is the straight-line tangent), so TL(s) == 10 log10 s;
* Maxwell fisheye — perfect imaging: every ray from a point source passes
  through the antipodal image, so q has a zero (a caustic, KMAH +1) there
  and again at the source after a full orbit (RT_bench.py:110-112 field);
* finite differences — q must equal the central difference of two
  kinematic traces at theta0 +- eps, on the SAMPLED spline medium too
  (exercises jvp through the gather/Hermite evaluation, i.e. the live
  replacement for the reference's dead Hessian splines, RT_bench.py:459-462).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import raytracing_tpu as rt
from raytracing_tpu.engine.dynamic import (DYN_COLS, spreading_amplitude,
                                           trace_dynamic,
                                           transmission_loss_db)
from raytracing_tpu.engine.trace import trace
from raytracing_tpu.media.medium import CustomMedium

F64 = np.float64


def _homog():
    return CustomMedium(lambda x, y: jnp.ones_like(x) + 0.0 * y)


def test_homogeneous_spreading_exact():
    """Straight rays: q(s) = s, dtheta = 1, no caustics, TL = 10 log10 s."""
    scen = rt.scenario("interface")
    res = trace_dynamic("op1", scen, _homog(), delta_s=0.05, dtype=F64,
                        pos0=np.zeros((3, 2)),
                        theta0=np.array([0.3, 0.8, 1.2]))
    s = np.asarray(res.dist_real)
    assert s.min() > 1.0  # rays actually travelled before exiting the box
    np.testing.assert_allclose(np.asarray(res.q), s, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.dtheta), 1.0, atol=1e-12)
    assert np.all(np.asarray(res.kmah) == 0)
    np.testing.assert_allclose(np.asarray(res.transmission_loss_db()),
                               10 * np.log10(s), atol=1e-10)
    # unit-pressure normalization: A == 1 one arc-length unit from the source
    a1 = spreading_amplitude(jnp.asarray(1.0), jnp.asarray(1.0),
                             jnp.asarray(1.0))
    assert float(a1) == pytest.approx(1.0)


def test_second_order_stepper_matches():
    """op6 (2nd-order Taylor) carries the same exact tangent structure."""
    scen = rt.scenario("interface")
    res = trace_dynamic("op6", scen, _homog(), delta_s=0.05, dtype=F64,
                        pos0=np.zeros((2, 2)), theta0=np.array([0.4, 1.0]))
    np.testing.assert_allclose(np.asarray(res.q), np.asarray(res.dist_real),
                               atol=1e-12)


def test_fisheye_refocus_caustic_and_kmah():
    """Perfect imaging: caustic at the antipode, refocus at the source.

    The theta0 = pi/2 ray from (1, 0) is the unit circle; the image point
    (-1, 0) sits at arc length pi and the source again at 2 pi.  q must
    cross zero once near step divisor/2 (KMAH 1) and return to ~0 at the
    end of the turn without completing the second crossing.
    """
    div = 600
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    res = trace_dynamic("op6", scen, med, delta_s=2 * np.pi / div,
                        divisor=div + 1, n_turns=1, dtype=F64,
                        pos0=np.array([[1.0, 0.0]] * 2),
                        theta0=np.array([np.pi / 2, np.pi / 2 + 0.3]))
    h = np.asarray(res.history)
    q_col = DYN_COLS.index("q")
    q = h[1:, 0, q_col]
    crossings = np.where(np.sign(q[:-1]) * np.sign(q[1:]) < 0)[0]
    assert len(crossings) == 1
    assert abs(int(crossings[0]) + 1 - div // 2) <= 2  # antipode at s = pi
    assert np.asarray(res.kmah).tolist() == [1, 1]
    # refocus at the source: |q| collapses ~4 orders below its max
    assert abs(float(res.q[0])) < 1e-3 * np.abs(q).max()
    # the kmah history column is monotonically non-decreasing
    k = h[:, 0, DYN_COLS.index("kmah")]
    assert np.all(np.diff(k) >= 0)


def test_matches_finite_difference_on_spline_medium():
    """q/dtheta == central difference of kinematic traces, sampled medium.

    Exercises the jvp through the bilinear-n/bicubic-gradient table
    evaluation — the exact in-cell second derivative the reference's
    unused Hessian splines (RT_bench.py:459-462) were scaffolded for.
    """
    from raytracing_tpu.media.spline import build_grid_medium

    scen = rt.scenario("fisheye")
    med = build_grid_medium("fisheye", scen.box, dtype=F64)
    theta0 = np.array([np.pi / 2 - 0.2, np.pi / 2 + 0.4])
    pos0 = np.array([[0.6, 0.0], [0.6, 0.0]])
    div, steps = 400, 140  # stay well inside the box: no exits to de-sync FD
    ds = 2 * np.pi / div

    res = trace_dynamic("op6", scen, med, delta_s=ds, divisor=div + 1,
                        n_turns=1, dtype=F64, pos0=pos0, theta0=theta0,
                        max_size=steps + 1, mode="metrics")
    assert np.all(np.asarray(res.exit_step) == steps)  # nobody exited

    eps = 1e-6
    kin = {}
    for sgn in (+1, -1):
        kin[sgn] = trace("op6", scen, med, delta_s=ds, divisor=div + 1,
                         n_turns=1, dtype=F64, pos0=pos0,
                         theta0=theta0 + sgn * eps, mode="metrics",
                         max_size=steps + 1)
    dpos = (np.asarray(kin[+1].final.pos) - np.asarray(kin[-1].final.pos)) / (2 * eps)
    dth = (np.asarray(kin[+1].final.angle) - np.asarray(kin[-1].final.angle)) / (2 * eps)
    ang = np.asarray(res.angle)
    q_fd = -np.sin(ang) * dpos[:, 0] + np.cos(ang) * dpos[:, 1]
    np.testing.assert_allclose(np.asarray(res.q), q_fd, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(res.dtheta), dth, rtol=1e-5,
                               atol=1e-7)


def test_metrics_mode_matches_history_mode():
    scen = rt.scenario("vert_heterogeneous")
    med = rt.analytic_medium("vert_heterogeneous")
    kw = dict(delta_s=0.02, dtype=F64, pos0=np.zeros((4, 2)),
              theta0=np.linspace(0.2, 1.2, 4))
    a = trace_dynamic("op8", scen, med, mode="metrics", **kw)
    b = trace_dynamic("op8", scen, med, mode="history", **kw)
    assert a.history is None and b.history is not None
    for fld in ("pos", "angle", "q", "dtheta", "kmah", "traveltime",
                "exit_step"):
        np.testing.assert_array_equal(np.asarray(getattr(a, fld)),
                                      np.asarray(getattr(b, fld)))
    # the last history row agrees with the final state
    np.testing.assert_allclose(np.asarray(b.history)[-1, :, DYN_COLS.index("q")],
                               np.asarray(b.q), atol=0)


def test_state_freezes_after_boundary_exit():
    """Post-exit rows repeat the frozen state (documented divergence from
    the parity engine's zero rows) and q/kmah stop evolving."""
    scen = rt.scenario("interface")
    med = rt.analytic_medium("interface")
    res = trace_dynamic("op6", scen, med, delta_s=0.5, dtype=F64,
                        pos0=np.tile(scen.pos0[:1], (3, 1)),
                        theta0=np.array([0.3, 0.9, 1.4]))
    h = np.asarray(res.history)
    ex = np.asarray(res.exit_step)
    assert (ex < h.shape[0] - 1).all()  # everyone exits at this step size
    for r, e in enumerate(ex):
        tail = h[e:, r, :]
        np.testing.assert_array_equal(tail, np.broadcast_to(tail[0], tail.shape))


def test_anisotropic_geometry_via_newton_op():
    """Dynamic quantities flow through the smooth anisotropic op11n;
    spreading stays FD-consistent with gamma != 1."""
    scen = rt.scenario("anisotropy")
    med = rt.analytic_medium("vert_heterogeneous")
    theta0 = np.array([0.5, 0.9])
    pos0 = np.tile(scen.pos0[:1], (2, 1))
    steps = 120
    res = trace_dynamic("op11n", scen, med, delta_s=0.01, dtype=F64,
                        pos0=pos0, theta0=theta0, max_size=steps + 1,
                        mode="metrics")
    assert np.all(np.asarray(res.exit_step) == steps)
    eps = 1e-6
    fd = {}
    for sgn in (+1, -1):
        fd[sgn] = trace("op11n", scen, med, delta_s=0.01, dtype=F64,
                        pos0=pos0, theta0=theta0 + sgn * eps,
                        mode="metrics", max_size=steps + 1)
    dpos = (np.asarray(fd[+1].final.pos) - np.asarray(fd[-1].final.pos)) / (2 * eps)
    ang = np.asarray(res.angle)
    q_fd = -np.sin(ang) * dpos[:, 0] + np.cos(ang) * dpos[:, 1]
    np.testing.assert_allclose(np.asarray(res.q), q_fd, rtol=1e-5, atol=1e-7)


def test_transmission_loss_monotone_in_q():
    q = jnp.asarray([0.5, 1.0, 2.0])
    tl = transmission_loss_db(q, jnp.ones(3), jnp.ones(3))
    assert np.all(np.diff(np.asarray(tl)) > 0)
    # caustic clamp: finite at q == 0
    assert np.isfinite(float(transmission_loss_db(
        jnp.asarray(0.0), jnp.asarray(1.0), jnp.asarray(1.0))))


def test_bad_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        trace_dynamic("op1", rt.scenario("interface"), _homog(),
                      delta_s=0.1, mode="full")


def test_hand_tangent_matches_jvp_f64():
    """op6's hand-written compensated tangent recursion (engine/dynamic.
    hand_tangent) is the SAME derivative as jax.jvp of the discrete step:
    at f64 the two evaluations must agree to roundoff (the compensation
    is exact-arithmetic-neutral).  Guards both the derivation and the
    carry plumbing."""
    import raytracing_tpu.engine.dynamic as dd

    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    r = 32
    theta0 = np.pi / 2 + np.linspace(-0.1, 0.1, r)
    pos0 = np.tile(np.array([[1.0, 0.0]]), (r, 1))
    args = (pos0, theta0, med, np.float64(scen.gamma),
            np.float64(2 * np.pi / 300), np.int32(200),
            np.asarray(tuple(scen.box), np.float64))
    run_h, _ = dd._build_dynamic_fn.__wrapped__("op6", 201, "metrics",
                                                "float64")
    assert dd.HAND_TANGENT
    dd.HAND_TANGENT = False
    try:
        run_j, _ = dd._build_dynamic_fn.__wrapped__("op6", 201, "metrics",
                                                    "float64")
    finally:
        dd.HAND_TANGENT = True
    rh, rj = run_h(*args), run_j(*args)
    np.testing.assert_allclose(np.asarray(rh.q), np.asarray(rj.q),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(rh.dtheta),
                               np.asarray(rj.dtheta), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_array_equal(np.asarray(rh.kmah), np.asarray(rj.kmah))
