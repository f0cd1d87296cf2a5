"""Fused dynamic kernel: hand-written tangents vs jvp, Hessians, oracles.

The kernel (kernels/dynamic.py) propagates d(state)/d(theta0) through
closed-form recurrences instead of jax.jvp (which cannot cross
pallas_call).  Three independent checks:

* the inlined field Hessians against ``jax.hessian`` of the field;
* q / dtheta / kmah against the scan tier's exact jvp
  (engine/dynamic.trace_dynamic) — the same discrete map, so agreement is
  limited only by the kernels' degree-5 rotation polynomials and f32;
* q against a CENTRAL DIFFERENCE of the kinematic fused kernel over
  theta0 — an oracle that shares no tangent code with either tier.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raytracing_tpu as rt
from raytracing_tpu import config
from raytracing_tpu.engine.dynamic import trace_dynamic
from raytracing_tpu.kernels.dynamic import (DYN_FUSED_FIELDS, DYN_FUSED_OPS,
                                            _field_fn_h, dynamic_trace_final)
from raytracing_tpu.kernels.fused import fused_trace_final

F32 = np.float32


@pytest.mark.parametrize("field", DYN_FUSED_FIELDS)
def test_inlined_hessians_match_autodiff(field):
    med = rt.analytic_medium(field)
    f = _field_fn_h(field)

    def n_of(p):
        n, _ = med.n_and_grad(p[0], p[1])
        return n

    pts = [(0.3, 0.4), (-0.5, 0.2), (1.0, -0.1), (0.0, 0.0), (0.2, -0.3)]
    for (x, y) in pts:  # conftest runs x64, so float64 throughout
        h_ad = jax.hessian(n_of)(jnp.asarray([x, y], jnp.float64))
        # 9-channel layout: (n, gx, gy, gnx, gny, hxx, hxy, hyx, hyy);
        # analytic fields are gradient-consistent (gn == g, hyx == hxy)
        n, gx, gy, gnx, gny, hxx, hxy, hyx, hyy = f(jnp.float64(x),
                                                    jnp.float64(y))
        np.testing.assert_array_equal(gnx, gx)
        np.testing.assert_array_equal(gny, gy)
        np.testing.assert_array_equal(hyx, hxy)
        np.testing.assert_allclose(hxx, h_ad[0, 0], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(hxy, h_ad[0, 1], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(hyy, h_ad[1, 1], rtol=1e-9, atol=1e-12)


_CASES = [
    ("fisheye", "op1"), ("fisheye", "op2"), ("fisheye", "op6"),
    ("fisheye", "op8"), ("vert_heterogeneous", "op8"),
    ("vert_heterogeneous", "op6"), ("interface", "op2"),
    ("interface", "op1"),
]


def _launch(field, r):
    if field == "fisheye":
        theta0 = (np.pi / 2 + np.linspace(-0.2, 0.2, r)).astype(F32)
        pos0 = np.tile(np.array([1.0, 0.0], F32), (r, 1))
        ds, steps, box = F32(2 * np.pi / 300), 300, (-1.5, 1.5, -1.5, 1.5)
    elif field == "vert_heterogeneous":
        theta0 = np.linspace(0.05, np.pi / 2 - 0.05, r).astype(F32)
        pos0 = np.tile(np.array([0.0, 0.0], F32), (r, 1))
        ds, steps, box = F32(0.01), 250, (-2.0, 5.0, -2.5, 1.0)
    else:
        theta0 = np.linspace(np.pi / 30, np.pi / 2 - 0.05, r).astype(F32)
        pos0 = np.tile(np.array([-2.0, -2.0], F32), (r, 1))
        ds, steps, box = F32(0.01), 250, (-2.0, 20.0, -2.0, 4.0)
    return pos0, theta0, ds, steps, box


@pytest.mark.parametrize("field,op", _CASES)
def test_kernel_tangent_matches_scan_jvp(field, op):
    r = 256
    pos0, theta0, ds, steps, box = _launch(field, r)
    scen = config.ScenarioConfig(
        name="t", key="-", field=field, gamma=1.0, ray_count=r,
        theta0=theta0, pos0=pos0, s_max=0.0, box=box)
    med = rt.analytic_medium(field)
    ref = trace_dynamic(op, scen, med, delta_s=ds, mode="metrics",
                        dtype=F32, pos0=pos0, theta0=theta0,
                        max_size=steps + 1)
    out = dynamic_trace_final(jnp.asarray(pos0), jnp.asarray(theta0), ds,
                              field=field, op=op, steps=steps, box=box,
                              block_rays=256, interpret=True)
    qr, qk = np.asarray(ref.q), np.asarray(out.q)
    scale = np.abs(qr).max()
    assert np.abs(qk - qr).max() / scale < 2e-3
    dr, dk = np.asarray(ref.dtheta), np.asarray(out.dtheta)
    assert np.abs(dk - dr).max() / np.abs(dr).max() < 2e-3
    assert (np.asarray(ref.kmah) == np.asarray(out.kmah)).mean() > 0.99
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(out.traveltime),
                               np.asarray(ref.traveltime), atol=2e-4)
    assert np.array_equal(np.asarray(out.active), np.asarray(ref.exit_step)
                          == steps)


@pytest.mark.parametrize("family", ["parity", "c1"])
@pytest.mark.parametrize("op", DYN_FUSED_OPS)
def test_strat_kernel_tangent_matches_scan_jvp(family, op):
    """Sampled-media dynamic kernel vs the scan tier's exact jvp.

    The scan tier differentiates straight through the gathered spline
    (bilinear n + cubic gy for the parity family — an INCONSISTENT pair
    whose n-tangent is the bilinear slope, media/spline.py:130-138), so
    the kernel's split gn/g channels (`_strat_nag_h`) must reproduce it,
    not the C1 idealization.
    """
    from raytracing_tpu.kernels.dynamic import dynamic_trace_final_strat
    from raytracing_tpu.media.c1 import build_c1_stratified
    from raytracing_tpu.media.spline import build_stratified_medium

    r = 256
    field = "vert_heterogeneous"
    pos0, theta0, ds, steps, box = _launch(field, r)
    scen = config.ScenarioConfig(
        name="t", key="-", field=field, gamma=1.0, ray_count=r,
        theta0=theta0, pos0=pos0, s_max=0.0, box=box)
    build = build_stratified_medium if family == "parity" \
        else build_c1_stratified
    med = build(field, box)
    ref = trace_dynamic(op, scen, med, delta_s=ds, mode="metrics",
                        dtype=F32, pos0=pos0, theta0=theta0,
                        max_size=steps + 1)
    out = dynamic_trace_final_strat(jnp.asarray(pos0), jnp.asarray(theta0),
                                    ds, med, op=op, steps=steps, box=box,
                                    block_rays=256, interpret=True)
    qr, qk = np.asarray(ref.q), np.asarray(out.q)
    assert np.abs(qk - qr).max() / np.abs(qr).max() < 2e-3
    dr, dk = np.asarray(ref.dtheta), np.asarray(out.dtheta)
    assert np.abs(dk - dr).max() / np.abs(dr).max() < 2e-3
    assert (np.asarray(ref.kmah) == np.asarray(out.kmah)).mean() > 0.99
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(out.traveltime),
                               np.asarray(ref.traveltime), atol=2e-4)


def test_strat_dynamic_kernel_rejects_golden():
    from raytracing_tpu.kernels.dynamic import dynamic_trace_final_strat
    from raytracing_tpu.media.spline import build_stratified_medium

    med = build_stratified_medium("vert_heterogeneous", (-2, 5, -2.5, 1))
    with pytest.raises(ValueError, match="zero a.e."):
        dynamic_trace_final_strat(np.zeros((128, 2), F32),
                                  np.zeros(128, F32), F32(0.01), med,
                                  op="op5", steps=4, box=(-1, 1, -1, 1),
                                  block_rays=128)


def test_fast_dynamic_dispatch_routes_and_agrees():
    """fast_dynamic picks the kernel for analytic + stratified media, the
    scan tier otherwise, with ragged ray counts padded transparently."""
    from raytracing_tpu.engine.fast import fast_dynamic
    from raytracing_tpu.media.spline import build_stratified_medium

    r = 250     # NOT a lane multiple: exercises the pad/slice path
    field = "vert_heterogeneous"
    pos0, theta0, ds, steps, box = _launch(field, 256)
    pos0, theta0 = pos0[:r], theta0[:r]
    scen = config.ScenarioConfig(
        name="t", key="-", field=field, gamma=1.0, ray_count=r,
        theta0=theta0, pos0=pos0, s_max=0.0, box=box)
    amed = rt.analytic_medium(field)
    smed = build_stratified_medium(field, box)
    kw = dict(delta_s=ds, pos0=pos0, theta0=theta0, steps=steps)

    res_a, eng_a = fast_dynamic("op6", scen, amed, **kw)
    assert eng_a == "dynamic-kernel" and res_a.q.shape == (r,)
    res_s, eng_s = fast_dynamic("op6", scen, smed, **kw)
    assert eng_s == "dynamic-kernel-strat" and res_s.q.shape == (r,)
    res_f, eng_f = fast_dynamic("op5", scen, amed, **kw)   # golden: scan
    assert eng_f == "dynamic-scan" and res_f.q.shape == (r,)

    # the kernel tiers agree with the scan tier (coarse bar: the per-op
    # parity bars live in the dedicated tests above)
    ref = trace_dynamic("op6", scen, amed, delta_s=ds, mode="metrics",
                        dtype=F32, pos0=pos0, theta0=theta0,
                        max_size=steps + 1)
    qa = np.asarray(res_a.q)
    assert np.abs(qa - np.asarray(ref.q)).max() / np.abs(qa).max() < 2e-3


def test_q_matches_central_difference_of_kinematic_kernel():
    """Tangent-free oracle: q == dpos/dtheta0 . u_perp by central FD of the
    kinematic fused kernel (shares the step map, not the tangent code)."""
    r = 256
    field, op = "fisheye", "op6"
    pos0, theta0, ds, steps, box = _launch(field, r)
    steps = 150
    h = F32(1e-3)
    kw = dict(field=field, op=op, steps=steps, box=box, block_rays=256,
              interpret=True)
    dyn = dynamic_trace_final(jnp.asarray(pos0), jnp.asarray(theta0), ds,
                              **kw)
    lo = fused_trace_final(jnp.asarray(pos0), jnp.asarray(theta0 - h), ds,
                           **kw)
    hi = fused_trace_final(jnp.asarray(pos0), jnp.asarray(theta0 + h), ds,
                           **kw)
    dpos = (np.asarray(hi.pos) - np.asarray(lo.pos)) / (2 * h)
    tan = np.asarray(dyn.tangent)
    q_fd = -dpos[:, 0] * tan[:, 1] + dpos[:, 1] * tan[:, 0]
    q = np.asarray(dyn.q)
    # FD truncation is O(h^2 * |d2pos|) and f32 cancellation is O(eps/h);
    # 3e-3 relative covers both at h = 1e-3
    assert np.abs(q - q_fd).max() / np.abs(q).max() < 3e-3


def test_dynamic_kernel_rejects_golden_and_unknown():
    pos0 = np.zeros((128, 2), F32)
    th = np.zeros(128, F32)
    with pytest.raises(ValueError, match="zero a.e."):
        dynamic_trace_final(pos0, th, F32(0.01), field="fisheye", op="op5",
                            steps=4, box=(-1, 1, -1, 1), block_rays=128)
    with pytest.raises(ValueError, match="fields"):
        dynamic_trace_final(pos0, th, F32(0.01), field="nope", op="op6",
                            steps=4, box=(-1, 1, -1, 1), block_rays=128)


def test_interface_sigmoid_tangent_is_finite_and_exact_at_zero():
    """Regression: the literal reference sigmoid overflowed f32 for
    |y| > ~0.44, turning every interface jvp into NaN (media/fields.py
    _sigmoid); the safe form must also keep the exact tangent ON the
    interface midline (abs-kink pitfall)."""
    from raytracing_tpu.media.fields import _sigmoid
    med = rt.analytic_medium("interface")

    def gy_of(y):
        _, (_, gy) = med.n_and_grad(jnp.float32(0.0), y)
        return gy

    for y in [-2.0, -0.5, 0.0, 0.5, 2.0]:
        _, tan = jax.jvp(gy_of, (jnp.float32(y),), (jnp.float32(1.0),))
        assert np.isfinite(float(tan))
    v, t = jax.jvp(_sigmoid, (jnp.float32(0.0),), (jnp.float32(1.0),))
    assert float(v) == 0.5 and float(t) == 0.25


@pytest.mark.slow
def test_fast_dynamic_routes_grid_to_tiled():
    from raytracing_tpu.engine.fast import fast_dynamic
    from raytracing_tpu.media.spline import build_grid_medium

    scen = rt.scenario("fisheye")
    med = build_grid_medium("fisheye", scen.box, dtype=np.float32)
    r = 300   # ragged: pads to the block internally
    theta0 = (np.pi / 2 + np.linspace(-0.03, 0.03, r)).astype(np.float32)
    pos0 = np.tile(np.array([1.0, 0.0], np.float32), (r, 1))
    res, eng = fast_dynamic("op6", scen, med, delta_s=2 * np.pi / 4587,
                            pos0=pos0, theta0=theta0, steps=300,
                            block_rays=256)
    # 2-D grid media take the scan tier's exact jvp
    assert eng == "dynamic-scan" and res.q.shape == (r,)
    assert np.all(np.isfinite(np.asarray(res.q)))
    # golden ops fall through to the scan tier too
    res5, eng5 = fast_dynamic("op5", scen, med, delta_s=2 * np.pi / 4587,
                              pos0=pos0, theta0=theta0, steps=50,
                              block_rays=256)
    assert eng5 == "dynamic-scan"
