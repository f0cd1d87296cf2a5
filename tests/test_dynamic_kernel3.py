"""Fused 3-D dynamic kernel: hand-derived two-tangent recurrences.

kernels/dynamic3d.py carries d(pos)/d(angle) and d(u)/d(angle) for BOTH
transverse launch angles through the fused 3-D step map and reads the
paraxial determinant frame-free as ``det Q = (dpa x dpb) . u``.  Tests pin

* the inlined 3-D Hessians against jax.hessian of the field twins,
* det Q / KMAH / focus-locator parity with trace_dynamic3's exact jvp
  (the hand tangent must track the autodiff one, engine/dynamic3d.py),
* the fast_dynamic3 router (kernel for analytic fields, scan fallback
  with containment-based activity for sampled media),
* error paths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_tpu.engine.dynamic3d import trace_dynamic3
from raytracing_tpu.kernels.dynamic3d import (DYN3_FUSED_FIELDS,
                                              _field3_fn_h,
                                              dynamic3d_trace_final)
from raytracing_tpu.media.fields3d import analytic_medium3

pytestmark = pytest.mark.slow

BOX = (-1.5, 1.5, -1.5, 1.5, -1.5, 1.5)


@pytest.mark.parametrize("field", DYN3_FUSED_FIELDS)
def test_inlined_hessians_match_autodiff(field):
    med = analytic_medium3(field)
    f = _field3_fn_h(field)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.2, 1.2, (16, 3))

    def n_of(p):
        return med.n_and_grad3(p[0], p[1], p[2])[0]

    H = jax.vmap(jax.hessian(n_of))(jnp.asarray(pts))
    out = f(*(jnp.asarray(pts[:, k]) for k in range(3)))
    n, gx, gy, gz = out[0], out[1], out[2], out[3]
    hxx, hxy, hxz, hyy, hyz, hzz = out[4:]
    nm, (gxm, gym, gzm) = med.n_and_grad3(
        *(jnp.asarray(pts[:, k]) for k in range(3)))
    np.testing.assert_allclose(np.asarray(n), np.asarray(nm), rtol=1e-6)
    for a, b in ((gx, gxm), (gy, gym), (gz, gzm)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-12)
    for a, idx in ((hxx, (0, 0)), (hxy, (0, 1)), (hxz, (0, 2)),
                   (hyy, (1, 1)), (hyz, (1, 2)), (hzz, (2, 2))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(H)[:, *idx],
                                   rtol=2e-5, atol=1e-7)


def _fan(r, spread=0.05):
    th = np.pi / 2 + np.linspace(-spread, spread, r)
    dirs = np.stack([np.cos(th), np.sin(th), np.full(r, 0.02)],
                    -1).astype(np.float32)
    pos0 = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (r, 1))
    return pos0, dirs


@pytest.mark.parametrize("op", ["op1", "op2", "op6", "op8"])
def test_dyn_kernel3_matches_scan_jvp_fisheye(op):
    """The hand tangent tracks the exact jvp: positions to poly-rotation
    tolerance, det Q to ~1e-5 relative, KMAH exactly."""
    pos0, dirs = _fan(256)
    ds = np.float32(2 * np.pi / 600)
    g = dynamic3d_trace_final(pos0, dirs, ds, field="fisheye", op=op,
                              steps=500, box=BOX, block_rays=256,
                              interpret=True)
    d = trace_dynamic3(op, analytic_medium3("fisheye"), pos0=pos0,
                       dir0=dirs, delta_s=float(ds), steps=500, box=BOX,
                       mode="metrics", dtype=np.float32)
    np.testing.assert_allclose(np.asarray(g.pos), np.asarray(d.pos),
                               atol=1e-5)
    dq, gq = np.asarray(d.detq), np.asarray(g.detq)
    np.testing.assert_allclose(gq, dq, rtol=5e-5, atol=1e-8)
    np.testing.assert_array_equal(np.asarray(g.kmah), np.asarray(d.kmah))
    np.testing.assert_allclose(np.asarray(g.traveltime),
                               np.asarray(d.traveltime), atol=3e-5)


def test_dyn_kernel3_other_fields():
    """vert_heterogeneous (stratified lift) and interface (sigmoid wall)
    track the exact jvp too — their Hessians are the nontrivial inputs."""
    r = 256
    a = np.linspace(0.1, 0.9, r)
    dirs = np.stack([np.cos(a), np.sin(a), np.full(r, 0.01)],
                    -1).astype(np.float32)
    # short pre/through-interface arcs (the 2-D kernel test's launch,
    # tests/test_dynamic_kernel.py::_launch): long post-interface runs
    # amplify the poly-vs-trig rotation difference chaotically
    for field, pos, box, steps, ds in (
            ("vert_heterogeneous", [0.0, -1.0, 0.0],
             (-2.0, 5.0, -2.5, 1.0, -2.0, 2.0), 250, 0.01),
            ("interface", [-2.0, -2.0, 0.0],
             (-2.0, 20.0, -2.0, 4.0, -4.0, 4.0), 250, 0.01)):
        pos0 = np.tile(np.array(pos, np.float32), (r, 1))
        g = dynamic3d_trace_final(pos0, dirs, np.float32(ds), field=field,
                                  op="op6", steps=steps, box=box,
                                  block_rays=256, interpret=True)
        d = trace_dynamic3("op6", analytic_medium3(field), pos0=pos0,
                           dir0=dirs, delta_s=ds, steps=steps, box=box,
                           mode="metrics", dtype=np.float32)
        np.testing.assert_allclose(np.asarray(g.pos), np.asarray(d.pos),
                                   atol=2e-4, err_msg=field)
        np.testing.assert_allclose(np.asarray(g.detq), np.asarray(d.detq),
                                   rtol=2e-4, atol=1e-6, err_msg=field)
        np.testing.assert_array_equal(np.asarray(g.kmah),
                                      np.asarray(d.kmah), err_msg=field)


def test_dyn_kernel3_focus_locator():
    """The Maxwell fisheye's perfect point focus: min |det Q| collapses
    near the antipodal image and the tracked step matches the scan tier's
    locator (engine/dynamic3d.py 'point foci' note)."""
    pos0, dirs = _fan(256, spread=0.02)
    div = 600
    ds = np.float32(2 * np.pi / div)
    g = dynamic3d_trace_final(pos0, dirs, ds, field="fisheye", op="op6",
                              steps=div, box=BOX, block_rays=256,
                              interpret=True)
    d = trace_dynamic3("op6", analytic_medium3("fisheye"), pos0=pos0,
                       dir0=dirs, delta_s=float(ds), steps=div, box=BOX,
                       mode="metrics", dtype=np.float32)
    # the focus step agrees within a step or two; |det Q|_min is tiny
    np.testing.assert_allclose(np.asarray(g.min_absdet_step),
                               np.asarray(d.min_absdet_step), atol=2)
    assert np.asarray(g.min_absdet).max() < 1e-4


def test_fast_dynamic3_routing():
    from raytracing_tpu.engine.fast import fast_dynamic3
    from raytracing_tpu.media.grid3 import c1_medium3_from_samples

    pos0, dirs = _fan(200)    # ragged: exercises padding
    ds = 2 * np.pi / 600
    res, eng = fast_dynamic3("op6", analytic_medium3("fisheye"),
                             pos0=pos0, dir0=dirs, delta_s=ds, steps=300,
                             box=BOX, block_rays=256)
    assert eng == "dynamic3-kernel" and res.detq.shape == (200,)
    assert np.all(np.isfinite(np.asarray(res.detq)))

    # sampled grid3 media take the scan tier's exact jvp
    ax = np.linspace(-1.6, 1.6, 9)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    med = c1_medium3_from_samples(1.0 / (1.0 + X**2 + Y**2 + Z**2),
                                  ax, ax, ax, dtype=np.float32)
    res2, eng2 = fast_dynamic3("op6", med, pos0=pos0, dir0=dirs,
                               delta_s=ds, steps=100, box=BOX)
    assert eng2 == "dynamic3-scan"
    p = np.asarray(res2.pos)
    inside = ((p[:, 0] >= BOX[0]) & (p[:, 0] <= BOX[1])
              & (p[:, 1] >= BOX[2]) & (p[:, 1] <= BOX[3])
              & (p[:, 2] >= BOX[4]) & (p[:, 2] <= BOX[5]))
    np.testing.assert_array_equal(np.asarray(res2.active), inside)


def test_dyn_kernel3_error_paths():
    pos0, dirs = _fan(128)
    with pytest.raises(ValueError, match="fields"):
        dynamic3d_trace_final(pos0, dirs, np.float32(0.01), field="warp",
                              op="op6", steps=8, box=BOX, block_rays=128)
    with pytest.raises(ValueError, match="ops"):
        dynamic3d_trace_final(pos0, dirs, np.float32(0.01),
                              field="fisheye", op="op5", steps=8, box=BOX,
                              block_rays=128)
