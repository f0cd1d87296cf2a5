"""Differential tests against the ACTUAL reference program.

``tests/ref_numpy.py`` is this repo's own transcription of the reference —
a shared misreading would pass every mirror test.
These tests close that hole: they import ``/root/reference/RT_bench.py``
itself (read-only; its menus live under ``__main__``, RT_bench.py:1550),
bind its module globals the way its ``__main__`` does (``f``, ``gamma``,
``N`` — RT_bench.py:1567-1584), build its FITPACK splines
(genZ/interpolacion, RT_bench.py:412-464), call ``trazar``
(RT_bench.py:766) directly for every one of the 11 step methods, and assert
the float64 scan engine reproduces its trajectories on the equivalent
sampled-spline medium (media/spline.build_grid_medium — the same
genZ -> np.gradient -> bicubic pipeline as per-cell tables).

Tolerances: the per-cell tables match scipy's FITPACK evaluation to ~1e-10
(tests/test_spline.py); ~100 integration steps amplify that to ~1e-8.
Golden-search ops localize the angle to sqrt(eps_f64) per step, so their
trajectories carry that noise instead (~5e-7, same bar as the mirror
tests in test_trace.py).
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

from raytracing_tpu import scenario, trace
from raytracing_tpu.media.spline import build_grid_medium

REF_PATH = pathlib.Path("/root/reference/RT_bench.py")
pytestmark = pytest.mark.skipif(not REF_PATH.exists(),
                                reason="reference checkout not present")


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("RT_bench_ref", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_splines(mod, scen):
    """The reference's exact spline pipeline for a scenario box."""
    x, y, X, Y, ZZ = mod.genZ(*scen.box)
    z, grd, _hess = mod.interpolacion(x, y, ZZ, X, Y)
    return z, grd


def _shrink_s(mod, s_value):
    """Wrap the reference's ``constants`` so trazar sees a short arc."""
    orig = mod.constants

    def shrunk(user_choice):
        vals = list(orig(user_choice))
        vals[4] = s_value                       # s, RT_bench.py:261
        return tuple(vals)

    mod.constants = shrunk
    return orig


def _compare(res, s_ray, d_ray, atol):
    got_s, _got_n = res.reference_layout()
    # compare up to each ray's exit step (both sides zero-fill after exit)
    np.testing.assert_allclose(got_s[..., : s_ray.shape[2]], s_ray,
                               atol=atol, err_msg="trajectory mismatch")
    np.testing.assert_array_equal(np.asarray(res.exit_step),
                                  d_ray[2].astype(int))
    np.testing.assert_allclose(np.asarray(res.dist_sim), d_ray[1], atol=atol)


ALL_ISO_OPS = ["op1", "op2", "op3", "op4", "op5", "op6", "op7", "op8", "op9"]


@pytest.mark.parametrize("op", ALL_ISO_OPS)
def test_differential_fisheye(ref, op):
    """Each isotropic op vs the reference's own trazar on its own splines."""
    ref.f = ref.fisheye                         # RT_bench.py:1567-1580
    ref.N = 1                                   # one turn keeps trazar quick
    ref.gamma = 1
    scen = scenario("fisheye")
    div = 90
    ds = 2 * np.pi / div
    z, grd = _ref_splines(ref, scen)
    s_ray, d_ray, _times, _errs = ref.trazar(
        getattr(ref, op), z, grd, 0, ds, div, "2")

    med = build_grid_medium("fisheye", scen.box, dtype=np.float64)
    # duplicated ray pair: XLA CPU's f64 sin/cos take an inaccurate code
    # path for 1-element arrays (see test_trace.test_fisheye_short)
    res = trace(op, scen, med, delta_s=ds, divisor=div, n_turns=1,
                dtype=np.float64,
                pos0=np.repeat(scen.pos0, 2, 0),
                theta0=np.repeat(scen.theta0, 2))
    res = res._replace(history=res.history[:, :1], n_hist=res.n_hist[:, :1],
                       exit_step=res.exit_step[:1],
                       dist_real=res.dist_real[:1],
                       dist_sim=res.dist_sim[:1])
    _compare(res, s_ray, d_ray,
             atol=5e-7 if op in ("op5", "op9") else 1e-8)


@pytest.mark.parametrize("op", ["op10", "op11"])
def test_differential_aniso(ref, op):
    """The anisotropic momentum algorithm (the reference's headline novelty,
    RT_bench.py:30-32) vs the reference itself, gamma=3."""
    ref.f = ref.vert_heterogeneous
    ref.gamma = 3                               # op10/op11 read the global
    scen = dataclasses.replace(scenario("aniso"), s_max=2.0)
    ds = 0.02
    z, grd = _ref_splines(ref, scen)
    orig = _shrink_s(ref, 2.0)
    try:
        s_ray, d_ray, _times, _errs = ref.trazar(
            getattr(ref, op), z, grd, 0, ds, 0, "4")
    finally:
        ref.constants = orig

    med = build_grid_medium("vert_heterogeneous", scen.box, dtype=np.float64)
    res = trace(op, scen, med, delta_s=ds, dtype=np.float64)
    _compare(res, s_ray, d_ray, atol=5e-7)


def test_differential_vert_iso_golden(ref):
    """op5 on the vert scenario (gamma=1 golden) — covers the iso golden
    path on the stratified medium geometry."""
    ref.f = ref.vert_heterogeneous
    ref.gamma = 1
    scen = dataclasses.replace(scenario("vert"), s_max=2.0)
    ds = 0.02
    z, grd = _ref_splines(ref, scen)
    orig = _shrink_s(ref, 2.0)
    try:
        s_ray, d_ray, _times, _errs = ref.trazar(
            ref.op5, z, grd, 0, ds, 0, "3")
    finally:
        ref.constants = orig

    med = build_grid_medium("vert_heterogeneous", scen.box, dtype=np.float64)
    res = trace("op5", scen, med, delta_s=ds, dtype=np.float64)
    _compare(res, s_ray, d_ray, atol=5e-7)


def test_differential_interface_snell_errors(ref):
    """The interface scenario end-to-end vs the reference: trajectories AND
    the per-ray Snell-deviation metric (RT_bench.py:896-919) — the
    acceptance quantity the DELTA_S search thresholds on."""
    from raytracing_tpu.engine import oracles

    ref.f = ref.interface
    ref.gamma = 1
    scen = dataclasses.replace(scenario("interface"), s_max=8.0)
    ds = 0.05
    z, grd = _ref_splines(ref, scen)
    orig = _shrink_s(ref, 8.0)
    try:
        s_ray, d_ray, _times, errs = ref.trazar(
            ref.op6, z, grd, 0, ds, 0, "1")
    finally:
        ref.constants = orig

    med = build_grid_medium("interface", scen.box, dtype=np.float64)
    res = trace("op6", scen, med, delta_s=ds, dtype=np.float64)
    _compare(res, s_ray, d_ray, atol=1e-8)
    got = np.asarray(oracles.snell_errors_deg(res, scen.theta0))
    np.testing.assert_allclose(got, errs, atol=1e-7,
                               err_msg="Snell metric mismatch")


def test_differential_fisheye_closure_metric(ref):
    """search_delta's closure formula (RT_bench.py:956) vs
    oracles.closure_error_pct on the same trajectories."""
    from raytracing_tpu.engine import oracles

    ref.f = ref.fisheye
    ref.N = 1
    ref.gamma = 1
    ref.op_interface, ref.op_fish = 0, 1
    ref.op_vert_heterogeneous = ref.op_anisotropy = 0
    scen = scenario("fisheye")
    div = 90
    ds = 2 * np.pi / div
    z, grd = _ref_splines(ref, scen)
    ref_closure = ref.search_delta(ref.op6, z, grd, ds, div, "2")

    med = build_grid_medium("fisheye", scen.box, dtype=np.float64)
    res = trace("op6", scen, med, delta_s=ds, divisor=div, n_turns=1,
                dtype=np.float64,
                pos0=np.repeat(scen.pos0, 2, 0),
                theta0=np.repeat(scen.theta0, 2))
    got = float(np.asarray(oracles.closure_error_pct(res))[0])
    assert got == pytest.approx(float(ref_closure), abs=1e-8)


def test_differential_outlier_filter(ref):
    """bench.harness.remove_outliers_iqr is the reference's own filter
    (RT_bench.py:123-138) — must agree exactly, outliers and ties."""
    from raytracing_tpu.bench import harness

    rng = np.random.default_rng(3)
    for data in (rng.normal(1.0, 0.1, 200),
                 np.concatenate([rng.normal(1.0, 0.01, 50),
                                 [5.0, -3.0, 1.0, 1.0]]),
                 np.full(10, 2.5)):
        np.testing.assert_array_equal(harness.remove_outliers_iqr(data),
                                      ref.remove_outliers_iqr(data))
