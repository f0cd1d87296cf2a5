"""DELTA_S search: acceptance policies, batched candidate runs, sharding."""
import jax
import numpy as np
import pytest

import raytracing_tpu as rt
from raytracing_tpu import config
from raytracing_tpu.parallel import mesh as meshlib
from raytracing_tpu.parallel import sweep as sw

# heavyweight module: segmented chains / sharded meshes / full sweeps /
# interpret-mode kernel parity.  Deselect with -m 'not slow' (CLAUDE.md).
pytestmark = pytest.mark.slow


# -- find_index policies (pure host logic, RT_bench.py:1320-1375) -----------
def test_find_index_interface():
    f = sw.find_index_interface
    # accepted: largest step (lowest i) passing with all coarser passing
    assert f([0.1, 0.1, 0.3], [0.5, 0.5, 0.9]) == 1
    # a coarser candidate's max_err failure blocks acceptance entirely
    assert f([0.1, 0.1, 0.3], [0.9, 0.5, 0.9]) is None
    # all passing or all failing -> None (RT_bench.py:1325)
    assert f([0.1, 0.1], [0.5, 0.5]) is None
    assert f([0.3, 0.4], [0.9, 0.9]) is None


def test_find_index_interface_requires_prefix_pass():
    # i=2 passes but i=0 fails the mean threshold -> no acceptance at 2.
    assert sw.find_index_interface([0.3, 0.1, 0.1], [0.5, 0.5, 0.5]) is None


def test_find_index_fisheye():
    f = sw.find_index_fisheye
    assert f([1.0, 2.0, 6.0, 7.0]) == 1
    assert f([1.0, 1.0]) is None
    assert f([6.0, 7.0]) is None


def test_find_index_vert():
    f = sw.find_index_vert
    th = config.MAX_MOMENTUM_CV_PCT
    errs = [th / 2, th / 2, th / 2, th * 2, th * 3]
    assert f(errs) == 2
    # crossing at i <= 1 is ignored (reference's i > 1 guard)
    assert f([th * 2, th / 2, th / 2]) is None


def test_candidate_grids_match_reference_rules():
    div_i, ds_i, _ = sw.candidates(rt.scenario("interface"))
    assert div_i[0] == pytest.approx(3.0) and div_i[-1] == pytest.approx(1.01)
    np.testing.assert_allclose(ds_i, config.SIGMA / div_i)
    div_f, ds_f, tdiv = sw.candidates(rt.scenario("fisheye"))
    assert div_f[0] == 303 and div_f[-1] == 4
    np.testing.assert_array_equal(tdiv, div_f + 1)
    div_v, _, _ = sw.candidates(rt.scenario("vert"))
    # reference uses DELTA_STEP (0.01) here, not DELTA_STEP_VERT (dead const)
    assert div_v[0] == pytest.approx(2.0)
    assert div_v[1] - div_v[0] == pytest.approx(-config.DELTA_STEP)


# -- batched candidate evaluation -------------------------------------------
def _fisheye_candidates():
    divs = np.arange(60.0, 3.0, -1.0)
    ds = 2 * np.pi / divs
    sizes = (divs + 1).astype(np.int64)  # n_turns=1
    return divs, ds, sizes


def test_fisheye_candidate_sweep_monotone_and_selects():
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    divs, ds, sizes = _fisheye_candidates()
    m = sw.run_candidates("op1", scen, med, ds, sizes - 1, int(sizes.max()),
                          n_turns=1, dtype=np.float64)
    closure = m["closure_pct"]
    # finer steps -> smaller closure error at the coarse end of the range
    assert closure[0] < closure[-1]
    idx = sw.find_index_fisheye(closure)
    assert idx is not None
    assert closure[idx] < 5.0 < closure[idx + 1]


def test_sweep_sharded_over_mesh_matches_single_device():
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    divs, ds, sizes = _fisheye_candidates()
    divs, ds, sizes = divs[:56], ds[:56], sizes[:56]  # 56 = 8 devices * 7
    single = sw.run_candidates("op1", scen, med, ds, sizes - 1,
                               int(sizes.max()), n_turns=1, dtype=np.float64)
    mesh = meshlib.make_mesh(8, sweep=8)
    shard = sw.run_candidates("op1", scen, med, ds, sizes - 1,
                              int(sizes.max()), n_turns=1, dtype=np.float64,
                              mesh=mesh)
    np.testing.assert_allclose(shard["closure_pct"], single["closure_pct"],
                               rtol=1e-12)


def test_vert_candidate_sweep_cv():
    scen = rt.scenario("vert")
    med = rt.analytic_medium("vert_heterogeneous")
    divs = np.arange(3.0, 0.2, -0.2)
    ds = config.SIGMA / divs
    sizes = np.ceil(scen.s_max / ds).astype(np.int64) + 1
    m = sw.run_candidates("op8", scen, med, ds, sizes - 1, int(sizes.max()),
                          dtype=np.float64)
    cv = m["cv_pct"]
    assert np.all(np.isfinite(cv))
    # op8's calibrated divisor is 2.74: CV must pass there and degrade for
    # much coarser steps.
    assert cv[0] < config.MAX_MOMENTUM_CV_PCT
    assert cv[-1] > cv[0]


def test_delta_s_search_end_to_end(monkeypatch):
    monkeypatch.setattr(config, "DELTA_S_DIVISOR_FISHEYE_UPPER_LIMIT", 60.0)
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    res = sw.delta_s_search("op1", scen, med, n_turns=1, dtype=np.float64)
    assert res.index is not None
    assert res.divisor == 23.0
    assert res.delta_s_selected == pytest.approx(2 * np.pi / 23.0)


def test_interface_candidate_sweep_metric_path():
    """The history-mode interface sweep metric (mean/max Snell error)."""
    scen = rt.scenario("interface")
    med = rt.analytic_medium("interface")
    divs = np.array([3.0, 2.5, 2.0])
    ds = config.SIGMA / divs
    sizes = np.ceil(scen.s_max / ds).astype(np.int64) + 1
    m = sw.run_candidates("op6", scen, med, ds, sizes - 1, int(sizes.max()),
                          dtype=np.float64, chunk=3)
    assert set(m) == {"mean_err", "max_err"}
    assert np.all(np.isfinite(m["mean_err"]))
    assert np.all(m["max_err"] >= m["mean_err"])


@pytest.mark.parametrize("op,expected", [("op4", 179), ("op8", 179)])
def test_search_reproduces_reference_calibration(op, expected):
    """The full N=10 search lands within a few percent of the reference's
    offline-calibrated fisheye divisors (RT_bench.py:1432-1449)."""
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    res = sw.delta_s_search(op, scen, med, n_turns=10, dtype=np.float64)
    assert res.index is not None
    assert abs(res.divisor - expected) / expected < 0.05, res.divisor


def test_fused_sweep_matches_engine_sweep():
    """One compiled fused kernel with traced step limits reproduces the
    scan-engine candidate sweep."""
    scen = rt.scenario("fisheye")
    med = rt.analytic_medium("fisheye")
    divs = np.arange(40.0, 20.0, -2.0)
    ds = 2 * np.pi / divs
    sizes = (divs + 1).astype(np.int64)  # n_turns=1, reference's div+1 sizing
    engine = sw.run_candidates("op6", scen, med, ds, sizes - 1,
                               int(sizes.max()), n_turns=1, dtype=np.float32)
    fused = sw.run_candidates_fused("op6", scen, ds, sizes - 1,
                                    int(sizes.max()) - 1, rays=128,
                                    block_rays=128)
    np.testing.assert_allclose(fused["closure_pct"], engine["closure_pct"],
                               atol=1e-3)


def test_sweep_custom_ray_batch():
    """Candidate sweep over a custom (larger) launch batch."""
    scen = rt.scenario("vert")
    med = rt.analytic_medium("vert_heterogeneous")
    divs = np.array([3.0, 2.0])
    ds = config.SIGMA / divs
    sizes = np.ceil(scen.s_max / ds).astype(np.int64) + 1
    r = 200
    theta0 = np.linspace(0.0, np.pi / 2, r)
    pos0 = np.tile(np.array([[-2.0, -2.0]]), (r, 1))
    m = sw.run_candidates("op8", scen, med, ds, sizes - 1, int(sizes.max()),
                          dtype=np.float64, pos0=pos0, theta0=theta0)
    assert m["cv_pct"].shape == (2,)
    assert np.all(np.isfinite(m["cv_pct"]))


def test_fused_sweep_interface_matches_scan_metrics():
    """Kernel-speed interface sweep: tangent-based Snell errors agree with
    the scan tier's history-secant errors at accepted-candidate scales."""
    import raytracing_tpu as rt
    from raytracing_tpu.parallel.sweep import run_candidates, run_candidates_fused
    scen = rt.scenario("interface")
    med = rt.analytic_medium("interface")
    ds = np.asarray([config.SIGMA / 2.8, config.SIGMA / 2.0], np.float64)
    sizes = np.ceil(scen.s_max / ds).astype(np.int64) + 1
    fused = run_candidates_fused("op8", scen, ds, sizes - 1,
                                 int(sizes.max()) - 1, block_rays=128,
                                 rays=128)
    scan = run_candidates("op8", scen, med, ds, sizes - 1, int(sizes.max()))
    np.testing.assert_allclose(fused["mean_err"], scan["mean_err"], atol=0.02)
    np.testing.assert_allclose(fused["max_err"], scan["max_err"], atol=0.05)


def test_fused_sweep_vert_cv_matches_scan():
    import raytracing_tpu as rt
    from raytracing_tpu.parallel.sweep import run_candidates, run_candidates_fused
    scen = rt.scenario("vert")
    med = rt.analytic_medium("vert_heterogeneous")
    ds = np.asarray([config.SIGMA / 0.5, config.SIGMA / 0.2], np.float64)
    sizes = np.ceil(scen.s_max / ds).astype(np.int64) + 1
    fused = run_candidates_fused("op8", scen, ds, sizes - 1,
                                 int(sizes.max()) - 1, block_rays=128,
                                 rays=128)
    scan = run_candidates("op8", scen, med, ds, sizes - 1, int(sizes.max()))
    # scan tier computes CV at f32 too; agreement well under the 0.05 %
    # acceptance threshold is what matters
    np.testing.assert_allclose(fused["cv_pct"], scan["cv_pct"], atol=5e-3)


def test_fused_sweep_stratified_medium():
    """The sweep runs on the reference-faithful sampled medium at kernel tier."""
    import raytracing_tpu as rt
    from raytracing_tpu.media.spline import build_stratified_medium
    from raytracing_tpu.parallel.sweep import run_candidates_fused
    scen = rt.scenario("interface")
    med = build_stratified_medium("interface", scen.box, dtype=np.float32)
    ds = np.asarray([config.SIGMA / 2.8], np.float64)
    sizes = np.ceil(scen.s_max / ds).astype(np.int64) + 1
    out = run_candidates_fused("op8", scen, ds, sizes - 1,
                               int(sizes.max()) - 1, medium=med,
                               block_rays=128, rays=128)
    assert out["mean_err"][0] < 0.2  # the calibrated-step oracle bound


def test_fused_sweep_supported_matrix():
    import raytracing_tpu as rt
    from raytracing_tpu.media.spline import build_stratified_medium
    from raytracing_tpu.parallel.sweep import fused_sweep_supported
    iface = rt.scenario("interface")
    assert fused_sweep_supported("op8", iface, rt.analytic_medium("interface"))
    assert fused_sweep_supported(
        "op8", iface, build_stratified_medium("interface", iface.box))
    # golden ops are covered too (transcendental-free golden kernels)
    assert fused_sweep_supported("op5", iface, rt.analytic_medium("interface"))
    aniso = rt.scenario("aniso")
    assert fused_sweep_supported("op10", aniso,
                                 rt.analytic_medium("vert_heterogeneous"))
    assert not fused_sweep_supported("op10", rt.scenario("fisheye"),
                                     None)


def test_fused_sweep_aniso_golden_cv_matches_scan():
    """Aniso kernel-tier sweep: golden op10 with the in-kernel anisotropic
    Welford tracker agrees with the FLOAT64 scan tier — the polished golden
    kernel (kernels.golden.GOLD_POLISH) resolves the discretization CV that
    the f32 scan tier's own bracket noise (~0.3 %) used to bury."""
    import raytracing_tpu as rt
    from raytracing_tpu.parallel.sweep import run_candidates, run_candidates_fused
    scen = rt.scenario("aniso")
    med = rt.analytic_medium("vert_heterogeneous")
    ds = np.asarray([config.SIGMA / 0.5, config.SIGMA / 0.2], np.float64)
    sizes = np.ceil(scen.s_max / ds).astype(np.int64) + 1
    fused = run_candidates_fused("op10", scen, ds, sizes - 1,
                                 int(sizes.max()) - 1, block_rays=128,
                                 rays=128)
    scan = run_candidates("op10", scen, med, ds, sizes - 1, int(sizes.max()),
                          dtype=np.float64)
    np.testing.assert_allclose(fused["cv_pct"], scan["cv_pct"], atol=1e-3)


def test_grid_sweep_rejects_golden_and_small_grids():
    """Grid media sweep on the scan tier: the kernel sweep refuses them by
    name (it would otherwise trace the scenario's analytic field), the
    support matrix says so, and ``delta_s_search(engine="fused")`` raises
    before tracing anything."""
    import raytracing_tpu as rt
    from raytracing_tpu.media.hermite import build_hermite_medium
    from raytracing_tpu.media.spline import grid_medium_from_samples
    from raytracing_tpu.parallel.sweep import (delta_s_search,
                                               fused_sweep_supported,
                                               run_candidates_fused)

    scen = rt.scenario("fisheye")
    x = np.linspace(-1.5, 1.5, 9)
    X, Y = np.meshgrid(x, x)
    gm = grid_medium_from_samples(1.0 / (1.0 + X ** 2 + Y ** 2), x, x,
                                  dtype=np.float32)
    for med in (gm, build_hermite_medium(gm)):
        for op in ("op1", "op5"):
            with pytest.raises(ValueError, match="scan tier"):
                run_candidates_fused(op, scen, np.float32([0.1, 0.2]),
                                     np.float32([10, 10]), 10, medium=med,
                                     rays=128, block_rays=128,
                                     interpret=True)
            assert not fused_sweep_supported(op, scen, med)
        with pytest.raises(ValueError, match="does not cover"):
            delta_s_search("op1", scen, med, engine="fused")


def test_grid_sweep_op7_batched():
    """op7 (MxSA, a named algorithm of the paper, RT_bench.py:21-27,
    626-650) calibrates on the sampled medium: the scan-tier sweep on the
    2-D spline agrees with the kernel sweep on the analytic field it
    samples to the spline's own fit error."""
    import raytracing_tpu as rt
    from raytracing_tpu.media.spline import build_grid_medium
    from raytracing_tpu.parallel.sweep import (run_candidates,
                                               run_candidates_fused)

    scen = rt.scenario("fisheye")
    gm = build_grid_medium("fisheye", scen.box, dtype=np.float32)
    divs = np.array([60, 200], np.int64)
    ds = (2 * np.pi / divs).astype(np.float32)
    sizes = 1 * divs
    g = run_candidates_fused("op7", scen, ds, sizes - 1,
                             int(sizes.max()) - 1, rays=128,
                             block_rays=128, interpret=True)
    s = run_candidates("op7", scen, gm, ds, sizes - 1, int(sizes.max()),
                       n_turns=1, dtype=np.float32)
    assert np.all(np.isfinite(s["closure_pct"]))
    np.testing.assert_allclose(g["closure_pct"], s["closure_pct"], atol=5e-2)


def test_grid_medium_sweep_matches_scan():
    """DELTA_S candidates on the 2-D sampled-spline medium (the reference
    calibrates ON this spline, RT_bench.py:435-464) run on the scan tier:
    ``delta_s_search`` routes them there and its metrics equal the direct
    scan-engine sweep."""
    import raytracing_tpu as rt
    from raytracing_tpu.media.spline import build_grid_medium
    from raytracing_tpu.parallel.sweep import delta_s_search, run_candidates

    scen = rt.scenario("fisheye")
    gm = build_grid_medium("fisheye", scen.box, dtype=np.float32)
    divs = np.array([300.0, 40.0, 6.0])
    sr = delta_s_search("op6", scen, gm, divisors=divs, n_turns=1,
                        engine="auto")
    ds = 2 * np.pi / divs
    sizes = sw._max_sizes(scen, ds, divs + 1, 1)
    s = run_candidates("op6", scen, gm, ds, sizes - 1, int(sizes.max()),
                       n_turns=1, dtype=np.float32)
    np.testing.assert_allclose(sr.metrics["closure_pct"], s["closure_pct"],
                               rtol=1e-6)
    assert sr.metrics["closure_pct"][0] < sr.metrics["closure_pct"][-1]


def test_convergence_search_user_medium():
    """Richardson self-convergence calibration on a measured profile: no
    physics oracle needed; acceptance = halving the step moves no final
    position beyond tol (coarsest-accepted, reference sweep order)."""
    y = np.linspace(-2.0, 1.0, 61)
    med = rt.c1_stratified_from_samples(1.0 + 0.3 * np.tanh(2.0 * y), y)
    r = 64
    pos0 = np.stack([np.zeros(r, np.float32),
                     np.linspace(-1.5, -0.5, r, dtype=np.float32)], -1)
    theta0 = np.full(r, 0.3, np.float32)
    arc = 1.0
    cands = arc / np.array([10.0, 20.0, 40.0, 80.0])
    sr = sw.delta_s_search_convergence(
        "op6", med, pos0=pos0, theta0=theta0, arc_length=arc,
        box=(-5.0, 5.0, -2.0, 1.0), candidates=cands, tol=1e-4,
        block_rays=128)
    errs = sr.metrics["halving_err"]
    assert sr.index is not None
    assert errs[sr.index] < 1e-4
    # one-step methods: halving error shrinks ~linearly with the step
    finite = errs[np.isfinite(errs)]
    assert np.all(np.diff(finite) < 0)
    # everything past the accepted candidate is untraced
    assert np.all(np.isnan(errs[sr.index + 1:]))
    assert sr.delta_s_selected == pytest.approx(float(cands[sr.index]))
    # coarsest-accepted: the candidate before the accepted one FAILED
    if sr.index > 0:
        assert errs[sr.index - 1] >= 1e-4

    with pytest.raises(ValueError, match="descend"):
        sw.delta_s_search_convergence(
            "op6", med, pos0=pos0, theta0=theta0, arc_length=arc,
            box=(-5.0, 5.0, -2.0, 1.0), candidates=cands[::-1], tol=1e-4)
    with pytest.raises(ValueError, match="arc_length"):
        sw.delta_s_search_convergence(
            "op6", med, pos0=pos0, theta0=theta0, arc_length=-1.0,
            box=(-5.0, 5.0, -2.0, 1.0), candidates=cands, tol=1e-4)
