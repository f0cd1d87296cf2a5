"""Physics oracles: the reference's built-in validation metrics as functions.

The reference validates inline in the main path (SURVEY.md §4): Snell-law
outbound angles for the interface (RT_bench.py:896-919), exact closure for
the fisheye (RT_bench.py:956, 1393), and conservation of horizontal momentum
p_x for the stratified scenarios (RT_bench.py:957-958, 1352-1360).  Here they
are standalone, batched device functions over :class:`TraceResult`, plus an
extra oracle the reference lacks: RMS trajectory error against the analytic
fisheye circle (the north-star accuracy metric).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from raytracing_tpu.engine.trace import TraceResult


def closure_error_pct(result: TraceResult, row: int | None = None):
    """Fisheye closure error, percent of the unit-circle circumference.

    100 * |(1, 0) - final_pos| / (2 pi)  (RT_bench.py:956, 1393).  The
    reference reads ``s_ray[-1]``; with padded scans pass ``row`` to read the
    effective last row instead.
    """
    if result.history is not None and row is not None:
        pos = result.history[row, :, 0:2]
    else:
        pos = result.final.pos
    target = jnp.array([1.0, 0.0], dtype=pos.dtype)
    return 100.0 * jnp.linalg.norm(pos - target, axis=-1) / (2.0 * np.pi)


def snell_errors_deg(result: TraceResult, theta0):
    """Interface outbound-angle errors in degrees, one per ray.

    Port of RT_bench.py:896-919: the expected angle comes from total internal
    reflection (launch < pi/4) or Snell refraction (launch > pi/4); the
    simulated angle from the trajectory slope over the 90-95 % tail segment
    of each ray's history.  Requires history mode.
    """
    if result.history is None:
        raise ValueError("snell oracle needs history mode")
    theta0 = jnp.asarray(theta0)
    deg = 180.0 / jnp.pi

    # Expected angle (RT_bench.py:902-908).
    refl = 90.0 - deg * theta0
    refr = deg * jnp.arcsin(jnp.sqrt(2.0) * jnp.sin(jnp.pi / 2.0 - theta0))
    angreal = jnp.where(theta0 < jnp.pi / 4.0, refl,
                        jnp.where(theta0 == jnp.pi / 4.0, 0.0, refr))

    # Simulated angle from the tail slope (RT_bench.py:910-916).  Integer
    # index arithmetic reproduces int(9.5*i/10) / int(9*i/10) exactly.
    i = result.exit_step.astype(jnp.int32)
    idx95 = (19 * i) // 20
    idx90 = (9 * i) // 10
    x = result.history[:, :, 0]   # (max_size, R)
    y = result.history[:, :, 1]
    ray_idx = jnp.arange(x.shape[1])
    distx = x[idx95, ray_idx] - x[idx90, ray_idx]
    disty = y[idx95, ray_idx] - y[idx90, ray_idx]
    angsim = deg * jnp.arctan(jnp.abs(distx / disty))
    return jnp.abs(angsim - angreal)


def snell_expected_deg(theta0):
    """Expected outbound angle (deg) per launch angle (RT_bench.py:902-908)."""
    theta0 = np.asarray(theta0)
    deg = 180.0 / np.pi
    with np.errstate(invalid="ignore"):  # arcsin>1 on the reflection branch
        refr = deg * np.arcsin(np.sqrt(2.0) * np.sin(np.pi / 2.0 - theta0))
    return np.where(theta0 < np.pi / 4.0, 90.0 - deg * theta0,
                    np.where(theta0 == np.pi / 4.0, 0.0, refr))


def snell_errors_from_tangent(tangent, theta0):
    """Interface Snell errors (deg) from final unit tangents.

    Kernel-tier variant of :func:`snell_errors_deg`: past the interface the
    ray is straight, so the frozen exit tangent equals the reference's
    history-tail secant (RT_bench.py:910-916) to f32 rounding
    (docs/PARITY.md #23).  ``tangent`` is (R, 2); uses the first
    ``len(theta0)`` rays.
    """
    nf = len(np.asarray(theta0))
    t = np.asarray(tangent[:nf])
    deg = 180.0 / np.pi
    angsim = deg * np.arctan(np.abs(t[:, 0] / t[:, 1]))
    return np.abs(angsim - snell_expected_deg(theta0))


def format_num(num: float) -> str:
    """Column-aligned number formatting of the per-ray Snell table
    (RT_bench.py:929-943)."""
    if num < 0:
        return f"{num: >10.8f}" if abs(num) < 10 else f"{num: >10.7f}"
    return f"{num: >10.9f}" if num < 10 else f"{num: >10.8f}"


def snell_report(result: TraceResult, theta0, printer=print):
    """Per-ray Snell table, the reference's ``show=True`` output
    (RT_bench.py:921-945)."""
    errs = np.asarray(snell_errors_deg(result, theta0))
    theta0 = np.asarray(theta0)
    deg = 180.0 / np.pi
    refl = 90.0 - deg * theta0
    with np.errstate(invalid="ignore"):  # arcsin>1 on the reflection branch
        refr = deg * np.arcsin(np.sqrt(2.0) * np.sin(np.pi / 2.0 - theta0))
    angreal = np.where(theta0 < np.pi / 4.0, refl,
                       np.where(theta0 == np.pi / 4.0, 0.0, refr))
    hist = np.asarray(result.history)
    exit_step = np.asarray(result.exit_step)
    for k in range(len(theta0)):
        i = int(exit_step[k])
        a, b = hist[i, k, 0], hist[i, k, 1]
        # simulated angle from the tail slope, as in snell_errors_deg
        i95, i90 = (19 * i) // 20, (9 * i) // 10
        distx = hist[i95, k, 0] - hist[i90, k, 0]
        disty = hist[i95, k, 1] - hist[i90, k, 1]
        c = deg * np.arctan(np.abs(distx / disty))
        printer(f"Coords: [ {format_num(a)} , {format_num(b)} ] | "
                f"SimAng: {format_num(c)} | SnellAng: {format_num(angreal[k])} | "
                f"Err: {format_num(errs[k])} | InitAng: {format_num(theta0[k] * deg)}")
    return errs


def momentum_cv_pct_from_history(result: TraceResult):
    """Per-ray coefficient of variation (%) of p_x over written history rows.

    Port of RT_bench.py:1356-1359: the reference masks exact zeros out of the
    p_x column — which, given zero-initialized storage, selects precisely the
    rows written before boundary exit.  Here the row mask is explicit:
    ``row <= exit_step``.  Population std (ddof=0), matching np.std defaults.
    """
    if result.history is None:
        raise ValueError("momentum CV from history needs history mode")
    mx = result.history[:, :, 2]                     # (max_size, R)
    rows = jnp.arange(mx.shape[0])[:, None]
    mask = rows <= result.exit_step[None, :].astype(rows.dtype)
    cnt = jnp.sum(mask, axis=0)
    mean = jnp.sum(jnp.where(mask, mx, 0.0), axis=0) / cnt
    var = jnp.sum(jnp.where(mask, (mx - mean[None, :]) ** 2, 0.0), axis=0) / cnt
    return 100.0 * jnp.sqrt(var) / mean


def momentum_cv_pct_from_welford(count, mean, m2):
    """Per-ray CV (%) from raw Welford aggregates (count, mean, M2).

    The single home for the conservation metric (RT_bench.py:1356-1359,
    population std): every surface that reads a kernel momentum tracker —
    ``fast_trace(stats=True)``, serve, CLI, bench, examples — computes CV
    through this helper.  Accepts any array-likes; returns a NumPy array.

    The mean enters as ``|mean|`` so leftward rays (p_x < 0) still get a
    positive CV.  A ray whose invariant is ~0 (theta at exactly ±pi/2:
    p_x = n·cos(theta) ≈ 0) has no meaningful *relative* spread — its
    entry comes back inf/nan; summarizing surfaces reduce over the finite
    entries via :func:`momentum_cv_summary`.
    """
    count = np.asarray(count, np.float64)
    mean = np.asarray(mean, np.float64)
    m2 = np.asarray(m2, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return 100.0 * np.sqrt(m2 / count) / np.abs(mean)


def momentum_cv_summary(cv):
    """``(mean, max, n_excluded)`` over the finite entries of a CV array.

    ``n_excluded`` counts rays with no resolvable invariant (p_x ≈ 0 →
    inf/nan CV, see :func:`momentum_cv_pct_from_welford`); when every ray
    is excluded, mean and max are ``nan`` — JSON surfaces map that to
    null rather than emitting non-standard ``Infinity``/``NaN`` tokens.
    """
    cv = np.asarray(cv, np.float64).reshape(-1)
    finite = cv[np.isfinite(cv)]
    n_excluded = int(cv.size - finite.size)
    if finite.size == 0:
        return float("nan"), float("nan"), n_excluded
    return float(finite.mean()), float(finite.max()), n_excluded


def momentum_cv_pct_from_stats(result: TraceResult):
    """Per-ray CV (%) from the carry's Welford tracker (metrics mode)."""
    st = result.final
    if st.mom_count is None:
        raise ValueError("trace ran without momentum statistics")
    var = st.mom_m2 / st.mom_count
    return 100.0 * jnp.sqrt(var) / st.mom_mean


def scenario_average_cv_pct(per_ray_cv):
    """Scenario-level CV: mean over interior rays (RT_bench.py:1356-1360).

    The reference averages rays 1 .. ray_count-2, excluding the first and
    last rays of the fan.
    """
    return jnp.mean(per_ray_cv[1:-1])


def fisheye_rms_error(result: TraceResult, delta_s):
    """RMS distance between the traced ray and the analytic unit circle.

    The fisheye ray launched from (1, 0) with angle pi/2 follows the unit
    circle at unit speed in arc length: pos(s) = (cos s, sin s).  This is the
    north-star accuracy target (RMS <= 1e-6); the reference itself only
    checks closure at full turns.  Uses float64 reference positions.
    """
    if result.history is None:
        raise ValueError("fisheye RMS needs history mode")
    xy = np.asarray(result.history[:, :, 0:2], dtype=np.float64)  # (S, R, 2)
    s = np.arange(xy.shape[0], dtype=np.float64) * float(delta_s)
    ref = np.stack([np.cos(s), np.sin(s)], axis=-1)[:, None, :]
    err = np.linalg.norm(xy - ref, axis=-1)
    return float(np.sqrt(np.mean(err ** 2)))
