"""Minimal production serving layer: ray tracing over HTTP.

The reference is an interactive stdin script; a production deployment wants
a long-lived process with warm compiled kernels answering requests.  This is
a dependency-free (stdlib http.server) JSON API over the fused-kernel tier:

    GET  /healthz            -> {"status": "ok", "device": ...}
    GET  /v1/models          -> scenarios, ops, extensions
    POST /v1/trace           -> {"scenario", "op", "rays", "n_turns", ...}
                                => final-state metrics + throughput
    POST /v1/trace_samples   -> {"samples", "x", "y", "family", "launch",
                                "delta_s", "steps", ...} — trace through a
                                MEASURED medium posted in the request (2-D
                                index grid or 1-D profile; parity or C1
                                family), no named field required
    POST /v1/calibrate_samples -> {"samples", ..., "arc_length", "tol"} —
                                pick delta_s for that medium by Richardson
                                self-convergence (measured media have no
                                closed-form physics oracle)
    POST /v1/trace3d_samples -> {"samples", "y" (+ "x"/"z" for 3-D grids),
                                "op", "delta_s", "steps", "pos0"/"dir0" or
                                a "launch" cone} — 3-D tracing of a posted
                                1-D profile (lifted, n = n(y)) or a 3-D
                                (nz, ny, nx) measured grid (tri-Hermite
                                tables, media/grid3.py), with the
                                horizontal-slowness conservation report
    POST /v1/eigenrays       -> {"samples", ..., "source", "receivers",
                                "delta_s", "steps", "fan", "omega"?} —
                                boundary-value arrivals through the posted
                                medium: travel time / amplitude / KMAH per
                                multipath arrival + per-receiver TL
                                (engine/eigenray.py)
    POST /v1/eigenrays3      -> {"samples", "y", "source", "receivers",
                                "delta_s", "steps", "fan", "omega"?} —
                                the 3-D twin: two-angle Gauss-Newton
                                arrivals through the lifted profile
                                (engine/eigenray3d.py)

Compiled executables are cached by (op, field, steps, block) through the
jit caches underneath ``fast_trace``, so the first request per
configuration pays compilation and subsequent ones run at kernel speed.

    python -m raytracing_tpu.serve --port 8080
"""
from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

import jax

import raytracing_tpu as rt
from raytracing_tpu import config
from raytracing_tpu.calibrated import calibrated as calibrated_table
from raytracing_tpu.engine import oracles
from raytracing_tpu.engine.fast import fast_trace
from raytracing_tpu.ops.registry import (EXTENSION_OPS, GOLDEN_OPS, OP_NAMES,
                                         canonical)


# Serving-side resource bounds.  ``steps`` is a static kernel trip count:
# each new value compiles a fresh executable, and huge trip counts both
# blow the compile budget and hold the device for unbounded time — so
# every derived step count is capped, not just ``rays``.
MAX_RAYS = 16_777_216
MAX_STEPS = 2_000_000
MAX_TURNS = 1_000
MAX_SAMPLE_VALUES = 4_000_000   # host spline fit + device table bound
MAX_RETURNED_RAYS = 65_536      # cap on positions echoed back in JSON


def _trace_request(body: dict) -> dict:
    scen = config.scenario(str(body.get("scenario", "fisheye")))
    op = canonical(str(body.get("op", "op6")))
    rays = int(body.get("rays", 1024))
    if not 1 <= rays <= MAX_RAYS:
        raise ValueError(f"rays must be in [1, {MAX_RAYS}], got {rays}")
    n_turns = int(body.get("n_turns", 1))
    if not 1 <= n_turns <= MAX_TURNS:
        raise ValueError(f"n_turns must be in [1, {MAX_TURNS}], got {n_turns}")

    if "delta_s" in body:
        delta_s = float(body["delta_s"])
        if not (np.isfinite(delta_s) and delta_s > 0):
            raise ValueError(f"delta_s must be finite and > 0, got {delta_s}")
        divisor = int(body.get("divisor", round(2 * np.pi / delta_s))) if scen.is_fisheye else None
        if divisor is not None and not 1 <= divisor <= MAX_STEPS:
            raise ValueError(f"divisor must be in [1, {MAX_STEPS}], got {divisor}")
    else:
        from raytracing_tpu.calibrated import calibrated_with_fallback
        delta_s, divisor = calibrated_with_fallback(op, scen.name)

    if scen.is_fisheye:
        theta0 = np.full(rays, np.pi / 2.0, np.float32)
        pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (rays, 1))
        steps = scen.max_size(delta_s, int(divisor) + 1, n_turns) - 1
    else:
        theta0 = np.linspace(scen.theta0[0], scen.theta0[-1], rays).astype(np.float32)
        pos0 = np.tile(scen.pos0[:1].astype(np.float32), (rays, 1))
        steps = scen.max_size(delta_s) - 1
    if not 1 <= steps <= MAX_STEPS:
        raise ValueError(
            f"configuration implies {steps} integration steps "
            f"(bounds: [1, {MAX_STEPS}]); raise delta_s or lower n_turns")

    medium_kind = str(body.get("medium", "analytic"))
    if medium_kind == "analytic":
        medium = rt.analytic_medium(scen.field)
    elif medium_kind == "stratified":
        if scen.is_fisheye:
            raise ValueError("stratified medium needs an x-independent "
                             "field; fisheye samples in 2-D — use "
                             "medium=grid")
        from raytracing_tpu import models
        medium = models.get(scen.name, medium="stratified").medium
    elif medium_kind == "grid":
        # the reference's full 2-D sampled-spline pipeline; fast_trace
        # routes it through the scan tier (models caches the
        # sampled tables per scenario)
        from raytracing_tpu import models
        medium = models.get(scen.name, medium="grid").medium
    elif medium_kind in ("c1", "c1-stratified"):
        # consistent-gradient family (media/c1.py, PARITY.md #29)
        if medium_kind == "c1-stratified" and scen.is_fisheye:
            raise ValueError("c1-stratified needs an x-independent field; "
                             "fisheye samples in 2-D — use medium=c1")
        from raytracing_tpu import models
        medium = models.get(scen.name, medium=medium_kind).medium
    else:
        raise ValueError(f"medium must be 'analytic', 'stratified', 'grid', "
                         f"'c1' or 'c1-stratified', got {medium_kind!r}")
    precision = str(body.get("precision", "standard"))
    t0 = time.perf_counter()
    out = fast_trace(op, scen, medium, delta_s=delta_s, steps=steps,
                     pos0=pos0, theta0=theta0, precision=precision)
    pos = np.asarray(out.pos)
    dt = time.perf_counter() - t0

    resp = {
        "scenario": scen.name, "op": op, "rays": rays, "steps": int(steps),
        "medium": medium_kind,
        "delta_s": float(delta_s), "engine": out.engine,
        "seconds": round(dt, 4),
        "ray_steps_per_sec": round(rays * steps / dt, 1),
        "escaped_rays": int(rays - np.asarray(out.active).sum()),
        "mean_final_pos": [float(v) for v in pos.mean(0)],
    }
    if scen.is_fisheye:
        resp["closure_error_pct"] = float(
            100 * np.linalg.norm(pos[0] - [1, 0]) / (2 * np.pi))
    return resp


def _finite(name: str, a: np.ndarray) -> np.ndarray:
    if not np.all(np.isfinite(a)):
        raise ValueError(f"{name} must be finite")
    return a


def _samples_medium(body: dict):
    """(medium, default_box, family, kind) from a posted samples body.

    Validation (finiteness, size caps) is the endpoint's job; the
    samples->medium dispatch itself is the shared
    media/samples.medium_from_samples used by the CLI too.
    """
    from raytracing_tpu.media.samples import medium_from_samples

    family = str(body.get("family", "parity"))
    if "samples" not in body:
        raise ValueError("this endpoint needs 'samples' (1-D profile or "
                         "2-D grid of refractive-index values)")
    samples = _finite("samples", np.asarray(body["samples"], np.float64))
    if not 0 < samples.size <= MAX_SAMPLE_VALUES:
        raise ValueError(f"samples size must be in [1, {MAX_SAMPLE_VALUES}],"
                         f" got {samples.size}")
    y = _finite("y", np.asarray(body.get("y", ()), np.float64))
    x = (_finite("x", np.asarray(body["x"], np.float64))
         if "x" in body else None)
    medium, default_box, kind = medium_from_samples(samples, x, y,
                                                    family=family)
    return medium, default_box, family, kind


def _launch_fan(body: dict, max_rays: int = MAX_RAYS):
    """(pos0, theta0, rays) from explicit arrays or a compact fan spec.

    ``max_rays`` is the endpoint's cap, enforced BEFORE the fan arrays are
    built so a hostile count never allocates (calibration caps far below
    the trace endpoints' MAX_RAYS).
    """
    if "pos0" in body:
        pos0 = _finite("pos0", np.asarray(body["pos0"], np.float32))
        theta0 = _finite("theta0",
                         np.asarray(body.get("theta0", ()), np.float32))
        if pos0.ndim != 2 or pos0.shape[1] != 2 or len(theta0) != len(pos0):
            raise ValueError("pos0 must be (rays, 2) with theta0 (rays,), "
                             f"got {pos0.shape} / {theta0.shape}")
        rays = len(pos0)
        if not 1 <= rays <= max_rays:
            raise ValueError(f"rays must be in [1, {max_rays}], got {rays}")
    else:
        fan = body.get("launch")
        if not isinstance(fan, dict):
            raise ValueError("this endpoint needs 'pos0'/'theta0' arrays or "
                             "a 'launch' fan {'x':…, 'y':[lo,hi], 'theta':…}")
        rays = int(body.get("rays", 1024))
        if not 1 <= rays <= max_rays:
            raise ValueError(f"rays must be in [1, {max_rays}], got {rays}")
        fx = float(fan["x"])
        fy = np.asarray(fan["y"], np.float64).reshape(-1)
        th = np.asarray(fan.get("theta", 0.0), np.float64).reshape(-1)
        if len(fy) == 0 or len(th) == 0:
            raise ValueError("launch 'y' and 'theta' must be non-empty")
        _finite("launch", np.concatenate([[fx], fy, th]))
        pos0 = np.stack([np.full(rays, fx, np.float32),
                         np.linspace(fy[0], fy[-1], rays,
                                     dtype=np.float32)], -1)
        theta0 = (np.full(rays, th[0], np.float32) if len(th) == 1
                  else np.linspace(th[0], th[-1], rays, dtype=np.float32))
    return pos0, theta0, rays


def _samples_scenario(body: dict, default_box):
    import dataclasses

    box = tuple(float(v) for v in body.get("box", default_box))
    if len(box) != 4 or not np.all(np.isfinite(box)):
        raise ValueError(f"box must be 4 finite floats, got {box!r}")
    if not (box[0] < box[1] and box[2] < box[3]):
        raise ValueError(f"box must be ordered (x0 < x1, y0 < y1), "
                         f"got {box!r}")
    gamma = float(body.get("gamma", 1.0))
    if not np.isfinite(gamma):
        raise ValueError("gamma must be finite")
    return dataclasses.replace(config.scenario("fisheye"), name="samples",
                               gamma=gamma, box=box)


def _calibrate_samples_request(body: dict) -> dict:
    """Pick delta_s for a POSTed measured medium by self-convergence.

    Measured media have no closed-form physics oracle, so acceptance is
    Richardson halving (parallel/sweep.delta_s_search_convergence): the
    coarsest candidate step whose halving moves no final position beyond
    ``tol`` over ``arc_length``.  Candidates (optional, descending step
    sizes) default to arc_length / {50, 100, ..., 6400}.
    """
    from raytracing_tpu.parallel.sweep import delta_s_search_convergence

    medium, default_box, family, kind = _samples_medium(body)
    pos0, theta0, rays = _launch_fan(body, max_rays=65536)
    scen = _samples_scenario(body, default_box)
    op = canonical(str(body.get("op", "op6")))
    arc = float(body.get("arc_length", 0.0))
    tol = float(body.get("tol", 1e-4))
    if not (np.isfinite(tol) and tol > 0):
        raise ValueError(f"tol must be finite and > 0, got {tol}")
    cands = body.get("candidates")
    if cands is not None:
        cands = _finite("candidates", np.asarray(cands, np.float64))
        if not 1 <= len(cands) <= 16:
            raise ValueError("candidates caps at 16 entries")
        if np.any(cands <= 0):
            raise ValueError("candidates must be positive step sizes")
    if not (np.isfinite(arc) and 0 < arc):
        raise ValueError(f"calibrate needs 'arc_length' > 0, got {arc}")
    finest = float(cands.min()) if cands is not None else arc / 6400.0
    if arc / finest * 2 > MAX_STEPS:
        raise ValueError(f"finest candidate implies "
                         f"{int(arc / finest * 2)} halving steps "
                         f"(bound {MAX_STEPS})")

    t0 = time.perf_counter()
    sr = delta_s_search_convergence(
        op, medium, pos0=pos0, theta0=theta0, arc_length=arc,
        box=scen.box, gamma=scen.gamma, candidates=cands, tol=tol,
        block_rays=128)
    dt = time.perf_counter() - t0
    errs = sr.metrics["halving_err"]
    return {
        "op": op, "family": family, "medium_kind": kind, "rays": rays,
        "arc_length": arc, "tol": tol,
        "delta_s": sr.delta_s_selected,
        "steps": int(sr.divisor) if sr.divisor is not None else None,
        "accepted": sr.index is not None,
        "candidates": [float(v) for v in sr.delta_s],
        "halving_err": [None if np.isnan(e) else float(e) for e in errs],
        "seconds": round(dt, 4),
    }


def _trace_samples_request(body: dict) -> dict:
    """Trace through a USER-measured medium posted in the request body.

    The reference can only trace its four hard-coded fields; this endpoint
    serves arbitrary measured data: a 2-D index grid (``samples`` (ny, nx)
    with coordinate vectors ``x``/``y``) or a 1-D profile (``samples``
    (ny,) with ``y`` — e.g. sound speed vs depth), through the parity
    pipeline (default) or the consistent-gradient C1 family
    (``family: "c1"``).  Launch is either explicit ``pos0``/``theta0``
    arrays or a compact fan ``launch: {"x": .., "y": [lo, hi],
    "theta": t | [lo, hi]}`` expanded to ``rays`` rays.
    """
    medium, default_box, family, kind = _samples_medium(body)

    if "delta_s" not in body:
        raise ValueError("trace_samples needs 'delta_s' (no calibrated "
                         "table exists for user media; run the DELTA_S "
                         "search offline)")
    delta_s = float(body["delta_s"])
    if not (np.isfinite(delta_s) and delta_s > 0):
        raise ValueError(f"delta_s must be finite and > 0, got {delta_s}")
    steps = int(body.get("steps", 0))
    if not 1 <= steps <= MAX_STEPS:
        raise ValueError(f"steps must be in [1, {MAX_STEPS}], got {steps}")

    pos0, theta0, rays = _launch_fan(body)
    scen = _samples_scenario(body, default_box)
    op = canonical(str(body.get("op", "op6")))
    return_positions = bool(body.get("return_positions", False))
    if return_positions and rays > MAX_RETURNED_RAYS:
        raise ValueError(f"return_positions caps at {MAX_RETURNED_RAYS} "
                         f"rays, got {rays}")
    report_cv = bool(body.get("report_conservation", False))
    if report_cv and kind != "profile":
        raise ValueError("report_conservation needs a 1-D profile medium "
                         "(p_x is only an invariant in stratified media)")

    t0 = time.perf_counter()
    out = fast_trace(op, scen, medium, delta_s=delta_s, steps=steps,
                     pos0=pos0, theta0=theta0, stats=report_cv,
                     block_rays=128)
    pos = np.asarray(out.pos)
    dt = time.perf_counter() - t0

    resp = {
        "op": op, "rays": rays, "steps": steps, "family": family,
        "medium_kind": kind,
        "delta_s": delta_s, "engine": out.engine,
        "seconds": round(dt, 4),
        "ray_steps_per_sec": round(rays * steps / dt, 1),
        "escaped_rays": int(rays - np.asarray(out.active).sum()),
        "mean_final_pos": [float(v) for v in pos.mean(0)],
    }
    if report_cv:
        cv = oracles.momentum_cv_pct_from_welford(
            out.mom_count, out.mom_mean, out.mom_m2)
        cv_mean, cv_max, n_excluded = oracles.momentum_cv_summary(cv)
        # rays with p_x ~ 0 (theta at +-pi/2) have no relative spread; they
        # are excluded rather than emitting non-JSON Infinity/NaN tokens
        resp["momentum_cv_pct_mean"] = (None if np.isnan(cv_mean)
                                        else cv_mean)
        resp["momentum_cv_pct_max"] = None if np.isnan(cv_max) else cv_max
        if n_excluded:
            resp["momentum_cv_rays_excluded"] = n_excluded
    if return_positions:
        resp["pos"] = pos.astype(float).tolist()
        resp["active"] = np.asarray(out.active).astype(bool).tolist()
    return resp


# fan_count * steps bound.  Historically the f64 full-history RAM cap;
# both solvers are history-free now (round-4 2-D, round-5 3-D: on-device
# crossing records, (F, NR, max_ord, 2) readbacks), so this is a
# per-request COMPUTE budget — ~64M fan ray-steps is seconds of chip or
# host time — not a memory wall.
MAX_EIGEN_ELEMS = 64_000_000
MAX_RECEIVERS = 128
MAX_FAN = 1024


def _eigenrays_request(body: dict) -> dict:
    """Boundary-value arrivals source -> receivers through a POSTed medium.

    Serves the dynamic tier (engine/eigenray.py): every multipath arrival
    at each receiver with travel time, amplitude, KMAH caustic count and
    launch angle, plus incoherent transmission loss per receiver (and
    coherent TL when ``omega`` — radians per traveltime unit — is given).
    The medium is measured data exactly as in /v1/trace_samples; tables
    are built float64 (the landing-curve noise floor of f32 tables defeats
    the Newton polish — engine/eigenray.py dtype note).
    """
    from raytracing_tpu.engine import eigenray as er
    from raytracing_tpu.media.samples import medium_from_samples

    family = str(body.get("family", "parity"))
    if "samples" not in body:
        raise ValueError("this endpoint needs 'samples' (1-D profile or "
                         "2-D grid of refractive-index values)")
    samples = _finite("samples", np.asarray(body["samples"], np.float64))
    if not 0 < samples.size <= MAX_SAMPLE_VALUES:
        raise ValueError(f"samples size must be in [1, {MAX_SAMPLE_VALUES}],"
                         f" got {samples.size}")
    y = _finite("y", np.asarray(body.get("y", ()), np.float64))
    x = (_finite("x", np.asarray(body["x"], np.float64))
         if "x" in body else None)
    # "on_device": solve on the server's accelerator in f32 with the
    # split-word-evaluated profile (engine/df_grid.DfEvalProfile —
    # correctly-rounded f32 of the f64 interpolant; measured floors in
    # docs/PRECISION.md round-4 addendum 2) instead of host/f64.  The
    # history-free crossing scans make this the serving-scale path: only
    # O(receivers) scalars cross the device link per Newton iteration.
    on_device = bool(body.get("on_device", False))
    if on_device:
        if samples.ndim != 1 or x is not None:
            raise ValueError("on_device eigenrays run the split-word "
                             "PROFILE evaluator; post a 1-D 'samples' + "
                             "'y' (2-D grids stay on the host/f64 path)")
        from raytracing_tpu.engine.df_grid import df_eval_profile_medium

        medium = df_eval_profile_medium(samples, y)
        # profiles are x-independent: unbounded in x (medium_from_samples)
        default_box = (-1e30, 1e30, float(y[0]), float(y[-1]))
        kind = "df32-profile"
    else:
        with jax.enable_x64(True):    # f64 tables need x64 at build time
            medium, default_box, kind = medium_from_samples(
                samples, x, y, family=family, dtype=np.float64)

    op = canonical(str(body.get("op", "op6")))
    if op in GOLDEN_OPS:
        raise ValueError(
            f"{op} uses a golden-section solver whose paraxial tangents "
            f"vanish (engine/dynamic.py caveat); use a smooth op "
            f"(op1-op4, op6-op8, op12) or the Newton extensions op10n/op11n")

    source = _finite("source", np.asarray(body.get("source", ()), np.float64))
    if source.shape != (2,):
        raise ValueError(f"source must be [x, y], got shape {source.shape}")
    receivers = _finite("receivers",
                        np.atleast_2d(np.asarray(body.get("receivers", ()),
                                                 np.float64)))
    if receivers.ndim != 2 or receivers.shape[1] != 2 or \
            not 1 <= len(receivers) <= MAX_RECEIVERS:
        raise ValueError(f"receivers must be (k, 2) with k in "
                         f"[1, {MAX_RECEIVERS}], got {receivers.shape}")

    delta_s = float(body.get("delta_s", 0.0))
    if not (np.isfinite(delta_s) and delta_s > 0):
        raise ValueError(f"delta_s must be finite and > 0, got {delta_s}")
    steps = int(body.get("steps", 0))
    fan_spec = body.get("fan", {})
    if not isinstance(fan_spec, dict):
        raise ValueError("fan must be {'theta': [lo, hi], 'count': n}")
    th = np.asarray(fan_spec.get("theta", (-0.3, 0.3)), np.float64).reshape(-1)
    _finite("fan theta", th)
    if len(th) != 2 or not th[0] < th[1]:
        raise ValueError(f"fan theta must be [lo, hi] with lo < hi, got {th}")
    n_fan = int(fan_spec.get("count", 256))
    if not 8 <= n_fan <= MAX_FAN:
        raise ValueError(f"fan count must be in [8, {MAX_FAN}], got {n_fan}")
    if not 1 <= steps * n_fan <= MAX_EIGEN_ELEMS:
        raise ValueError(
            f"steps * fan count must be in [1, {MAX_EIGEN_ELEMS}] "
            f"(per-request compute bound), got {steps * n_fan}")
    box = tuple(float(v) for v in body.get("box", default_box))
    if len(box) != 4 or not np.all(np.isfinite(box)) or \
            not (box[0] < box[1] and box[2] < box[3]):
        raise ValueError(f"box must be 4 finite ordered floats, got {box!r}")
    omega = body.get("omega")
    if omega is not None and not (np.isfinite(float(omega))
                                  and float(omega) > 0):
        raise ValueError(f"omega must be finite and > 0, got {omega}")

    t0 = time.perf_counter()
    # max_size = steps + 1: "steps" means integration steps everywhere in
    # the API (the forward trace_samples endpoint included).  max_arrivals
    # bounds the Newton stage: looping paths multiply crossings, and each
    # bracket candidate re-traces full f64 history every iteration — the
    # fan*steps cap alone would not bound that.
    kw = (dict(dtype=np.float32, on_host=False, tol=2e-6)
          if on_device else {})
    eig = er.find_eigenrays(
        op, medium, source=source, receivers=receivers, delta_s=delta_s,
        max_size=steps + 1, box=box,
        fan=(float(th[0]), float(th[1]), n_fan),
        max_arrivals=max(16, MAX_EIGEN_ELEMS // max(steps, 1) // 8), **kw)
    dt = time.perf_counter() - t0

    k = len(receivers)
    itl = er.incoherent_tl(eig, n_receivers=k)
    resp = {
        "op": op, "family": family, "medium_kind": kind,
        "delta_s": delta_s, "steps": steps, "fan_count": n_fan,
        "seconds": round(dt, 4),
        "arrivals": [
            {"receiver": int(r), "theta0": float(t), "traveltime": float(tt),
             "amplitude": float(a), "kmah": int(m), "angle": float(ang),
             "y_err": float(ye), "converged": bool(c)}
            for r, t, tt, a, m, ang, ye, c in zip(
                eig.receiver, eig.theta0, eig.traveltime, eig.amplitude,
                eig.kmah, eig.angle, eig.y_err, eig.converged)],
        # JSON has no Infinity: receivers with no arrivals report null
        "incoherent_tl_db": [None if not np.isfinite(v) else float(v)
                             for v in itl],
    }
    if omega is not None:
        ctl = er.coherent_tl(eig, float(omega), n_receivers=k)
        resp["coherent_tl_db"] = [None if not np.isfinite(v) else float(v)
                                  for v in ctl]
    return resp


MAX_RAYS3 = 1_048_576


def _trace3d_samples_request(body: dict) -> dict:
    """Trace a POSTed 1-D measured profile in 3-D (engine/trace3d.py).

    The profile lifts via Stratified3D (n = n(y), horizontally isotropic);
    launch is explicit ``pos0`` (rays, 3) / ``dir0`` (rays, 3) arrays or a
    compact cone ``launch: {"pos": [x,y,z], "axis": [ux,uy,uz],
    "half_angle": a}`` expanded to ``rays`` directions.  Optional
    ``report_conservation`` returns the horizontal-slowness CV — the 3-D
    form of the reference's p_x oracle.
    """
    from raytracing_tpu.engine.trace3d import canonical3, trace3d
    from raytracing_tpu.media.fields3d import Stratified3D
    from raytracing_tpu.media.samples import medium_from_samples

    if "samples" not in body:
        raise ValueError("this endpoint needs 'samples' (a 1-D profile or "
                         "a 3-D (nz, ny, nx) grid of refractive-index "
                         "values) and its coordinate axes")
    samples = _finite("samples", np.asarray(body["samples"], np.float64))
    if not 0 < samples.size <= MAX_SAMPLE_VALUES:
        raise ValueError(f"samples size must be in [1, {MAX_SAMPLE_VALUES}],"
                         f" got {samples.size}")
    y = _finite("y", np.asarray(body.get("y", ()), np.float64))
    if samples.ndim == 1:
        family = str(body.get("family", "parity"))
        medium2d, default_box, kind = medium_from_samples(samples, None, y,
                                                          family=family)
        medium = Stratified3D(medium2d)
    elif samples.ndim == 3:
        # genuinely 3-D measured field: tri-Hermite tables (media/grid3.py).
        # Only the consistent-gradient family exists in 3-D — the parity
        # family reproduces the reference's 2-D pipeline, which has no 3-D
        # form to be faithful to.
        family = str(body.get("family", "c1"))
        if family != "c1":
            raise ValueError("3-D sampled grids have only the 'c1' "
                             "(consistent-gradient tri-Hermite) family; "
                             f"got family={family!r}")
        from raytracing_tpu.media.grid3 import c1_medium3_from_samples

        x_ax = _finite("x", np.asarray(body.get("x", ()), np.float64))
        z_ax = _finite("z", np.asarray(body.get("z", ()), np.float64))
        medium = c1_medium3_from_samples(samples, x_ax, y, z_ax)
        default_box = (float(x_ax[0]), float(x_ax[-1]),
                       float(y[0]), float(y[-1]),
                       float(z_ax[0]), float(z_ax[-1]))
        kind = "grid3"
    else:
        raise ValueError("samples must be a 1-D profile (n = n(y)) or a "
                         "3-D (nz, ny, nx) grid; got 2-D samples — use "
                         "/v1/trace_samples for the planar grid pipeline")

    method = canonical3(str(body.get("op", "op6")))
    delta_s = float(body.get("delta_s", 0.0))
    if not (np.isfinite(delta_s) and delta_s > 0):
        raise ValueError(f"delta_s must be finite and > 0, got {delta_s}")
    steps = int(body.get("steps", 0))
    if not 1 <= steps <= MAX_STEPS:
        raise ValueError(f"steps must be in [1, {MAX_STEPS}], got {steps}")

    if "pos0" in body:
        pos0 = _finite("pos0", np.asarray(body["pos0"], np.float32))
        dir0 = _finite("dir0", np.asarray(body.get("dir0", ()), np.float32))
        if pos0.ndim != 2 or pos0.shape[1] != 3 or dir0.shape != pos0.shape:
            raise ValueError(f"pos0/dir0 must both be (rays, 3), got "
                             f"{pos0.shape} / {dir0.shape}")
        rays = len(pos0)
    else:
        cone = body.get("launch")
        if not isinstance(cone, dict):
            raise ValueError("this endpoint needs 'pos0'/'dir0' arrays or a "
                             "'launch' cone {'pos': [x,y,z], 'axis': "
                             "[ux,uy,uz], 'half_angle': a}")
        rays = int(body.get("rays", 1024))
        p = _finite("launch pos", np.asarray(cone.get("pos", ()), np.float64))
        ax = _finite("launch axis",
                     np.asarray(cone.get("axis", ()), np.float64))
        if p.shape != (3,) or ax.shape != (3,):
            raise ValueError("launch pos/axis must each be 3 floats")
        ha = float(cone.get("half_angle", 0.1))
        if not (np.isfinite(ha) and 0 <= ha < np.pi / 2):
            raise ValueError(f"half_angle must be in [0, pi/2), got {ha}")
        from raytracing_tpu.engine.dynamic3d import _transverse_frame
        import jax.numpy as jnp
        axn = ax / np.linalg.norm(ax)
        e1, e2 = (np.asarray(v)[0]
                  for v in _transverse_frame(jnp.asarray(axn[None, :])))
        t = np.linspace(0.0, 2 * np.pi, rays, endpoint=False)
        tilt = ha * np.sqrt(np.linspace(0.0, 1.0, rays))  # area-uniform cone
        d = (axn[None, :] + tilt[:, None]
             * (np.cos(t)[:, None] * e1 + np.sin(t)[:, None] * e2))
        dir0 = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
            np.float32)
        pos0 = np.tile(p.astype(np.float32), (rays, 1))
    if not 1 <= rays <= MAX_RAYS3:
        raise ValueError(f"rays must be in [1, {MAX_RAYS3}], got {rays}")

    box = body.get("box")
    if box is not None:
        box = tuple(float(v) for v in box)
        if len(box) != 6 or not np.all(np.isfinite(box)):
            raise ValueError(f"box must be 6 finite floats, got {box!r}")
    elif kind == "grid3":
        box = default_box          # sampled region; queries clamp beyond it
    else:
        box = (-1e30, 1e30, default_box[2], default_box[3], -1e30, 1e30)
    report_cv = bool(body.get("report_conservation", False))

    t0 = time.perf_counter()
    out = trace3d(method, medium, pos0=pos0, dir0=dir0, delta_s=delta_s,
                  steps=steps, box=box, mode="metrics", stats=report_cv)
    pos = np.asarray(out.final.pos)
    dt = time.perf_counter() - t0

    resp = {
        "op": method, "rays": rays, "steps": steps, "family": family,
        # lifted profiles report "profile-3d"; native 3-D grids are "grid3"
        "medium_kind": kind if kind == "grid3" else f"{kind}-3d",
        "delta_s": delta_s,
        "seconds": round(dt, 4),
        "ray_steps_per_sec": round(rays * steps / dt, 1),
        # the scan's `active` means "still integrating" (false for every
        # ray once the step budget ends); box escapes are the rays whose
        # exit_step stopped short of it
        "escaped_rays": int((np.asarray(out.exit_step) < steps).sum()),
        "mean_final_pos": [float(v) for v in pos.mean(0)],
    }
    if report_cv:
        cv = out.horizontal_slowness_cv_pct()
        finite = np.isfinite(cv)
        resp["slowness_cv_pct_max"] = (float(np.nanmax(cv))
                                       if finite.any() else None)
        resp["slowness_cv_rays_excluded"] = int((~finite.any(-1)).sum())
    return resp


def _eigenrays3_request(body: dict) -> dict:
    """3-D boundary-value arrivals through a POSTed measured profile.

    The 3-D twin of ``/v1/eigenrays`` (engine/eigenray3d.py): the profile
    lifts via Stratified3D exactly as /v1/trace3d_samples, the launch-
    direction fan is a 2-D (alpha, beta) grid around ``center_dir``
    (default: source -> mean receiver), and each arrival carries travel
    time, |det Q| spherical amplitude, KMAH count and residual miss;
    per-receiver incoherent (and, with ``omega``, coherent) TL reduce the
    3-D arrivals through the same machinery as 2-D.
    """
    from raytracing_tpu.engine import eigenray as er
    from raytracing_tpu.engine.eigenray3d import find_eigenrays3
    from raytracing_tpu.engine.trace3d import canonical3
    from raytracing_tpu.media.fields3d import Stratified3D
    from raytracing_tpu.media.samples import medium_from_samples

    family = str(body.get("family", "parity"))
    if "samples" not in body:
        raise ValueError("this endpoint needs 'samples' (a 1-D profile of "
                         "refractive-index values) and its 'y' axis")
    samples = _finite("samples", np.asarray(body["samples"], np.float64))
    if samples.ndim != 1:
        raise ValueError("3-D eigenrays lift 1-D PROFILES (n = n(y)); got "
                         "2-D samples — use /v1/eigenrays for the planar "
                         "pipeline")
    if not 0 < samples.size <= MAX_SAMPLE_VALUES:
        raise ValueError(f"samples size must be in [1, {MAX_SAMPLE_VALUES}],"
                         f" got {samples.size}")
    y = _finite("y", np.asarray(body.get("y", ()), np.float64))
    with jax.enable_x64(True):    # f64 tables: eigenray landing-curve floor
        medium2d, default_box, kind = medium_from_samples(
            samples, None, y, family=family, dtype=np.float64)
    medium = Stratified3D(medium2d)

    method = canonical3(str(body.get("op", "op6")))
    source = _finite("source", np.asarray(body.get("source", ()),
                                          np.float64))
    if source.shape != (3,):
        raise ValueError(f"source must be [x, y, z], got {source.shape}")
    receivers = _finite("receivers",
                        np.atleast_2d(np.asarray(body.get("receivers", ()),
                                                 np.float64)))
    if receivers.ndim != 2 or receivers.shape[1] != 3 or \
            not 1 <= len(receivers) <= MAX_RECEIVERS:
        raise ValueError(f"receivers must be (k, 3) with k in "
                         f"[1, {MAX_RECEIVERS}], got {receivers.shape}")
    delta_s = float(body.get("delta_s", 0.0))
    if not (np.isfinite(delta_s) and delta_s > 0):
        raise ValueError(f"delta_s must be finite and > 0, got {delta_s}")
    steps = int(body.get("steps", 0))
    fan_spec = body.get("fan", {})
    if not isinstance(fan_spec, dict):
        raise ValueError("fan must be {'alpha': [lo, hi], 'beta': "
                         "[lo, hi], 'count': [n_a, n_b]}")
    al = np.asarray(fan_spec.get("alpha", (-0.3, 0.3)),
                    np.float64).reshape(-1)
    be = np.asarray(fan_spec.get("beta", (-0.3, 0.3)),
                    np.float64).reshape(-1)
    _finite("fan alpha", al)
    _finite("fan beta", be)
    if len(al) != 2 or not al[0] < al[1] or len(be) != 2 or \
            not be[0] < be[1]:
        raise ValueError("fan alpha/beta must each be [lo, hi] with "
                         f"lo < hi, got {al} / {be}")
    cnt = np.asarray(fan_spec.get("count", (25, 25)), np.int64).reshape(-1)
    if len(cnt) != 2 or not np.all((4 <= cnt) & (cnt * cnt[::-1]
                                                 <= MAX_FAN * MAX_FAN)):
        raise ValueError(f"fan count must be [n_a, n_b] with n >= 4 and "
                         f"n_a*n_b <= {MAX_FAN * MAX_FAN}, got {cnt}")
    n_fan = int(cnt[0] * cnt[1])
    if not 1 <= steps * n_fan <= MAX_EIGEN_ELEMS:
        raise ValueError(
            f"steps * fan grid size must be in [1, {MAX_EIGEN_ELEMS}] "
            f"(per-request compute bound), got {steps * n_fan}")
    center = body.get("center_dir")
    if center is not None:
        center = _finite("center_dir", np.asarray(center, np.float64))
        if center.shape != (3,) or not np.linalg.norm(center) > 0:
            raise ValueError("center_dir must be a nonzero 3-vector")
    box = body.get("box")
    if box is not None:
        box = tuple(float(v) for v in box)
        if len(box) != 6 or not np.all(np.isfinite(box)):
            raise ValueError(f"box must be 6 finite floats, got {box!r}")
    else:
        box = (-1e30, 1e30, default_box[2], default_box[3], -1e30, 1e30)
    omega = body.get("omega")
    if omega is not None and not (np.isfinite(float(omega))
                                  and float(omega) > 0):
        raise ValueError(f"omega must be finite and > 0, got {omega}")

    t0 = time.perf_counter()
    eig = find_eigenrays3(
        method, medium, source=source, receivers=receivers,
        delta_s=delta_s, max_size=steps, box=box, center_dir=center,
        fan=(float(al[0]), float(al[1]), int(cnt[0]),
             float(be[0]), float(be[1]), int(cnt[1])))
    dt = time.perf_counter() - t0
    k = len(receivers)
    itl = er.incoherent_tl(eig, n_receivers=k)
    resp = {
        "op": method, "family": family, "medium_kind": f"{kind}-3d",
        "delta_s": delta_s, "steps": steps,
        "fan_count": [int(cnt[0]), int(cnt[1])],
        "seconds": round(dt, 4),
        "arrivals": [
            {"receiver": int(r), "dir0": [float(v) for v in d],
             "traveltime": float(tt), "amplitude": float(a),
             "kmah": int(m), "miss": float(ms), "converged": bool(c)}
            for r, d, tt, a, m, ms, c in zip(
                eig.receiver, eig.dir0, eig.traveltime, eig.amplitude,
                eig.kmah, eig.miss, eig.converged)],
        "incoherent_tl_db": [None if not np.isfinite(v) else float(v)
                             for v in itl],
    }
    if omega is not None:
        ctl = er.coherent_tl(eig, float(omega), n_receivers=k)
        resp["coherent_tl_db"] = [None if not np.isfinite(v) else float(v)
                                  for v in ctl]
    return resp


class _Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, payload: dict):
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, {"status": "ok",
                             "device": str(jax.devices()[0]),
                             "version": rt.__version__})
        elif self.path == "/v1/models":
            self._send(200, {"scenarios": list(config.SCENARIO_NAMES),
                             "ops": list(OP_NAMES),
                             "extensions": list(EXTENSION_OPS),
                             "media": ["analytic", "stratified", "grid",
                                       "c1", "c1-stratified"],
                             "sample_families": ["parity", "c1"],
                             "endpoints": ["/healthz", "/v1/models",
                                           "/v1/trace", "/v1/trace_samples",
                                           "/v1/calibrate_samples",
                                           "/v1/eigenrays",
                                           "/v1/trace3d_samples",
                                           "/v1/eigenrays3"]})
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    _POST_ROUTES = {"/v1/trace": _trace_request,
                    "/v1/trace_samples": _trace_samples_request,
                    "/v1/calibrate_samples": _calibrate_samples_request,
                    "/v1/eigenrays": _eigenrays_request,
                    "/v1/eigenrays3": _eigenrays3_request,
                    "/v1/trace3d_samples": _trace3d_samples_request}

    def do_POST(self):
        handler = self._POST_ROUTES.get(self.path)
        if handler is None:
            self._send(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            self._send(200, handler(body))
        except (ValueError, KeyError, TypeError, OverflowError,
                ZeroDivisionError, IndexError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})

    def log_message(self, fmt, *args):  # quiet by default
        pass


def create_server(host: str = "127.0.0.1", port: int = 8080) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), _Handler)


def main(argv=None):
    import argparse

    from raytracing_tpu.utils.cache import enable_persistent_cache

    p = argparse.ArgumentParser(description="raytracing_tpu serving endpoint")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    args = p.parse_args(argv)
    enable_persistent_cache()  # daemon restarts reuse compiled programs
    srv = create_server(args.host, args.port)
    print(f"serving on http://{args.host}:{args.port} "
          f"(device: {jax.devices()[0]})")
    srv.serve_forever()


if __name__ == "__main__":
    main()
