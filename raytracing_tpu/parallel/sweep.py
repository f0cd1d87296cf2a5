"""DELTA_S convergence search as one batched, mesh-shardable program.

The reference sweeps step-size candidates by fanning ``search_delta`` out
over a ProcessPoolExecutor, pickling the spline objects to every worker
(RT_bench.py:1296-1318, 950-958).  Here all candidates become
*one* padded ``lax.scan`` — trajectory buffers sized for the longest
candidate, each candidate carrying its own traced ``delta_s`` and
``step_limit`` — vmapped over the candidate axis and (optionally) sharded
over a device mesh's "sweep" axis.  One compile, no host round-trips, and
the acceptance metrics reduce on device.

The three per-scenario acceptance policies (``find_index``,
RT_bench.py:1320-1375) stay on host: they are O(candidates) scalar logic.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu import config
from raytracing_tpu.engine import oracles
from raytracing_tpu.engine.trace import _build_trace_fn, initial_state
from raytracing_tpu.parallel import mesh as meshlib


class SweepResult(NamedTuple):
    scenario: str
    op_name: str
    divisors: np.ndarray          # candidate divisors, reference ordering
    delta_s: np.ndarray           # candidate step sizes
    metrics: dict[str, np.ndarray]  # per-candidate acceptance metrics
    index: int | None             # accepted candidate, or None
    divisor: float | None         # rounded selected divisor (RT_bench.py:1379-1383)
    delta_s_selected: float | None


def candidates(scen: config.ScenarioConfig):
    """Candidate divisor grid per scenario (RT_bench.py:1302-1312).

    Returns (divisors, delta_s, trace_divisors) — ``trace_divisors`` is what
    sizes the fisheye buffer (the reference passes ``divisors + 1`` into
    ``trazar``, RT_bench.py:1318).

    Reference quirk kept deliberately: the vert/aniso grid uses DELTA_STEP
    (0.01), not the DELTA_STEP_VERT constant defined for it — that constant
    is dead code in the reference (RT_bench.py:95, 1311).
    """
    c = config
    if scen.is_interface:
        divisors = np.arange(c.DELTA_S_DIVISOR_UPPER_LIMIT,
                             c.DELTA_S_DIVISOR_LOWER_LIMIT - c.DELTA_STEP,
                             -c.DELTA_STEP)
        return divisors, c.SIGMA / divisors, None
    if scen.is_fisheye:
        divisors = np.arange(c.DELTA_S_DIVISOR_FISHEYE_UPPER_LIMIT,
                             c.DELTA_S_DIVISOR_FISHEYE_LOWER_LIMIT
                             - c.DELTA_STEP_FISHEYE,
                             -c.DELTA_STEP_FISHEYE)
        return divisors, 2.0 * np.pi / divisors, divisors + 1
    divisors = np.arange(c.DELTA_S_DIVISOR_VERT_UPPER_LIMIT,
                         c.DELTA_S_DIVISOR_VERT_LOWER_LIMIT - 2 * c.DELTA_STEP,
                         -c.DELTA_STEP)
    return divisors, c.SIGMA / divisors, None


# -- acceptance policies (host logic, RT_bench.py:1320-1375) ----------------
def find_index_interface(errors, max_errors,
                         max_dev=config.MAX_DEVIATION,
                         max_single=config.MAX_DEVIATION_SINGLE_RAY):
    """Largest step whose mean/max errors pass with all coarser ones passing
    (RT_bench.py:1323-1332)."""
    errors = list(errors)
    max_errors = list(max_errors)
    if not any(e > max_dev for e in errors) or not any(e < max_dev for e in errors):
        return None
    for i in reversed(range(len(errors))):
        if errors[i] < max_dev and max_errors[i] < max_single:
            if (all(e < max_dev for e in errors[:i])
                    and all(e < max_single for e in max_errors[:i])):
                return i
    return None


def find_index_fisheye(errors, max_dev=config.MAX_CLOSURE_ERROR_PCT):
    """Last candidate before closure error crosses the threshold
    (RT_bench.py:1339-1347)."""
    errors = list(errors)
    if not any(e > max_dev for e in errors) or not any(e < max_dev for e in errors):
        return None
    for i, e in enumerate(errors):
        if e > max_dev:
            return i - 1
    return None


def find_index_vert(errors, max_dev=config.MAX_MOMENTUM_CV_PCT):
    """First CV crossing with all previous candidates passing
    (RT_bench.py:1363-1373)."""
    errors = list(errors)
    if not any(e > max_dev for e in errors) or not any(e < max_dev for e in errors):
        return None
    for i in range(len(errors)):
        if i > 1 and errors[i] > max_dev:
            if all(e < max_dev for e in errors[:i - 1]):
                return i - 1
    return None


def run_candidates_fused(op_name: str, scen: config.ScenarioConfig,
                         delta_s: np.ndarray, step_limits: np.ndarray,
                         max_steps: int, *, medium=None, rays: int | None = None,
                         block_rays: int = 4096, interpret: bool | None = None,
                         checkpoint: str | None = None, chunk: int = 32):
    """Candidate sweep through ONE compiled fused kernel — any scenario.

    The kernel compiles once at ``max_steps`` with a traced per-run step
    limit; each candidate is one kernel launch.  ``medium``: pass a
    ``StratifiedGridMedium`` to sweep on the reference-faithful sampled
    medium (RT_bench.py:435-464); None uses the analytic field.

    Per-scenario metrics (the reference's search_delta, RT_bench.py:950-958):

    * fisheye -> ``closure_pct`` from ray 0's final position;
    * interface -> ``mean_err``/``max_err`` (deg) — measured outbound angle
      taken from the *final frozen tangent* instead of the history-tail
      secant (RT_bench.py:910-916): past the interface the ray is straight,
      so secant == tangent to f32 precision (the scan tier keeps the exact
      tail-secant computation; divergence logged in docs/PARITY.md);
    * vert/aniso -> ``cv_pct`` from the in-kernel Welford momentum tracker.

    2-D grid media sweep on the scan tier (:func:`run_candidates`).
    """
    import jax as _jax

    from raytracing_tpu.kernels.fused import (fused_trace_final,
                                              fused_trace_final_strat)
    from raytracing_tpu.kernels.golden import GOLDEN_OPS, golden_trace_final
    from raytracing_tpu.kernels.route import resolve_interpret
    from raytracing_tpu.media.c1 import C1StratifiedMedium
    from raytracing_tpu.media.spline import StratifiedGridMedium

    interpret = resolve_interpret(interpret)
    use_strat = isinstance(medium, (StratifiedGridMedium,
                                    C1StratifiedMedium))
    if medium is not None and not use_strat:
        # the kernels would otherwise trace the scenario's analytic field
        raise ValueError(
            f"the kernel sweep takes a stratified medium or None, got "
            f"{type(medium).__name__}; grid media sweep on the scan tier "
            f"(run_candidates)")
    use_golden = op_name in GOLDEN_OPS
    deg = 180.0 / np.pi

    if scen.is_fisheye:
        r = rays or block_rays
        fan = np.full(r, np.pi / 2.0, np.float32)
        pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (r, 1))
        nf = r
    else:
        fan = np.asarray(scen.theta0, np.float32)
        nf = len(fan)
        r = rays or block_rays
        if r < nf:
            raise ValueError(f"rays {r} < scenario fan {nf}")
        fan = np.concatenate([fan, np.full(r - nf, fan[-1], np.float32)])
        pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    if r % block_rays:
        raise ValueError(f"rays {r} not a multiple of block {block_rays}")
    theta0 = _jax.device_put(fan)
    pos0 = _jax.device_put(pos0)

    with_stats = scen.is_vert
    out = {k: np.empty(len(delta_s)) for k in (
        ("mean_err", "max_err") if scen.is_interface else
        ("closure_pct",) if scen.is_fisheye else ("cv_pct",))}

    store = None
    if checkpoint is not None:
        from raytracing_tpu.utils.checkpoint import SweepCheckpoint

        store = SweepCheckpoint(checkpoint, meta={
            "op": op_name, "scenario": scen.name, "engine": "fused",
            "candidates": int(len(delta_s)), "chunk": int(chunk)})
    done_upto = 0
    for i, (ds, lim) in enumerate(zip(delta_s, step_limits)):
        if store is not None:
            ci = i // chunk
            if i % chunk == 0 and store.has_chunk(ci):
                saved = store.chunk(ci)
                n = len(next(iter(saved.values())))
                for k in out:
                    out[k][i:i + n] = saved[k]
                done_upto = i + n
            if i < done_upto:
                continue
        if use_golden:
            f = golden_trace_final(
                pos0, theta0, np.float32(ds), np.float32(scen.gamma),
                field=scen.field, op=op_name, steps=int(max_steps),
                box=tuple(scen.box), block_rays=block_rays,
                interpret=interpret, with_stats=with_stats,
                step_limit=np.float32(lim),
                medium=medium if use_strat else None)
        elif use_strat:
            f = fused_trace_final_strat(
                pos0, theta0, np.float32(ds), medium, op=op_name,
                steps=int(max_steps), box=tuple(scen.box),
                block_rays=block_rays, interpret=interpret,
                step_limit=np.float32(lim), with_stats=with_stats)
        else:
            f = fused_trace_final(
                pos0, theta0, np.float32(ds), field=scen.field, op=op_name,
                steps=int(max_steps), box=tuple(scen.box),
                block_rays=block_rays, interpret=interpret,
                step_limit=np.float32(lim), with_stats=with_stats)
        if scen.is_fisheye:
            p = np.asarray(f.pos[0])
            out["closure_pct"][i] = (100.0 * np.linalg.norm(p - [1.0, 0.0])
                                     / (2.0 * np.pi))
        elif scen.is_interface:
            if use_golden:
                a = np.asarray(f.angle[:nf])
                tang = np.stack([np.cos(a), np.sin(a)], -1)
            else:
                tang = np.asarray(f.tangent[:nf])
            errs = oracles.snell_errors_from_tangent(tang, fan[:nf])
            out["mean_err"][i] = errs.mean()
            out["max_err"][i] = errs.max()
        else:
            cnt = np.asarray(f.mom_count[:nf])
            mean = np.asarray(f.mom_mean[:nf])
            m2 = np.asarray(f.mom_m2[:nf])
            cv = 100.0 * np.sqrt(m2 / cnt) / mean
            out["cv_pct"][i] = float(np.mean(cv[1:-1]))
        if store is not None and (i + 1) % chunk == 0:
            ci = i // chunk
            if not store.has_chunk(ci):
                lo = ci * chunk
                store.add_chunk(ci, {k: out[k][lo:i + 1] for k in out})
    if store is not None and len(delta_s) % chunk:
        ci = (len(delta_s) - 1) // chunk
        if not store.has_chunk(ci):
            lo = ci * chunk
            store.add_chunk(ci, {k: out[k][lo:] for k in out})
    return out


# -- the sweep itself -------------------------------------------------------
def _max_sizes(scen, delta_s, trace_divisors, n_turns):
    if scen.is_fisheye:
        return (n_turns * trace_divisors).astype(np.int64)
    return np.ceil(scen.s_max / delta_s).astype(np.int64) + 1


def run_candidates(op_name: str, scen: config.ScenarioConfig, medium,
                   delta_s: np.ndarray, step_limits: np.ndarray,
                   max_size: int, *, n_turns: int = config.N_TURNS,
                   dtype=np.float32, chunk: int | None = None, mesh=None,
                   checkpoint: str | None = None, pos0=None, theta0=None):
    """Evaluate the scenario acceptance metric for every candidate.

    Returns a dict of per-candidate arrays:
    interface -> mean_err/max_err (deg); fisheye -> closure_pct;
    vert/aniso -> cv_pct.

    ``checkpoint`` names an .npz file: each finished candidate chunk is
    persisted there, and a rerun resumes at the first unfinished chunk —
    the elastic-recovery layer the reference lacks (SURVEY.md 5.3-5.4).
    ``pos0``/``theta0`` override the scenario's reference launch fan for
    large custom batches (shard them with ``mesh``'s rays axis upstream).
    """
    dtype = np.dtype(dtype)
    mode = "history" if scen.is_interface else "metrics"
    op, run, _ = _build_trace_fn(op_name, int(max_size), tuple(scen.box), mode,
                                 scen.is_vert, dtype.name)
    gamma = jnp.asarray(scen.gamma, dtype)
    theta0 = jnp.asarray(scen.theta0 if theta0 is None else theta0, dtype)
    st0 = initial_state(jnp.asarray(scen.pos0 if pos0 is None else pos0, dtype),
                        theta0, medium, gamma,
                        with_window=op.uses_window,
                        with_momentum_stats=scen.is_vert,
                        max_size=int(max_size))

    def one(d, lim):
        res = run(st0, medium, gamma, d, lim)
        if scen.is_interface:
            errs = oracles.snell_errors_deg(res, theta0)
            return {"mean_err": jnp.mean(errs), "max_err": jnp.max(errs)}
        if scen.is_fisheye:
            # The reference reads the last buffer row (RT_bench.py:956);
            # the final carry is that row since fisheye rays never exit.
            return {"closure_pct": oracles.closure_error_pct(res)[0]}
        cv = oracles.momentum_cv_pct_from_stats(res)
        return {"cv_pct": oracles.scenario_average_cv_pct(cv)}

    runner = jax.jit(jax.vmap(one))
    n = len(delta_s)
    if chunk is None:
        chunk = n if not scen.is_interface else 16

    store = None
    if checkpoint is not None:
        from raytracing_tpu.utils.checkpoint import SweepCheckpoint
        store = SweepCheckpoint(checkpoint, meta={
            "op": op_name, "scenario": scen.name, "dtype": np.dtype(dtype).name,
            "candidates": int(n), "chunk": int(chunk)})

    outs = []
    for ci, lo in enumerate(range(0, n, chunk)):
        if store is not None and store.has_chunk(ci):
            outs.append(store.chunk(ci))
            continue
        d = jnp.asarray(delta_s[lo:lo + chunk], dtype)
        lim = jnp.asarray(step_limits[lo:lo + chunk], jnp.int32)
        if mesh is not None and d.shape[0] % mesh.devices.size == 0:
            sh = meshlib.sweep_sharding(mesh)
            d, lim = jax.device_put(d, sh), jax.device_put(lim, sh)
        out = jax.tree.map(np.asarray, runner(d, lim))
        if store is not None:
            store.add_chunk(ci, out)
        outs.append(out)
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def fused_sweep_supported(op_name: str, scen: config.ScenarioConfig,
                          medium) -> bool:
    """True when the kernel-speed sweep covers this configuration."""
    from raytracing_tpu.kernels.fused import FUSED_FIELDS, FUSED_OPS
    from raytracing_tpu.kernels.golden import GOLDEN_OPS
    from raytracing_tpu.media.c1 import C1StratifiedMedium
    from raytracing_tpu.media.medium import AnalyticMedium
    from raytracing_tpu.media.spline import StratifiedGridMedium

    if op_name not in FUSED_OPS and op_name not in GOLDEN_OPS:
        return False
    if isinstance(medium, (StratifiedGridMedium, C1StratifiedMedium)):
        return not scen.is_fisheye
    # the kernel sweep inlines the SCENARIO's field; an analytic medium with
    # a different field must go through the scan tier, which honors it
    return (isinstance(medium, AnalyticMedium)
            and medium.field == scen.field
            and scen.field in FUSED_FIELDS)


def delta_s_search(op_name: str, scen: config.ScenarioConfig, medium, *,
                   n_turns: int = config.N_TURNS, dtype=np.float32,
                   chunk: int | None = None, mesh=None,
                   checkpoint: str | None = None, engine: str = "auto",
                   rays: int | None = None, block_rays: int = 4096,
                   divisors: np.ndarray | None = None) -> SweepResult:
    """Full DELTA_S search: sweep + acceptance + selection.

    Mirrors the reference flow RT_bench.py:1296-1406, returning the selected
    step instead of mutating globals.  Raises nothing on failure: ``index``
    is None when no candidate passes (the reference sys.exit()s,
    RT_bench.py:1404-1406 — the caller decides that policy here).

    ``engine``: "scan" runs every candidate through the reference-parity
    scan engine; "fused" through the kernels (requires a fused-covered
    op/medium); "auto" picks fused when supported on a compiled route.

    ``divisors`` overrides the reference candidate grid
    (RT_bench.py:1302-1312), descending, same units as that grid (fisheye:
    circle segments; otherwise SIGMA divisors).  Needed e.g. to calibrate
    the ANALYTIC interface medium: its sigmoid is sharper than the
    reference's SIGMA/3 sampled fit, and the 0.2-deg Snell bar only becomes
    reachable at divisors above the reference grid's 3.0 ceiling
    (benchmarks/calibrate_analytic.py; docs/PARITY.md #28).
    """
    from raytracing_tpu.kernels.route import kernel_route
    from raytracing_tpu.ops.registry import canonical

    op_c = canonical(op_name)
    if engine == "auto":
        # interpreted kernels (the CPU route) are far slower than the scan
        # engine, and the fused path honors neither an explicit mesh nor a
        # non-f32 dtype — auto respects those requests by staying on the
        # scan tier
        engine = ("fused" if (kernel_route() == "triton"
                              and mesh is None
                              and np.dtype(dtype) == np.float32
                              and fused_sweep_supported(op_c, scen, medium))
                  else "scan")
    if engine not in ("scan", "fused"):
        raise ValueError(f"engine must be scan/fused/auto, got {engine!r}")

    if divisors is None:
        divisors, delta_s, trace_divs = candidates(scen)
    else:
        divisors = np.asarray(divisors, np.float64)
        if scen.is_fisheye:
            delta_s, trace_divs = 2.0 * np.pi / divisors, divisors + 1
        else:
            delta_s, trace_divs = config.SIGMA / divisors, None
    sizes = _max_sizes(scen, delta_s, trace_divs, n_turns)
    max_size = int(sizes.max())
    if engine == "fused":
        if not fused_sweep_supported(op_c, scen, medium):
            raise ValueError(f"fused sweep does not cover {op_c!r} on "
                             f"{type(medium).__name__} ({scen.name})")
        from raytracing_tpu.media.c1 import C1StratifiedMedium
        from raytracing_tpu.media.spline import StratifiedGridMedium

        med = (medium if isinstance(
            medium, (StratifiedGridMedium, C1StratifiedMedium)) else None)
        metrics = run_candidates_fused(
            op_c, scen, delta_s, sizes - 1, max_size - 1, medium=med,
            rays=rays, block_rays=block_rays, checkpoint=checkpoint)
    else:
        metrics = run_candidates(op_name, scen, medium, delta_s, sizes - 1,
                                 max_size, n_turns=n_turns, dtype=dtype,
                                 chunk=chunk, mesh=mesh, checkpoint=checkpoint)

    if scen.is_interface:
        index = find_index_interface(metrics["mean_err"], metrics["max_err"])
    elif scen.is_fisheye:
        index = find_index_fisheye(metrics["closure_pct"])
    else:
        index = find_index_vert(metrics["cv_pct"])

    if index is None:
        divisor = ds_sel = None
    elif scen.is_fisheye:
        divisor = float(round(divisors[index]))           # RT_bench.py:1379
        ds_sel = 2.0 * math.pi / divisor
    else:
        divisor = float(round(divisors[index], 2))        # RT_bench.py:1383
        ds_sel = config.SIGMA / divisor

    return SweepResult(scenario=scen.name, op_name=op_name,
                       divisors=divisors, delta_s=delta_s, metrics=metrics,
                       index=index, divisor=divisor, delta_s_selected=ds_sel)


def delta_s_search_convergence(op_name: str, medium, *, pos0, theta0,
                               arc_length: float, box, gamma: float = 1.0,
                               candidates: np.ndarray | None = None,
                               tol: float = 1e-4,
                               block_rays: int = 4096) -> SweepResult:
    """DELTA_S search for USER-measured media via Richardson
    self-convergence.

    The reference's acceptance policies all lean on a per-scenario physics
    oracle (closure / Snell / momentum CV, RT_bench.py:1320-1375); a
    measured medium has no closed-form truth, so acceptance here is
    self-convergence instead: a candidate step passes when HALVING it moves
    no final position by more than ``tol`` over the same ``arc_length``.
    For the one-step methods the halving error is O(delta_s), making it an
    estimate of the remaining discretization error itself.

    Candidates are step sizes, DESCENDING step count (coarse -> fine, the
    reference's sweep order); the first passing candidate is selected
    (coarsest-accepted convention, RT_bench.py:1364-1377).  Default grid:
    arc_length / {50, 100, ..., 6400} — eight octaves.  Runs through
    ``fast_trace`` so the kernel tier serves each candidate; every
    candidate pair costs two traces at distinct static step counts, so
    keep the grid short on compile-expensive backends.

    Returns a SweepResult whose ``metrics['halving_err']`` holds the
    per-candidate displacement and ``divisors`` the step counts.
    """
    import dataclasses

    from raytracing_tpu.engine.fast import fast_trace
    from raytracing_tpu.ops.registry import canonical

    op_c = canonical(op_name)
    if not (np.isfinite(arc_length) and arc_length > 0):
        raise ValueError(f"arc_length must be finite and > 0, "
                         f"got {arc_length}")
    scen = dataclasses.replace(config.scenario("fisheye"), name="samples",
                               gamma=float(gamma),
                               box=tuple(float(v) for v in box))
    if candidates is None:
        counts = 50 * 2 ** np.arange(8)
        candidates = arc_length / counts
    candidates = np.asarray(candidates, np.float64)
    if np.any(np.diff(candidates) >= 0):
        raise ValueError("candidates must descend (coarse -> fine)")
    pos0 = np.asarray(pos0, np.float32)
    theta0 = np.asarray(theta0, np.float32)

    def final_pos(ds: float, steps: int) -> np.ndarray:
        out = fast_trace(op_c, scen, medium, delta_s=np.float32(ds),
                         steps=int(steps), pos0=pos0, theta0=theta0,
                         block_rays=block_rays)
        return np.asarray(out.pos)

    return _richardson_search(final_pos, candidates, arc_length, tol,
                              scenario="samples", op_name=op_c,
                              dtype=np.float32)


def _richardson_search(final_pos, candidates, arc_length, tol, *,
                       scenario: str, op_name: str, dtype) -> SweepResult:
    """Shared coarse->fine halving loop of the convergence searches.

    One home for the acceptance/memo logic (2-D measured media and the
    3-D tier use it with different tracers): on a halving grid, candidate
    i's half-step trace IS candidate i+1's full-step trace — reuse it and
    trace only the twin.  The step count must match too: rounding can
    break the identity when arc/ds is not an integer.
    """
    errs = []
    index = None
    memo = (None, None, None)   # (dtype ds, steps, pos) of the last half run
    for i, ds in enumerate(candidates):
        steps = max(1, round(arc_length / float(ds)))
        dsf = np.dtype(dtype).type(ds)
        a = (memo[2] if memo[0] == dsf and memo[1] == steps
             else final_pos(float(ds), steps))
        b = final_pos(float(ds) / 2.0, 2 * steps)
        memo = (np.dtype(dtype).type(float(ds) / 2.0), 2 * steps, b)
        errs.append(float(np.linalg.norm(a - b, axis=-1).max()))
        if errs[-1] < tol:
            index = i
            break
    errs += [np.nan] * (len(candidates) - len(errs))

    steps_grid = np.array([max(1, round(arc_length / d))
                           for d in candidates], np.float64)
    return SweepResult(
        scenario=scenario, op_name=op_name, divisors=steps_grid,
        delta_s=candidates, metrics={"halving_err": np.asarray(errs)},
        index=index,
        divisor=float(steps_grid[index]) if index is not None else None,
        delta_s_selected=(float(candidates[index]) if index is not None
                          else None))


def delta_s_search_convergence3(method: str, medium, *, pos0, dir0,
                                arc_length: float, box=None,
                                candidates: np.ndarray | None = None,
                                tol: float = 1e-4,
                                dtype=np.float32) -> SweepResult:
    """Richardson step calibration for the 3-D tier (engine/trace3d.py).

    The 3-D twin of :func:`delta_s_search_convergence`: a candidate step
    passes when halving it moves no final position by more than ``tol``
    over ``arc_length``.  3-D media have no reference oracle table, so
    self-convergence is the calibration story, like measured 2-D media.
    Runs through ``trace3d`` in metrics mode; the half-step trace of each
    candidate is reused as the next candidate's full-step trace on the
    default halving grid.
    """
    from raytracing_tpu.engine.trace3d import canonical3, trace3d

    method = canonical3(method)
    if not (np.isfinite(arc_length) and arc_length > 0):
        raise ValueError(f"arc_length must be finite and > 0, "
                         f"got {arc_length}")
    if candidates is None:
        candidates = arc_length / (50 * 2 ** np.arange(8))
    candidates = np.asarray(candidates, np.float64)
    if np.any(np.diff(candidates) >= 0):
        raise ValueError("candidates must descend (coarse -> fine)")
    pos0 = np.asarray(pos0, dtype)
    dir0 = np.asarray(dir0, dtype)

    def final_pos(ds: float, steps: int) -> np.ndarray:
        out = trace3d(method, medium, pos0=pos0, dir0=dir0, delta_s=ds,
                      steps=int(steps), box=box, mode="metrics",
                      dtype=dtype)
        return np.asarray(out.final.pos)

    return _richardson_search(final_pos, candidates, arc_length, tol,
                              scenario="custom3d", op_name=method,
                              dtype=dtype)
