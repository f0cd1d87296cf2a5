"""fast_trace: one entry point for the fused-kernel production tier.

Routes any step method to its Pallas kernel — ``kernels/fused.py`` for the
Taylor/curvature/window families, ``kernels/golden.py`` for the golden/
Newton families — and falls back to the scan engine for configurations the
kernels don't cover (2-D/3-D grid media, float64, history mode).  This is
what a user reaches for when the job is "a million rays, final state only,
as fast as the device goes"; ``trace`` remains the reference-parity tier.
How the kernels run (Triton on the GPU, interpreted on the CPU) is
``kernels/route.py``'s one decision.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu import config
from raytracing_tpu.engine.trace import _outside, trace
from raytracing_tpu.kernels.fused import (
    FUSED_FIELDS, FUSED_OPS, fused_trace_final, fused_trace_final_strat)
from raytracing_tpu.kernels.golden import GOLDEN_OPS, golden_trace_final
from raytracing_tpu.kernels.fused import fused_trace_final_custom
from raytracing_tpu.kernels.route import resolve_interpret
from raytracing_tpu.media.c1 import C1StratifiedMedium
from raytracing_tpu.media.medium import AnalyticMedium, CustomMedium
from raytracing_tpu.media.spline import StratifiedGridMedium
from raytracing_tpu.ops.registry import canonical

#: one-shot kernels above this trip count route through bounded segments
#: (set for a compiler whose time grew with the trip count; whether the
#: Triton route needs the bound is open)
SEGMENT_THRESHOLD = 6000


class FastResult(NamedTuple):
    pos: Any         # (R, 2) final positions
    traveltime: Any  # (R,)
    dist_sim: Any    # (R,)  (None on the golden path)
    active: Any      # (R,) bool: still inside the box
    engine: str      # "fused" | "golden" | "scan"
    mom_count: Any = None   # Welford p_x tracker (stats=True, stratified)
    mom_mean: Any = None
    mom_m2: Any = None


def supports(op_name: str, medium) -> bool:
    """True when a fused kernel covers this (op, medium) pairing."""
    op = canonical(op_name)
    if isinstance(medium, (StratifiedGridMedium, C1StratifiedMedium)):
        return op in FUSED_OPS or op in GOLDEN_OPS
    if isinstance(medium, CustomMedium):
        return op in FUSED_OPS or op in GOLDEN_OPS
    return (isinstance(medium, AnalyticMedium)
            and medium.field in FUSED_FIELDS
            and (op in FUSED_OPS or op in GOLDEN_OPS))


def fast_trace(op_name: str, scen: config.ScenarioConfig, medium, *,
               delta_s, pos0, theta0, steps: int | None = None,
               divisor: int | None = None, n_turns: int = config.N_TURNS,
               block_rays: int = 4096, interpret: bool | None = None,
               precision: str = "standard", stats: bool = False
               ) -> FastResult:
    """Metrics-only trace through the fastest available path.

    ``stats=True`` (stratified media only — where p_x is an exact
    invariant) rides the kernels' Welford momentum tracker and fills
    ``mom_count/mom_mean/mom_m2`` on the result: full-batch conservation
    CV at kernel speed, the reference's vert acceptance quantity
    (RT_bench.py:1352-1360) for user media.

    ``pos0`` (R, 2) / ``theta0`` (R,) are padded to a block multiple
    automatically (rays are independent; the padding is discarded).
    ``interpret`` defaults to the backend's kernel route
    (``kernels/route.py``).  2-D grid media run on the scan tier.

    ``precision="high"`` routes to the double-word float32 RK4 kernel
    (kernels/df.py — ~1e-7/turn trajectories in pure f32; requires op12 and
    a df-supported analytic field; no boundary mask or traveltime).
    """
    interpret = resolve_interpret(interpret)
    # batches pad to a multiple of 128 rays: every program width
    # (kernels/launch.program_rays) then divides the padded batch
    block_rays = max(128, -(-int(block_rays) // 128) * 128)
    op = canonical(op_name)

    # validate BEFORE any early-return path (df32, scan): otherwise
    # stats=True on a 2-D grid medium would silently return a result with
    # mom_* = None instead of the contracted ValueError
    if stats and not isinstance(medium, (StratifiedGridMedium,
                                         C1StratifiedMedium)):
        raise ValueError("stats=True needs a stratified (x-independent) "
                         "medium — p_x is only an invariant there; got "
                         f"{type(medium).__name__}")

    if precision == "high":
        from raytracing_tpu.kernels.df import DF_FIELDS, df_trace

        if op != "op12":
            raise ValueError("precision='high' uses the df32 RK4 kernel; "
                             f"pass op12 (got {op!r})")
        if not (isinstance(medium, AnalyticMedium)
                and medium.field in DF_FIELDS):
            raise ValueError(f"df32 kernel supports analytic {DF_FIELDS}")
        if steps is None:
            steps = scen.max_size(float(delta_s), divisor, n_turns) - 1
        r = len(theta0)
        pad = (-r) % block_rays
        pos0 = jnp.asarray(pos0, jnp.float32)
        theta0 = jnp.asarray(theta0, jnp.float32)
        if pad:
            pos0 = jnp.concatenate([pos0, jnp.tile(pos0[-1:], (pad, 1))])
            theta0 = jnp.concatenate([theta0, jnp.tile(theta0[-1:], pad)])
        pos = df_trace(pos0, theta0, jnp.float32(delta_s), steps=int(steps),
                       field=medium.field, block_rays=block_rays,
                       interpret=interpret)
        return FastResult(pos=pos[:r], traveltime=None, dist_sim=None,
                          active=np.ones(r, bool), engine="df32")
    if precision != "standard":
        raise ValueError(f"precision must be 'standard' or 'high', got {precision!r}")
    if steps is None:
        steps = scen.max_size(float(delta_s), divisor, n_turns) - 1

    # Past SEGMENT_THRESHOLD, fused and golden ops chain bounded segments
    # (below); custom-media kernels have no segmented variant, so for them
    # the scan engine is the path.  The reference's workloads never get
    # there (largest golden config is ~3300 steps).
    too_long = int(steps) > SEGMENT_THRESHOLD
    seg_eligible = ((op in FUSED_OPS or op in GOLDEN_OPS)
                    and (isinstance(medium, (StratifiedGridMedium,
                                             C1StratifiedMedium))
                         or (isinstance(medium, AnalyticMedium)
                             and medium.field in FUSED_FIELDS)))

    if not supports(op, medium) or (too_long and not seg_eligible):
        if stats:
            raise ValueError(f"stats=True has no kernel path for {op!r} on "
                             f"{type(medium).__name__} (scan fallback)")
        res = trace(op, scen, medium, delta_s=float(delta_s), divisor=divisor,
                    n_turns=n_turns, mode="metrics", dtype=np.float32,
                    max_size=steps + 1, pos0=pos0, theta0=theta0)
        # FastResult.active means "still inside the box"; the scan engine's
        # final.active means "still integrating" (False once the padded scan
        # completes), so derive the box mask from the frozen positions.
        return FastResult(pos=res.final.pos, traveltime=res.final.traveltime,
                          dist_sim=res.final.dist_sim,
                          active=~_outside(res.final.pos, tuple(scen.box)),
                          engine="scan")

    r = len(theta0)
    pad = (-r) % block_rays
    pos0 = jnp.asarray(pos0, jnp.float32)
    theta0 = jnp.asarray(theta0, jnp.float32)
    if pad:
        pos0 = jnp.concatenate([pos0, jnp.tile(pos0[-1:], (pad, 1))])
        theta0 = jnp.concatenate([theta0, jnp.tile(theta0[-1:], pad)])

    # Long traces chain bounded segments (identical results, tested).
    #
    # Exit scenarios (the interface/vert fans leave the box midway,
    # RT_bench.py:878-879's data-dependent break) also take the segmented
    # tier BY DEFAULT, with the batch sorted by launch angle so rays that
    # exit together share kernel programs and all-frozen programs bypass
    # the step loop on device (segmented_trace(skip_frozen=True)).  Per-ray
    # results do not depend on program membership, and the sort is undone,
    # so skipping changes nothing but the wasted work.
    exit_scen = scen.is_interface or scen.name == "vert"
    if (too_long or exit_scen) and seg_eligible:
        from raytracing_tpu.engine.segmented import segmented_trace

        inv = None
        if exit_scen:
            perm = jnp.argsort(theta0)
            inv = jnp.argsort(perm)
            pos0, theta0 = pos0[perm], theta0[perm]
        strat = isinstance(medium, (StratifiedGridMedium, C1StratifiedMedium))
        f = segmented_trace(
            op, pos0, theta0, jnp.float32(delta_s), steps=int(steps),
            box=tuple(scen.box),
            field=None if strat else scen.field,
            medium=medium if strat else None,
            segment=max(1, min(int(steps),
                               1024 if op in FUSED_OPS else 256)),
            block_rays=block_rays, interpret=interpret,
            gamma=float(scen.gamma), skip_frozen=exit_scen,
            with_stats=stats)

        def undo(a):
            if a is None:
                return None
            return (a if inv is None else a[inv])[:r]

        eng = "golden" if op in GOLDEN_OPS else "fused"
        eng += "-strat" if strat else ""
        eng += "-seg-skip" if exit_scen else "-seg"
        return FastResult(pos=undo(f.pos), traveltime=undo(f.traveltime),
                          dist_sim=undo(f.dist_sim), active=undo(f.active),
                          engine=eng, mom_count=undo(f.mom_count),
                          mom_mean=undo(f.mom_mean), mom_m2=undo(f.mom_m2))

    mom = (None, None, None)
    if isinstance(medium, (StratifiedGridMedium, C1StratifiedMedium)) \
            and op in GOLDEN_OPS:
        g = golden_trace_final(
            pos0, theta0, jnp.float32(delta_s), jnp.float32(scen.gamma),
            field=scen.field, op=op, steps=int(steps), box=tuple(scen.box),
            block_rays=block_rays, interpret=interpret, medium=medium,
            with_stats=stats)
        pos, tt, dsim, act = g.pos, g.traveltime, g.dist_sim, g.active
        if stats:
            mom = (g.mom_count, g.mom_mean, g.mom_m2)
        eng = "golden-strat"
    elif isinstance(medium, (StratifiedGridMedium, C1StratifiedMedium)):
        f = fused_trace_final_strat(
            pos0, theta0, jnp.float32(delta_s), medium, op=op,
            steps=int(steps), box=tuple(scen.box), block_rays=block_rays,
            interpret=interpret, with_stats=stats)
        pos, tt, dsim, act = f.pos, f.traveltime, f.dist_sim, f.active
        if stats:
            mom = (f.mom_count, f.mom_mean, f.mom_m2)
        eng = "fused-strat"
    elif isinstance(medium, CustomMedium) and op in GOLDEN_OPS:
        g = golden_trace_final(
            pos0, theta0, jnp.float32(delta_s), jnp.float32(scen.gamma),
            field=scen.field, op=op, steps=int(steps), box=tuple(scen.box),
            block_rays=block_rays, interpret=interpret, medium=medium)
        pos, tt, dsim, act = g.pos, g.traveltime, g.dist_sim, g.active
        eng = "golden-custom"
    elif isinstance(medium, CustomMedium):
        f = fused_trace_final_custom(
            pos0, theta0, jnp.float32(delta_s), medium=medium, op=op,
            steps=int(steps), box=tuple(scen.box), block_rays=block_rays,
            interpret=interpret)
        pos, tt, dsim, act = f.pos, f.traveltime, f.dist_sim, f.active
        eng = "fused-custom"
    elif op in GOLDEN_OPS:
        g = golden_trace_final(
            pos0, theta0, jnp.float32(delta_s), jnp.float32(scen.gamma),
            field=scen.field, op=op, steps=int(steps), box=tuple(scen.box),
            block_rays=block_rays, interpret=interpret)
        pos, tt, dsim, act = g.pos, g.traveltime, g.dist_sim, g.active
        eng = "golden"
    else:
        f = fused_trace_final(
            pos0, theta0, jnp.float32(delta_s), field=scen.field, op=op,
            steps=int(steps), box=tuple(scen.box), block_rays=block_rays,
            interpret=interpret)
        pos, tt, dsim, act = f.pos, f.traveltime, f.dist_sim, f.active
        eng = "fused"
    return FastResult(pos=pos[:r], traveltime=tt[:r],
                      dist_sim=dsim[:r] if dsim is not None else None,
                      active=act[:r], engine=eng,
                      mom_count=None if mom[0] is None else mom[0][:r],
                      mom_mean=None if mom[1] is None else mom[1][:r],
                      mom_m2=None if mom[2] is None else mom[2][:r])


def fast_dynamic(op_name: str, scen: config.ScenarioConfig, medium, *,
                 delta_s, pos0, theta0, steps: int | None = None,
                 divisor: int | None = None, n_turns: int = config.N_TURNS,
                 block_rays: int = 4096, interpret: bool | None = None):
    """Metrics-only DYNAMIC trace through the fastest available path.

    The dynamic twin of :func:`fast_trace`: routes to the fused dynamic
    kernel (kernels/dynamic.py — hand-derived paraxial tangents) for the
    analytic fields and the sampled stratified families, and falls back
    to the scan tier's exact jvp (engine/dynamic.trace_dynamic) everywhere
    else, 2-D grid media included (history mode callers use trace_dynamic
    directly).  Returns ``(DynFinal, engine)`` with engine in
    {"dynamic-kernel", "dynamic-kernel-strat", "dynamic-scan"}.

    Golden/Newton ops are rejected by the kernels and meaningless on the
    scan tier too (their tangent is zero a.e., engine/dynamic.py "Solver
    caveat") — they fall through to the scan fallback so callers get the
    same well-defined (if useless) jvp the scan tier gives.
    """
    from raytracing_tpu.engine.dynamic import trace_dynamic
    from raytracing_tpu.kernels.dynamic import (
        DYN_FUSED_FIELDS, DYN_FUSED_OPS, DynFinal, dynamic_trace_final,
        dynamic_trace_final_strat)

    interpret = resolve_interpret(interpret)
    block_rays = max(128, -(-int(block_rays) // 128) * 128)
    op = canonical(op_name)
    if steps is None:
        steps = scen.max_size(float(delta_s), divisor, n_turns) - 1

    kernel = None
    if op in DYN_FUSED_OPS:
        if (isinstance(medium, AnalyticMedium)
                and medium.field in DYN_FUSED_FIELDS):
            kernel, eng = (
                lambda p, t: dynamic_trace_final(
                    p, t, jnp.float32(delta_s), field=medium.field, op=op,
                    steps=int(steps), box=tuple(scen.box),
                    block_rays=block_rays, interpret=interpret),
                "dynamic-kernel")
        elif isinstance(medium, (StratifiedGridMedium, C1StratifiedMedium)):
            kernel, eng = (
                lambda p, t: dynamic_trace_final_strat(
                    p, t, jnp.float32(delta_s), medium, op=op,
                    steps=int(steps), box=tuple(scen.box),
                    block_rays=block_rays, interpret=interpret),
                "dynamic-kernel-strat")
    if kernel is not None:
        r = len(theta0)
        pad = (-r) % block_rays
        pos0 = jnp.asarray(pos0, jnp.float32)
        theta0 = jnp.asarray(theta0, jnp.float32)
        if pad:
            pos0 = jnp.concatenate([pos0, jnp.tile(pos0[-1:], (pad, 1))])
            theta0 = jnp.concatenate([theta0, jnp.tile(theta0[-1:], pad)])
        res = kernel(pos0, theta0)
        if pad:
            res = DynFinal(*(v[:r] for v in res))
        return res, eng

    d = trace_dynamic(op, scen, medium, delta_s=float(delta_s),
                      mode="metrics", dtype=np.float32,
                      pos0=jnp.asarray(pos0, jnp.float32),
                      theta0=jnp.asarray(theta0, jnp.float32),
                      max_size=int(steps) + 1,
                      step_limit=int(steps))
    tangent = jnp.stack([jnp.cos(d.angle), jnp.sin(d.angle)], axis=-1)
    # "active" = still inside the box, matching the kernel tier: exit_step
    # alone is ambiguous (a ray exiting exactly at step i == steps also
    # carries exit_step == steps), so test containment of the final
    # position (frozen at the exit point for exited rays).
    bx = jnp.asarray(tuple(scen.box), jnp.float32)
    active = ((d.pos[:, 0] >= bx[0]) & (d.pos[:, 0] <= bx[1])
              & (d.pos[:, 1] >= bx[2]) & (d.pos[:, 1] <= bx[3]))
    return (DynFinal(pos=d.pos, tangent=tangent, n=d.n,
                     traveltime=d.traveltime, dist_sim=d.dist_sim,
                     active=active, q=d.q,
                     dtheta=d.dtheta, kmah=d.kmah),
            "dynamic-scan")


def _pad3(pos0, dir0, block_rays):
    """(pos0, dir0) as float32, padded to a ``block_rays`` multiple."""
    r = len(dir0)
    pad = (-r) % block_rays
    pos0 = jnp.asarray(pos0, jnp.float32)
    dir0 = jnp.asarray(dir0, jnp.float32)
    if pad:
        pos0 = jnp.concatenate([pos0, jnp.tile(pos0[-1:], (pad, 1))])
        dir0 = jnp.concatenate([dir0, jnp.tile(dir0[-1:], (pad, 1))])
    return pos0, dir0, r


def fast_dynamic3(method: str, medium, *, pos0, dir0, delta_s, steps: int,
                  box, block_rays: int = 1024,
                  interpret: bool | None = None):
    """Metrics-only 3-D DYNAMIC trace through the fastest available path.

    Routes to the fused 3-D dynamic kernel (kernels/dynamic3d.py —
    hand-derived two-tangent recurrences with the frame-free
    ``det Q = (dpa x dpb) . u``) for the analytic fields, and falls back
    to the scan tier's exact jvp (engine/dynamic3d.trace_dynamic3)
    everywhere else — sampled C1Grid3Medium, Custom3D / Stratified3D
    media, history callers.  Returns ``(Dyn3Final, engine)`` with engine
    in {"dynamic3-kernel", "dynamic3-scan"}.
    """
    from raytracing_tpu.engine.dynamic3d import trace_dynamic3
    from raytracing_tpu.engine.trace3d import canonical3
    from raytracing_tpu.kernels.dynamic3d import (DYN3_FUSED_FIELDS,
                                                  DYN3_FUSED_OPS, Dyn3Final,
                                                  dynamic3d_trace_final)
    from raytracing_tpu.media.fields3d import Analytic3D

    interpret = resolve_interpret(interpret)
    block_rays = max(128, -(-int(block_rays) // 128) * 128)
    method = canonical3(method)
    if box is None or len(tuple(box)) != 6:
        raise ValueError(f"fast_dynamic3 needs a 6-face box, got {box!r}")

    if (method in DYN3_FUSED_OPS and isinstance(medium, Analytic3D)
            and medium.field in DYN3_FUSED_FIELDS):
        pos0, dir0, r = _pad3(pos0, dir0, block_rays)
        res = dynamic3d_trace_final(
            pos0, dir0, jnp.float32(delta_s), field=medium.field,
            op=method, steps=int(steps), box=tuple(box),
            block_rays=block_rays, interpret=interpret)
        return Dyn3Final(*(v[:r] for v in res)), "dynamic3-kernel"

    d = trace_dynamic3(method, medium, pos0=pos0, dir0=dir0,
                       delta_s=float(delta_s), steps=int(steps),
                       box=tuple(box), mode="metrics", dtype=np.float32)
    # "active" = never left the box (kernel semantics): containment of the
    # final position, not the budget-folding scan flag
    bx = jnp.asarray(tuple(box), jnp.float32)
    active = ((d.pos[:, 0] >= bx[0]) & (d.pos[:, 0] <= bx[1])
              & (d.pos[:, 1] >= bx[2]) & (d.pos[:, 1] <= bx[3])
              & (d.pos[:, 2] >= bx[4]) & (d.pos[:, 2] <= bx[5]))
    return (Dyn3Final(pos=d.pos, tangent=d.unitv,
                      traveltime=d.traveltime, dist_sim=d.dist_sim,
                      active=active, detq=d.detq, kmah=d.kmah, n=d.n,
                      min_absdet=d.min_absdet,
                      min_absdet_step=d.min_absdet_step),
            "dynamic3-scan")


def fast_trace3(method: str, medium, *, pos0, dir0, delta_s, steps: int,
                box, block_rays: int = 4096,
                interpret: bool | None = None):
    """Metrics-only 3-D trace through the fastest available path.

    The 3-D twin of :func:`fast_trace`: routes (method, medium) to the
    fused 3-D kernel (kernels/fused3d.py) when the vector op and the
    analytic field are in its coverage, and to the scan tier
    (engine/trace3d.trace3d, mode="metrics") for everything else —
    sampled tri-Hermite C1Grid3Medium (the sample->fit->trace path,
    RT_bench.py:412-464), Custom3D / Stratified3D media, history/stats
    callers.  Returns ``(Fused3Final, engine)`` with engine in
    {"fused3d", "scan3d"}.
    """
    from raytracing_tpu.engine.trace3d import canonical3, trace3d
    from raytracing_tpu.kernels.fused3d import (
        FUSED3_FIELDS, FUSED3_OPS, Fused3Final, fused3d_trace_final)
    from raytracing_tpu.media.fields3d import Analytic3D

    interpret = resolve_interpret(interpret)
    block_rays = max(128, -(-int(block_rays) // 128) * 128)
    method = canonical3(method)
    if box is None or len(tuple(box)) != 6:
        raise ValueError(f"fast_trace3 needs a 6-face box, got {box!r}")

    if (method in FUSED3_OPS and isinstance(medium, Analytic3D)
            and medium.field in FUSED3_FIELDS):
        pos0, dir0, r = _pad3(pos0, dir0, block_rays)
        res = fused3d_trace_final(
            pos0, dir0, jnp.float32(delta_s), field=medium.field,
            op=method, steps=int(steps), box=tuple(box),
            block_rays=block_rays, interpret=interpret)
        return Fused3Final(*(v[:r] for v in res)), "fused3d"

    t = trace3d(method, medium, pos0=pos0, dir0=dir0,
                delta_s=float(delta_s), steps=int(steps), box=tuple(box),
                mode="metrics", dtype=np.float32)
    st = t.final
    # "active" = never left the box, matching the kernel tiers: the scan's
    # own flag also folds in step-budget exhaustion (False for every ray at
    # i == step_limit), so test containment of the final position instead.
    bx = jnp.asarray(tuple(box), jnp.float32)
    active = ((st.pos[:, 0] >= bx[0]) & (st.pos[:, 0] <= bx[1])
              & (st.pos[:, 1] >= bx[2]) & (st.pos[:, 1] <= bx[3])
              & (st.pos[:, 2] >= bx[4]) & (st.pos[:, 2] <= bx[5]))
    return (Fused3Final(pos=st.pos, tangent=st.unitv,
                        traveltime=st.traveltime, dist_sim=st.dist_sim,
                        active=active),
            "scan3d")


@functools.lru_cache(maxsize=32)
def _sharded_runner(mesh, op, kind, custom, field, steps, box, block_rays,
                    interpret, stats):
    """One jitted shard_map per configuration: ``(pos0, theta0, delta_s,
    gamma, tables) -> result`` with rays sharded over every mesh axis and
    the scalars and medium tables replicated."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    axes = mesh.axis_names
    golden = op in GOLDEN_OPS

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(axes), P(axes), P(), P(), P()),
                       out_specs=P(axes),
                       check_vma=False)  # pallas out_shapes carry no vma
    def run(p, t, ds, gamma, tables):
        medium = tables if kind == "strat" else custom
        if golden:
            # rays are independent; tables and fields replicate
            return golden_trace_final(
                p, t, ds, gamma, field=field, op=op, steps=steps, box=box,
                block_rays=block_rays, interpret=interpret, with_stats=stats,
                medium=medium)
        if kind == "strat":
            return fused_trace_final_strat(
                p, t, ds, medium, op=op, steps=steps, box=box,
                block_rays=block_rays, interpret=interpret, with_stats=stats)
        if kind == "custom":
            return fused_trace_final_custom(
                p, t, ds, medium=medium, op=op, steps=steps, box=box,
                block_rays=block_rays, interpret=interpret)
        return fused_trace_final(p, t, ds, field=field, op=op, steps=steps,
                                 box=box, block_rays=block_rays,
                                 interpret=interpret)

    return run


def fast_trace_sharded(op_name: str, scen: config.ScenarioConfig, medium, *,
                       delta_s, pos0, theta0, mesh, steps: int,
                       block_rays: int = 4096,
                       interpret: bool | None = None,
                       stats: bool = False) -> FastResult:
    """Fused-kernel tracing with the ray batch sharded across ``mesh``.

    Each device runs the kernel on its local shard under ``shard_map`` —
    the multi-device path (kernels x mesh).  The batch must divide by
    (device count x block_rays).  Media with no kernel (2-D grid media)
    take the scan tier with the launch arrays laid out over the mesh:
    each device scans its own rays, with no collective (engine
    ``"scan-sharded"``).

    ``stats=True`` (stratified media only, same contract as
    :func:`fast_trace`) rides the kernels' Welford momentum tracker on
    every shard — the per-ray aggregates come back sharded like the rest
    of the result, so the reference's conservation bar
    (RT_bench.py:1352-1360) is assertable on multi-chip runs too.
    """
    from jax.sharding import PartitionSpec as P

    interpret = resolve_interpret(interpret)
    op = canonical(op_name)
    if stats and not isinstance(medium, (StratifiedGridMedium,
                                         C1StratifiedMedium)):
        raise ValueError("stats=True needs a stratified (x-independent) "
                         "medium — p_x is only an invariant there; got "
                         f"{type(medium).__name__}")

    kernel = supports(op, medium)
    n_dev = mesh.devices.size
    unit = n_dev * block_rays if kernel else n_dev
    r = len(theta0)
    if r % unit:
        raise ValueError(f"ray count {r} must divide by "
                         + (f"devices*block ({n_dev}*{block_rays})" if kernel
                            else f"devices ({n_dev})"))
    axes = mesh.axis_names
    pos0 = jax.device_put(jnp.asarray(pos0, jnp.float32),
                          jax.NamedSharding(mesh, P(axes)))
    theta0 = jax.device_put(jnp.asarray(theta0, jnp.float32),
                            jax.NamedSharding(mesh, P(axes)))
    if not kernel:
        # the jitted scan takes its ray layout from the launch arrays
        res = fast_trace(op, scen, medium, delta_s=delta_s, pos0=pos0,
                         theta0=theta0, steps=steps)
        return res._replace(engine="scan-sharded")

    golden = op in GOLDEN_OPS
    use_strat = isinstance(medium, (StratifiedGridMedium, C1StratifiedMedium))
    use_custom = isinstance(medium, CustomMedium)

    run = _sharded_runner(mesh, op, "strat" if use_strat else "custom"
                          if use_custom else "analytic",
                          medium if use_custom else None, scen.field,
                          int(steps), tuple(scen.box), block_rays,
                          interpret, stats)
    f = run(pos0, theta0, jnp.float32(delta_s), jnp.float32(scen.gamma),
            medium if use_strat else None)
    eng = (("golden" if golden else "fused")
           + ("-strat" if use_strat else "-custom" if use_custom else "")
           + "-sharded")
    return FastResult(pos=f.pos, traveltime=f.traveltime, dist_sim=f.dist_sim,
                      active=f.active, engine=eng,
                      mom_count=f.mom_count if stats else None,
                      mom_mean=f.mom_mean if stats else None,
                      mom_m2=f.mom_m2 if stats else None)
