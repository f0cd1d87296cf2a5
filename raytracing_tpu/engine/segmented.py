"""Segmented fused tracing: resumable kernels + live-ray compaction.

Two problems share one mechanism:

1. **Bounded kernel trip counts** — chaining a *resumable* kernel
   (``_make_kernel(..., resume=True)``) from an outer ``lax.fori_loop``
   bounds the in-kernel trip count to ``segment`` steps: one compiled
   kernel serves any trajectory length, with the full integration state
   (Kahan compensations, op7 window, Welford stats) riding between
   launches in device memory — amortized traffic ~26 B / ray / segment,
   negligible for segment >= 128.  (The bound was set for a compiler whose
   time grew with the trip count; whether Triton needs it is open.)

2. **Frozen lanes waste throughput** (SURVEY §7 hard part #3): interface /
   vert rays exit the box early (RT_bench.py:878-879 breaks out; the fused
   kernels only mask).  Between segments the host compacts surviving rays
   to the front and continues on the smaller prefix, so reported work
   approaches *live-ray* throughput instead of lane throughput.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu.kernels.fused import (FUSED_OPS, FusedFinal, _make_kernel,
                                          strat_tables)
from raytracing_tpu.kernels.golden import GOLDEN_OPS
from raytracing_tpu.kernels.golden import _make_kernel as _make_golden_kernel
from raytracing_tpu.kernels.golden import golden_scalars
from raytracing_tpu.kernels.launch import program_flags, ray_block_call
from raytracing_tpu.media.spline import StratifiedGridMedium


def _fingerprint(*arrays) -> str:
    """sha1 over dtype/shape/bytes of each array — checkpoint identity for
    medium tables and launch fans (a resume adopts the saved carry, so a
    silently different medium/fan would hybridize two traces)."""
    import hashlib

    h = hashlib.sha1()
    for a in arrays:
        a = np.asarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _state_layout(op: str, with_stats: bool) -> tuple[int, int]:
    """(n_state, act_idx) of the kernels' resume-state layout.

    The ONE home for the layout the segmented tier and the checkpoint
    format share; see :func:`_initial_comps` for the
    component order.
    """
    if op in GOLDEN_OPS:
        return 8 + (3 if with_stats else 0), 7
    return 9 + (3 if with_stats else 0) + (4 if op == "op7" else 0), 8


def _initial_comps(op: str, pos0, theta0, *, with_stats: bool,
                   n0_fn=None, gamma: float = 1.0) -> list:
    """Initial (r,)-component list in the kernels' resume layout.

    golden: (x, y, cx, cy, ang, tt, dsim, active) [+ Welford(count,mean,m2)]
    fused:  (x, y, ux, uy, cx, cy, tt, dsim, active) [+ Welford]
            [+ op7 window (x, y, x, y)]

    ``n0_fn(x, y)`` supplies the launch-point index, needed only when
    ``with_stats`` seeds the Welford momentum tracker.
    """
    x, y = pos0[:, 0], pos0[:, 1]
    r = x.shape[0]
    zeros = jnp.zeros(r, jnp.float32)
    ones = jnp.ones(r, jnp.float32)
    n0 = n0_fn(x, y).astype(jnp.float32) if with_stats else None
    if op in GOLDEN_OPS:
        comps = [x, y, zeros, zeros, theta0, zeros, zeros, ones]
        if with_stats:
            from raytracing_tpu.kernels.golden import init_mom_x

            comps += [ones, init_mom_x(op, n0, theta0, gamma), zeros]
        return comps
    ux = jnp.cos(theta0)
    uy = jnp.sin(theta0)
    comps = [x, y, ux, uy, zeros, zeros, zeros, zeros, ones]
    if with_stats:
        comps += [ones, n0 * ux, zeros]
    if op == "op7":
        comps += [x, y, x, y]
    return comps


def _final_from_state(op: str, out, with_stats: bool) -> FusedFinal:
    """FusedFinal from flat (r,) state components (layout above)."""
    if op in GOLDEN_OPS:
        ang = out[4]
        res = FusedFinal(
            pos=jnp.stack([out[0], out[1]], axis=-1),
            tangent=jnp.stack([jnp.cos(ang), jnp.sin(ang)], axis=-1),
            traveltime=out[5], dist_sim=out[6], active=out[7] > 0.5)
        if with_stats:
            res = res._replace(mom_count=out[8], mom_mean=out[9],
                               mom_m2=out[10])
        return res
    res = FusedFinal(
        pos=jnp.stack([out[0], out[1]], axis=-1),
        tangent=jnp.stack([out[2], out[3]], axis=-1),
        traveltime=out[6], dist_sim=out[7], active=out[8] > 0.5)
    if with_stats:
        res = res._replace(mom_count=out[9], mom_mean=out[10],
                           mom_m2=out[11])
    return res


@functools.partial(jax.jit, static_argnames=(
    "field", "op", "segment", "box", "interpret", "stats", "strat",
    "n_state", "skip", "gold_schedule"))
def _run_segments(state, tables, delta_s, limit, offset0, n_seg,
                  gamma=1.0, *, field, op, segment, box, interpret, stats,
                  strat, n_state, skip=False, gold_schedule=None):
    """Chain ``n_seg`` resumable kernel launches under one jit.

    ``skip=True`` computes a per-program liveness table before every
    launch (one reduction over the active mask) and hands it to the
    kernel, which bypasses the step loop for programs whose every ray has
    frozen (``_make_kernel(skip=True)``) — the device-side equivalent of
    the reference's data-dependent loop break (RT_bench.py:878-879), no
    host round-trips.  Effective when launch batches are ordered so rays
    that exit together share programs.
    """
    from raytracing_tpu.config import gold_tol
    from raytracing_tpu.kernels.golden import golden_schedule
    golden = op in GOLDEN_OPS
    if golden:
        iters, polish = gold_schedule or golden_schedule()
        kernel = _make_golden_kernel(
            field, op, segment, box, iters, gold_tol(np.float32),
            strat=strat, stats=stats, resume=True, skip=skip, polish=polish)
    else:
        kernel = _make_kernel(field, op, segment, box, gold_tol(np.float32),
                              strat=strat, stats=stats, resume=True,
                              skip=skip)
    act_idx = 7 if golden else 8   # `active` slot in the resume state
    name = f"{'golden' if golden else 'fused'}_{op}_resume"

    def seg_body(k, st):
        offset = offset0 + k.astype(jnp.float32) * segment
        if golden:
            ds_vec = golden_scalars(delta_s, gamma, limit, offset, iters)
        else:
            ds_vec = jnp.stack([delta_s, limit, offset])
        flags = program_flags(st[act_idx]) if skip else None
        return tuple(ray_block_call(
            kernel, st, ds_vec, n_state,
            tables=() if tables is None else (tables,), flags=flags,
            interpret=interpret, name=name))

    return jax.lax.fori_loop(0, n_seg, seg_body, tuple(state))


def segmented_trace(op: str, pos0, theta0, delta_s, *, steps: int, box,
                    field: str | None = None, medium=None, segment: int = 256,
                    block_rays: int = 4096, interpret: bool | None = None,
                    with_stats: bool = False, compact: bool = False,
                    compact_every: int = 4,
                    compact_threshold: float = 0.75,
                    skip_frozen: bool = False,
                    gamma: float = 1.0,
                    checkpoint: str | None = None,
                    checkpoint_every: int = 64,
                    gold_schedule: tuple | None = None) -> FusedFinal:
    """Fused trace in bounded-compile segments, optionally compacting.

    ``compact=True`` checks the live fraction every ``compact_every``
    segments and, when it drops below ``compact_threshold``, gathers the
    surviving rays to a smaller padded batch (frozen rays' final states are
    banked and re-scattered at the end).  Results are identical to the
    one-shot kernel; only the wasted lane work changes.

    ``skip_frozen=True`` instead skips whole kernel programs whose every
    ray has exited (per-program liveness table + ``pl.when`` bypass — see
    ``_run_segments``).  Unlike ``compact`` this never leaves the device,
    so it pays no host round trip; it needs the launch batch ordered so
    rays that exit together share programs (e.g. the interface fan sorted
    by launch angle).  The two compose.

    ``gold_schedule=(iters, polish)`` overrides the golden-family bracket
    schedule (kernels.golden.golden_schedule); ``(16, 0)`` is the pure-f32
    reference-parity bracket, under which segmented results remain
    bit-identical to the one-shot golden kernel.  The default polished
    schedule derives the tangent by rotation, which each segment start
    resets to cos/sin of the carried angle — so a re-segmented run agrees
    with one-shot only to ~1e-5 (checkpoint resume of the SAME segmentation
    stays bit-identical).

    ``checkpoint=`` persists the full resumable state every
    ``checkpoint_every`` segments (utils.checkpoint.TraceCheckpoint): a
    preempted run restarted with the same arguments resumes from the last
    saved segment bit-identically.  Incompatible with ``compact`` (the
    banked-ray side state is not captured).
    """
    golden = op in GOLDEN_OPS
    if not golden and op not in FUSED_OPS:
        raise ValueError(f"segmented trace supports ops {FUSED_OPS} and "
                         f"{tuple(GOLDEN_OPS)}, got {op!r}")
    if segment < 1 or compact_every < 1 or checkpoint_every < 1:
        # a zero cadence would make the host loop spin without progress
        raise ValueError("segment, compact_every and checkpoint_every must "
                         f"be >= 1, got {segment}/{compact_every}/"
                         f"{checkpoint_every}")
    from raytracing_tpu.media.c1 import C1StratifiedMedium

    use_strat = isinstance(medium, (StratifiedGridMedium, C1StratifiedMedium))
    if not use_strat and field is None:
        raise ValueError("pass field= (analytic) or medium= (stratified)")
    r = pos0.shape[0]
    if r % block_rays:
        raise ValueError(f"rays {r} not a multiple of block {block_rays}")
    n_state, act_idx = _state_layout(op, with_stats)

    # initial full state, device-resident (r,) components; all host<->device
    # traffic below is index arrays at compaction events only
    pos0 = jnp.asarray(pos0, jnp.float32)
    theta0 = jnp.asarray(theta0, jnp.float32)
    if use_strat:
        n0_fn = medium.n
    else:
        from raytracing_tpu.media.fields import FIELDS
        n0_fn = FIELDS[field][0]
    comps = _initial_comps(op, pos0, theta0, with_stats=with_stats,
                           n0_fn=n0_fn, gamma=gamma)

    tables = strat = None
    if use_strat:
        tables, strat = strat_tables(medium)

    n_seg_total = -(-steps // segment)
    limit = jnp.float32(steps)
    orig_idx = np.arange(r)              # current batch -> original ray slot
    banked = None                        # device (r,) result arrays, lazy
    done_segs = 0
    state = tuple(comps)

    store = None
    if checkpoint is not None:
        if compact:
            raise ValueError("checkpoint does not compose with compact "
                             "(banked-ray side state is not captured)")
        from raytracing_tpu.utils.checkpoint import TraceCheckpoint

        # identity = everything that must match for the carry to continue
        # the same physics — including the box, the medium's actual tables
        # and the launch fan (the saved carry replaces pos0/theta0 on
        # resume, so a mismatch would silently hybridize two traces).
        # Total `steps` is progress, not identity: a resumed run may
        # extend the horizon while no saved segment was limit-clamped.
        store = TraceCheckpoint(checkpoint, meta={
            "op": op, "rays": int(r), "delta_s": float(delta_s),
            "segment": int(segment), "n_state": int(n_state),
            "field": field or "stratified", "gamma": float(gamma),
            "box": [float(v) for v in box],
            "medium_sha1": (_fingerprint(*jax.tree_util.tree_leaves(medium))
                            if use_strat else None),
            "launch_sha1": _fingerprint(pos0, theta0),
            "skip_frozen": bool(skip_frozen),
            "gold_schedule": list(gold_schedule) if gold_schedule else None})
        resumed = store.load()
        if resumed is not None:
            arrays, done_steps0, horizon0 = resumed
            if done_steps0 > horizon0:
                # the saved final segment was limit-clamped at horizon0: the
                # carry holds the state at exactly horizon0 and can neither
                # be advanced (steps horizon0..done were masked, not
                # integrated) nor rolled back
                if steps != horizon0:
                    raise ValueError(
                        f"checkpoint {checkpoint} holds a COMPLETED "
                        f"{horizon0}-step trace; it cannot resume with "
                        f"steps={steps} — re-trace from scratch")
            elif steps < done_steps0:
                raise ValueError(
                    f"checkpoint {checkpoint} has already integrated "
                    f"{done_steps0} steps; it cannot resume with the "
                    f"shorter horizon steps={steps}")
            state = tuple(jnp.asarray(a).reshape(-1) for a in arrays)
            done_segs = done_steps0 // segment

    while done_segs < n_seg_total:
        if compact:
            n_run = min(compact_every, n_seg_total - done_segs)
        elif store is not None:
            n_run = min(checkpoint_every, n_seg_total - done_segs)
        else:
            n_run = n_seg_total - done_segs
        state = _run_segments(
            state, tables, jnp.float32(delta_s), limit,
            jnp.float32(done_segs * segment), jnp.int32(n_run),
            jnp.float32(gamma),
            field=field or "stratified", op=op, segment=segment,
            box=tuple(box), interpret=interpret, stats=with_stats,
            strat=strat, n_state=n_state, skip=skip_frozen,
            gold_schedule=gold_schedule)
        done_segs += n_run
        if store is not None:
            store.save([np.asarray(s) for s in state],
                       done_segs * segment, steps)
        if not compact or done_segs >= n_seg_total:
            continue
        # 1 byte/ray download
        act = np.asarray(state[act_idx]) > 0.5
        # orig_idx == -1 marks padding duplicates: never bank or keep them
        act &= orig_idx >= 0
        # live fraction over REAL rays — counting padding lanes in the
        # denominator would re-trigger no-op compactions forever on a
        # padding-dominated batch
        n_real = int((orig_idx >= 0).sum())
        live = act.sum() / max(n_real, 1)
        frozen = (~act) & (orig_idx >= 0)
        if live >= compact_threshold or not frozen.any():
            continue
        if banked is None:
            banked = [jnp.zeros(r, jnp.float32) for _ in range(n_state)]
        # bank frozen rays' final state on device (host only sees indices)
        cur_f = jnp.asarray(np.nonzero(frozen)[0], jnp.int32)
        dst_f = jnp.asarray(orig_idx[frozen], jnp.int32)
        flat = list(state)
        banked = [b.at[dst_f].set(f[cur_f]) for b, f in zip(banked, flat)]
        alive_idx = np.nonzero(act)[0]
        if len(alive_idx) == 0:
            orig_idx = orig_idx[:0]
            state = None
            break
        n_alive = len(alive_idx)
        n_pad = -(-n_alive // block_rays) * block_rays
        sel = np.concatenate([alive_idx,
                              np.full(n_pad - n_alive, alive_idx[-1])])
        sel_d = jnp.asarray(sel, jnp.int32)
        comps = [f[sel_d] for f in flat]
        # padding lanes are duplicates: freeze them so they neither move
        # nor get banked (they are re-banked from the true lane)
        comps[act_idx] = comps[act_idx].at[n_alive:].set(0.0)
        orig_idx = np.concatenate(
            [orig_idx[alive_idx], np.full(n_pad - n_alive, -1)])
        state = tuple(comps)

    if banked is None:
        out = list(state)                         # no compaction happened
    else:
        out = banked
        if state is not None:
            keep = orig_idx >= 0
            src = jnp.asarray(np.nonzero(keep)[0], jnp.int32)
            dst = jnp.asarray(orig_idx[keep], jnp.int32)
            out = [b.at[dst].set(f[src]) for b, f in zip(out, state)]

    return _final_from_state(op, out, with_stats)
