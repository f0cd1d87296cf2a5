"""The integrator core: ``lax.scan`` over steps x ray batch.

The batched replacement for the reference's ``trazar`` (RT_bench.py:766-948):
the per-ray serial Python loop becomes a single ``lax.scan`` whose carry is
the state of *all* rays (:class:`RayState`), so one ray or a million trace in
the same compiled program.  The data-dependent boundary exit
(RT_bench.py:878-879) becomes an active mask: a finished ray's state freezes
and its remaining history rows stay zero, matching the reference's
preallocated-zeros convention (RT_bench.py:800-805) that downstream metrics
rely on (zero-masked momentum CV, RT_bench.py:1358).

Two output modes:

* ``history``  — per-step trajectory rows (the reference's ``s_ray``/
  ``n_ray``), needed for plotting and the interface/wavefront oracles.
  Memory scales as rays x steps.
* ``metrics``  — carry-only: final state plus Welford momentum statistics.
  O(rays) memory regardless of trajectory length; the benchmark path.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu import config
from raytracing_tpu.engine.state import RayState, where_state
from raytracing_tpu.media.fields import anisotropy
from raytracing_tpu.ops import angles as A
from raytracing_tpu.ops.momentum import moments
from raytracing_tpu.ops.registry import RayPoint, build_op, canonical


class TraceResult(NamedTuple):
    """Everything ``trazar`` returned, restructured for batch access.

    Deliberate divergence: the reference's per-ray ``compute_times``
    (RT_bench.py:800, 882 — Python perf_counter brackets, with an off-by-one
    storing ray 0's time in the last slot) has no meaning for a batch that
    integrates in lockstep on an accelerator; wall-clock and throughput come
    from :mod:`raytracing_tpu.bench.harness` / ``utils.profiling`` instead.
    """

    final: RayState     # state after the last step
    exit_step: Any      # (R,) int32 — d_ray[2]
    dist_real: Any      # (R,) — d_ray[0]
    dist_sim: Any       # (R,) — d_ray[1]
    history: Any        # (max_size, R, 6) [x, y, mx, my, traveltime, angle] or None
    n_hist: Any         # (max_size, R) coef*n per row, or None

    def reference_layout(self):
        """Return (s_ray, n_ray) in the reference's (max_size, 6, R) layout."""
        if self.history is None:
            raise ValueError("trace ran in metrics mode; no history stored")
        return np.transpose(np.asarray(self.history), (0, 2, 1)), np.asarray(self.n_hist)


def initial_state(pos0, theta0, medium, gamma, *, with_window: bool,
                  with_momentum_stats: bool, max_size: int) -> RayState:
    """Initial conditions for a ray batch (RT_bench.py:809-826)."""
    pos0 = jnp.asarray(pos0)
    theta0 = jnp.asarray(theta0)
    unitv = jnp.stack([jnp.cos(theta0), jnp.sin(theta0)], axis=-1)
    n0, (gx, gy) = medium.n_and_grad(pos0[..., 0], pos0[..., 1])
    grad0 = jnp.stack([gx, gy], axis=-1)
    coef0 = anisotropy(theta0, gamma)
    m0 = moments(theta0, n0, unitv, gamma)
    zeros = jnp.zeros_like(theta0)
    r = theta0.shape[0]
    return RayState(
        pos=pos0, angle=theta0, unitv=unitv, n=n0, grad=grad0, coef=coef0,
        n_eff=coef0 * n0, m=m0, traveltime=zeros, dist_sim=zeros,
        dist_real=zeros, active=jnp.ones(r, dtype=bool),
        exit_step=jnp.full(r, max_size - 1, dtype=jnp.int32),
        window=jnp.broadcast_to(pos0[:, None, :], (r, 4, 2)) if with_window else None,
        mom_count=jnp.ones_like(theta0) if with_momentum_stats else None,
        mom_mean=m0[..., 0] if with_momentum_stats else None,
        mom_m2=zeros if with_momentum_stats else None,
    )


def _outside(pos, box):
    """Strict boundary test (RT_bench.py:878)."""
    limx_i, limx_s, limy_i, limy_s = box
    x, y = pos[..., 0], pos[..., 1]
    return (x > limx_s) | (x < limx_i) | (y > limy_s) | (y < limy_i)


@functools.lru_cache(maxsize=None)
def _build_trace_fn(op_name: str, max_size: int, box, mode: str,
                    with_momentum_stats: bool, dtype_name: str):
    """Compile-cached core: scan ``max_size - 1`` steps of op ``op_name``."""
    dtype = np.dtype(dtype_name)
    op = build_op(op_name, dtype)
    history = mode == "history"

    def run(st0: RayState, medium, gamma, delta_s, step_limit, step_offset=0):
        # medium/gamma/delta_s/step_limit are traced operands, not
        # compile-time constants, so one compiled program serves every step
        # size / gamma (the DELTA_S sweep vmaps over them).  ``step_offset``
        # makes the scan's step indices global for chunked/segmented runs
        # (engine/streaming.py) — op7's order ramp and exit_step then survive
        # segment restarts; the default 0 folds away.

        def body(st: RayState, i):
            pt = RayPoint(pos=st.pos, angle=st.angle, unitv=st.unitv, n=st.n,
                          grad=st.grad, coef=st.coef, window=st.window)
            res = op(pt, i, medium, gamma, delta_s)

            # store_update_results (RT_bench.py:783-790, 870-875)
            dist = jnp.linalg.norm(st.pos - res.pos, axis=-1)
            unitv_f = jnp.stack([jnp.cos(res.angle), jnp.sin(res.angle)], axis=-1)
            coef_f = anisotropy(res.angle, gamma)
            m_f = moments(res.angle, res.n, unitv_f, gamma)
            n_eff_f = coef_f * res.n
            tt_f = st.traveltime + dist * (st.n_eff + n_eff_f) / 2.0

            if with_momentum_stats:
                mx = m_f[..., 0]
                cnt = st.mom_count + 1.0
                delta = mx - st.mom_mean
                mean = st.mom_mean + delta / cnt
                m2 = st.mom_m2 + delta * (mx - mean)
            else:
                cnt = mean = m2 = None

            new = RayState(
                pos=res.pos, angle=res.angle, unitv=unitv_f, n=res.n,
                grad=res.grad, coef=coef_f, n_eff=n_eff_f, m=m_f,
                traveltime=tt_f, dist_sim=st.dist_sim + dist,
                dist_real=st.dist_real + delta_s,
                active=st.active, exit_step=st.exit_step,
                window=(A.push_window(st.window, res.pos)
                        if st.window is not None else None),
                mom_count=cnt, mom_mean=mean, mom_m2=m2,
            )
            st2 = where_state(st.active, new, st)

            out = _outside(st2.pos, box)
            newly_exited = st.active & out
            exit_step = jnp.where(newly_exited, i, st.exit_step)
            active2 = st.active & ~out & (i < step_limit)
            st2 = st2._replace(active=active2, exit_step=exit_step)

            if history:
                row = jnp.stack([st2.pos[..., 0], st2.pos[..., 1],
                                 st2.m[..., 0], st2.m[..., 1],
                                 st2.traveltime, st2.angle], axis=-1)
                mask = st.active[..., None]
                ys = (jnp.where(mask, row, 0.0),
                      jnp.where(st.active, st2.n_eff, 0.0))
            else:
                ys = None
            return st2, ys

        # In a padded scan the effective last row is step_limit, not
        # max_size - 1; rays that never exit the box report it as exit_step.
        st0 = st0._replace(exit_step=jnp.minimum(st0.exit_step, step_limit))
        steps = jnp.arange(1, max_size, dtype=jnp.int32) + step_offset
        final, ys = jax.lax.scan(body, st0, steps)
        if history:
            srows, nrows = ys
            row0 = jnp.stack([st0.pos[..., 0], st0.pos[..., 1],
                              st0.m[..., 0], st0.m[..., 1],
                              st0.traveltime, st0.angle], axis=-1)
            hist = jnp.concatenate([row0[None], srows], axis=0)
            n_hist = jnp.concatenate([st0.n_eff[None], nrows], axis=0)
        else:
            hist = n_hist = None
        return TraceResult(final=final, exit_step=final.exit_step,
                           dist_real=final.dist_real, dist_sim=final.dist_sim,
                           history=hist, n_hist=n_hist)

    # jit once here so the executable cache lives as long as this lru_cache
    # entry; re-wrapping per call would recompile every trace().
    return op, run, jax.jit(run)


def trace(op_name: str, scen: config.ScenarioConfig, medium, *,
          delta_s: float, divisor: int | None = None,
          n_turns: int = config.N_TURNS, mode: str = "history",
          dtype=np.float32, pos0=None, theta0=None,
          step_limit: int | None = None, max_size: int | None = None,
          jit: bool = True) -> TraceResult:
    """Trace a batch of rays through ``medium`` with step method ``op_name``.

    Parameters mirror ``trazar(selected_func, z, grd, show, step, divisor,
    user_choice)`` (RT_bench.py:766) with the scenario/medium/op passed
    explicitly instead of via globals.  ``pos0``/``theta0`` override the
    scenario's launch fan for large custom batches; ``max_size`` +
    ``step_limit`` allow padded scans whose effective length is a traced
    value (the DELTA_S sweep batches candidates of different lengths into one
    program).
    """
    op_name = canonical(op_name)
    dtype = np.dtype(dtype)
    if mode not in ("history", "metrics"):
        raise ValueError(f"mode must be 'history' or 'metrics', got {mode!r}")
    if max_size is None:
        max_size = scen.max_size(delta_s, divisor, n_turns)
    if step_limit is None:
        step_limit = max_size - 1

    if pos0 is None:
        pos0 = scen.pos0
    if theta0 is None:
        theta0 = scen.theta0
    pos0 = jnp.asarray(pos0, dtype=dtype)
    theta0 = jnp.asarray(theta0, dtype=dtype)

    op, run, run_jit = _build_trace_fn(op_name, int(max_size), tuple(scen.box),
                                       mode, scen.is_vert, dtype.name)
    st0 = initial_state(pos0, theta0, medium, jnp.asarray(scen.gamma, dtype),
                        with_window=op.uses_window,
                        with_momentum_stats=scen.is_vert,
                        max_size=int(max_size))
    run_fn = run_jit if jit else run
    return run_fn(st0, medium,
                  jnp.asarray(scen.gamma, dtype),
                  jnp.asarray(delta_s, dtype),
                  jnp.asarray(step_limit, jnp.int32))
