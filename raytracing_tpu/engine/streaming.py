"""Chunk-streamed trajectory history (SURVEY.md 5.7).

Full histories scale as rays x steps x 7 floats — at a million rays and
thousands of steps that exceeds HBM.  The reference never hits this (it
plots at most 43 rays); this framework streams instead: the integrator runs
in fixed-size scan segments, the carry rides on device between segments, and
each segment's history rows land on host before the next segment runs.
Peak device memory is O(rays x chunk).
"""
from __future__ import annotations

from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu import config
from raytracing_tpu.engine.trace import _build_trace_fn, _outside, initial_state
from raytracing_tpu.ops.registry import canonical


def stream_history(op_name: str, scen: config.ScenarioConfig, medium, *,
                   delta_s: float, divisor: int | None = None,
                   n_turns: int = config.N_TURNS, chunk: int = 512,
                   dtype=np.float32, pos0=None, theta0=None
                   ) -> Iterator[np.ndarray]:
    """Yield history chunks of shape (<=chunk, R, 6) on host.

    Concatenating all chunks equals ``trace(..., mode="history")``'s
    history array (row 0 included once, at the start of the first chunk).
    """
    op_name = canonical(op_name)
    dtype = np.dtype(dtype)
    max_size = scen.max_size(delta_s, divisor, n_turns)
    if pos0 is None:
        pos0 = scen.pos0
    if theta0 is None:
        theta0 = scen.theta0
    pos0 = jnp.asarray(pos0, dtype=dtype)
    theta0 = jnp.asarray(theta0, dtype=dtype)

    op, _, run_jit = _build_trace_fn(op_name, chunk + 1, tuple(scen.box),
                                     "history", scen.is_vert, dtype.name)
    gamma = jnp.asarray(scen.gamma, dtype)
    ds = jnp.asarray(delta_s, dtype)
    st = initial_state(pos0, theta0, medium, gamma,
                       with_window=op.uses_window,
                       with_momentum_stats=scen.is_vert,
                       max_size=max_size)
    # the chunked runs manage exit_step/limits globally
    st = st._replace(exit_step=jnp.full_like(st.exit_step, max_size - 1))

    done = 0  # steps completed
    total_steps = max_size - 1
    first = True
    while done < total_steps:
        seg = min(chunk, total_steps - done)
        # step_offset globalizes the scan indices: op7's order ramp (which
        # keys off the step number, ops/registry.py) sees step done+1 .. and
        # never re-primes, and exit_step records global indices.  step_limit
        # is global too, so the segment freezes after `seg` applied steps.
        res = run_jit(st, medium, gamma, ds, jnp.int32(done + seg),
                      jnp.int32(done))
        hist = np.asarray(res.history)  # (chunk+1, R, 6)
        if first:
            yield hist[: seg + 1]
            first = False
        else:
            yield hist[1: seg + 1]
        st = res.final
        # The segment's step limit deactivated every surviving ray; rays
        # that actually left the box have a strictly out-of-box frozen
        # position, so "inside the box" re-arms exactly the survivors.
        st = st._replace(
            active=~_outside(st.pos, scen.box),
            exit_step=jnp.full_like(st.exit_step, max_size - 1))
        done += seg


def trace_chunked(op_name: str, scen: config.ScenarioConfig, medium, *,
                  delta_s: float, divisor: int | None = None,
                  n_turns: int = config.N_TURNS, chunk: int = 128,
                  dtype=np.float32, pos0=None, theta0=None,
                  max_size: int | None = None):
    """Metrics-mode trace through bounded-length scan segments.

    XLA compile time for scan bodies with large-table gathers (the 2-D
    ``GridMedium``) grows with the scan length.  This chains ``chunk``-step scans with the full
    ``RayState`` riding on device and global step indices via the scan's
    ``step_offset``; ONE bounded compile serves any trajectory length, and
    the result matches ``trace(..., mode="metrics")`` including per-ray
    ``exit_step``.  This is the bounded-compile execution path for the
    reference's 2-D sampled-spline medium (RT_bench.py:435-464).
    """
    op_name = canonical(op_name)
    dtype = np.dtype(dtype)
    if max_size is None:
        max_size = scen.max_size(delta_s, divisor, n_turns)
    if pos0 is None:
        pos0 = scen.pos0
    if theta0 is None:
        theta0 = scen.theta0
    pos0 = jnp.asarray(pos0, dtype=dtype)
    theta0 = jnp.asarray(theta0, dtype=dtype)

    op, _, run_jit = _build_trace_fn(op_name, chunk + 1, tuple(scen.box),
                                     "metrics", scen.is_vert, dtype.name)
    gamma = jnp.asarray(scen.gamma, dtype)
    ds = jnp.asarray(delta_s, dtype)
    st = initial_state(pos0, theta0, medium, gamma,
                       with_window=op.uses_window,
                       with_momentum_stats=scen.is_vert,
                       max_size=max_size)
    total_steps = max_size - 1
    st = st._replace(exit_step=jnp.full_like(st.exit_step, total_steps))

    done = 0
    res = None
    while done < total_steps:
        seg = min(chunk, total_steps - done)
        res = run_jit(st, medium, gamma, ds, jnp.int32(done + seg),
                      jnp.int32(done))
        st = res.final
        done += seg
        if done < total_steps:
            # re-arm survivors; keep true exits' recorded step, reset the
            # limit-clamped exit_step of still-inside rays
            out = _outside(st.pos, scen.box)
            st = st._replace(
                active=~out,
                exit_step=jnp.where(out, st.exit_step, total_steps))
    return res
