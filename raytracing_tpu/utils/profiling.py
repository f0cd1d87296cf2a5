"""Tracing / profiling utilities (SURVEY.md 5.1).

The reference's observability is ``perf_counter`` brackets around each ray
loop (RT_bench.py:831, 881-882).  The equivalents here: throughput counters
derived from scan length x ray count, and ``jax.profiler`` device traces
viewable in TensorBoard/XProf.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator, NamedTuple

import numpy as np


class StepRate(NamedTuple):
    seconds: float
    ray_steps: int
    rate: float  # ray-steps/sec


@contextlib.contextmanager
def step_timer(ray_steps: int, sink: list | None = None) -> Iterator[None]:
    """Time a block that performs ``ray_steps`` ray-steps; append a
    :class:`StepRate` to ``sink`` (or print)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    r = StepRate(seconds=dt, ray_steps=ray_steps, rate=ray_steps / dt)
    if sink is not None:
        sink.append(r)
    else:
        print(f"{r.ray_steps} ray-steps in {r.seconds:.4f}s "
              f"-> {r.rate:.3e} ray-steps/s")


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """jax.profiler trace of the enclosed block (open with XProf)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
