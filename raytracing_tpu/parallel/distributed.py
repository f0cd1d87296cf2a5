"""Data-parallel tracing: the ray batch sharded across a device mesh.

The reference scales by submitting whole-scenario replicas to worker
processes (RT_bench.py:1521-1523); the equivalent here is one batch,
sharded.  ``trace_sharded`` lays the launch arrays out over every device of
the mesh (both logical axes — a (2, 4) host mesh gives 8-way ray
parallelism), runs the ordinary jitted scan, and lets XLA keep every
per-ray computation local; ``summarize_sharded`` reduces the scenario
metrics on device (an all-reduce) so only scalars reach the host.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from raytracing_tpu import config
from raytracing_tpu.engine.trace import TraceResult, trace


def ray_batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a (R, ...) batch over every device of the mesh."""
    return NamedSharding(mesh, P(mesh.axis_names))


def trace_sharded(op_name: str, scen: config.ScenarioConfig, medium, *,
                  delta_s: float, mesh: Mesh, pos0, theta0,
                  divisor: int | None = None,
                  n_turns: int = config.N_TURNS, mode: str = "metrics",
                  dtype=np.float32) -> TraceResult:
    """Trace a ray batch sharded across ``mesh``.

    ``pos0``/``theta0`` lengths must divide evenly by the device count.
    Results come back with the same sharding; use :func:`summarize_sharded`
    to reduce metrics without gathering the batch.
    """
    n_dev = mesh.devices.size
    r = len(theta0)
    if r % n_dev:
        raise ValueError(f"ray count {r} not divisible by {n_dev} devices")
    sh = ray_batch_sharding(mesh)
    pos0 = jax.device_put(jnp.asarray(pos0, dtype), sh)
    theta0 = jax.device_put(jnp.asarray(theta0, dtype), sh)
    return trace(op_name, scen, medium, delta_s=delta_s, divisor=divisor,
                 n_turns=n_turns, mode=mode, dtype=dtype,
                 pos0=pos0, theta0=theta0)


class ShardedSummary(NamedTuple):
    mean_closure_pct: Any
    total_distance: Any
    rays: int


@jax.jit
def summarize_sharded(result: TraceResult) -> ShardedSummary:
    """Device-side reduction of batch metrics (no host gather of the batch)."""
    pos = result.final.pos
    target = jnp.array([1.0, 0.0], dtype=pos.dtype)
    closure = 100.0 * jnp.linalg.norm(pos - target, axis=-1) / (2.0 * np.pi)
    return ShardedSummary(mean_closure_pct=jnp.mean(closure),
                          total_distance=jnp.sum(result.dist_sim),
                          rays=pos.shape[0])
