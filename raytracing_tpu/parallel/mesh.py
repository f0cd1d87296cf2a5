"""Device-mesh helpers: the accelerator replacement for ProcessPoolExecutor.

The reference's only parallelism is OS-process fan-out with pickled spline
objects (RT_bench.py:1317-1318, 1521-1523).  Here the equivalents are a
``jax.sharding.Mesh`` with two logical axes:

* ``"sweep"`` — DELTA_S candidates (the executor.map axis, RT_bench.py:1318)
* ``"rays"``  — the ray batch (data parallelism; the reference's benchmark
  replicas, RT_bench.py:1521-1523, become one big sharded batch)

Everything is single-program: XLA inserts the collectives for the metric
reductions; no host orchestration, no pickling (SURVEY.md §5.8).  The
devices of one host are joined all to all, so the mesh follows the
algorithm alone.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SWEEP_AXIS = "sweep"
RAYS_AXIS = "rays"


def make_mesh(n_devices: int | None = None, sweep: int | None = None) -> Mesh:
    """Build a (sweep, rays) mesh over the first ``n_devices`` devices.

    ``sweep`` fixes the sweep-axis extent; by default the largest divisor of
    the device count not exceeding its square root, so both axes get devices
    (an 8-device host mesh becomes 2 x 4).
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if sweep is None:
        sweep = max(d for d in range(1, int(np.sqrt(n)) + 1) if n % d == 0)
    if n % sweep:
        raise ValueError(f"sweep={sweep} does not divide device count {n}")
    arr = np.asarray(devs).reshape(sweep, n // sweep)
    return Mesh(arr, (SWEEP_AXIS, RAYS_AXIS))


def sweep_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for per-candidate arrays: leading axis over the sweep axis."""
    return NamedSharding(mesh, P(SWEEP_AXIS))


def candidate_ray_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (candidate, ray, ...) arrays over both mesh axes."""
    return NamedSharding(mesh, P(SWEEP_AXIS, RAYS_AXIS))


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (ray, ...) batches over the rays axis (replicated on sweep)."""
    return NamedSharding(mesh, P(RAYS_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
