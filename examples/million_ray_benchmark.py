"""A million rays through the Maxwell fisheye via the fused-kernel tier.

Run on a GPU host:  python examples/million_ray_benchmark.py
"""
import time

import numpy as np
import jax

import raytracing_tpu as rt
from raytracing_tpu.engine.fast import fast_trace

R = 1 << 20
DIV = 4587                          # op1's calibrated divisor (RT_bench.py:1433)

scen = rt.scenario("fisheye")
med = rt.analytic_medium("fisheye")
pos0 = jax.device_put(np.stack([np.ones(R), np.zeros(R)], -1).astype(np.float32))
theta0 = jax.device_put(np.full(R, np.pi / 2, np.float32))

out = fast_trace("HySA", scen, med, delta_s=2 * np.pi / DIV, steps=DIV,
                 pos0=pos0, theta0=theta0)
np.asarray(out.pos[:1])             # compile + completion barrier
t0 = time.perf_counter()
out = fast_trace("HySA", scen, med, delta_s=2 * np.pi / DIV, steps=DIV,
                 pos0=pos0, theta0=theta0)
np.asarray(out.pos[:1])
dt = time.perf_counter() - t0

closure = 100 * np.linalg.norm(np.asarray(out.pos[0]) - [1, 0]) / (2 * np.pi)
print(f"{R} rays x {DIV} steps in {dt:.3f}s "
      f"({R * DIV / dt / 1e9:.1f} G ray-steps/s, engine={out.engine})")
print(f"closure error: {closure:.2e} % of the unit circumference")
