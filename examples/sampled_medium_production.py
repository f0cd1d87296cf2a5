"""Production tracing through the reference's sampled-spline media.

The reference's hot loop evaluates FITPACK splines of a sampled grid three
times per step (RT_bench.py:435-464, 141-156).  Here the same sampled
medium runs through table-gather kernels (1-D stratified tables) or the
scan tier (2-D grids), with the physics oracle computed from the same
outputs:

    python examples/sampled_medium_production.py [rays]

Shows: 1-D stratified tables (interface) at kernel speed with the Snell
oracle, the kernel-tier DELTA_S sweep on the sampled medium, the exact
2-D fisheye spline on the scan tier, and the DELTA_S search on that 2-D
spline.
"""
import sys
import time

import numpy as np

import raytracing_tpu as rt
from raytracing_tpu import config, models
from raytracing_tpu.engine.fast import fast_trace
from raytracing_tpu.parallel.sweep import delta_s_search

rays = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 20

# 1. interface on the sampled 1-D tables at the calibrated HySA step
model = models.get("interface", medium="stratified")
scen = model.scenario
theta0 = np.resize(np.asarray(scen.theta0, np.float32), rays)
pos0 = np.tile(scen.pos0[:1].astype(np.float32), (rays, 1))
out = model.run("HySA", pos0=pos0, theta0=theta0)   # compile
np.asarray(out.pos[:1])
t0 = time.perf_counter()
out = model.run("HySA", pos0=pos0, theta0=theta0)
np.asarray(out.pos[:1])
dt = time.perf_counter() - t0
ds, _ = model.delta_s("HySA")
steps = scen.max_size(ds) - 1
print(f"interface sampled medium [{out.engine}]: "
      f"{rays * steps / dt / 1e9:.2f} G ray-steps/s")

# 2. kernel-tier DELTA_S search on the sampled medium (the reference's
#    executor.map sweep, RT_bench.py:1296-1406, at kernel speed)
t0 = time.perf_counter()
sr = delta_s_search("op8", scen, model.medium, engine="auto")
dt = time.perf_counter() - t0
print(f"DELTA_S search (op8, sampled interface): divisor SIGMA/"
      f"{sr.divisor}, {len(sr.divisors)} candidates in {dt:.0f}s")

# 3. the exact 2-D fisheye spline (its Hermite node form) on the scan tier
from raytracing_tpu.media.hermite import build_hermite_medium
from raytracing_tpu.media.spline import build_grid_medium

fscen = rt.scenario("fisheye")
hm = build_hermite_medium(build_grid_medium("fisheye", fscen.box,
                                            dtype=np.float32))
r2 = min(rays, 65536)
p0 = np.tile(np.array([[1.0, 0.0]], np.float32), (r2, 1))
th = np.full(r2, np.pi / 2, np.float32)
div = 1200
g = fast_trace("op6", fscen, hm, delta_s=2 * np.pi / div, steps=div,
               pos0=p0, theta0=th)
clo = 100 * np.linalg.norm(np.asarray(g.pos)[0] - [1, 0]) / (2 * np.pi)
print(f"fisheye 2-D spline [{g.engine}]: closure {clo:.4f} % after one turn")

# 4. DELTA_S search ON the 2-D spline — the medium the reference
#    actually calibrates (scan-engine sweep)
t0 = time.perf_counter()
sr = delta_s_search("op1", fscen, hm, engine="auto")
dt = time.perf_counter() - t0
print(f"DELTA_S search (op1, 2-D fisheye spline): divisor {sr.divisor}, "
      f"{len(sr.divisors)} candidates in {dt:.0f}s")
