"""Real measured data end-to-end: parity pipeline vs the C1 medium.

The reference can only trace the four fields hard-coded in its source
(RT_bench.py:104-116).  Here the input is what a lab actually has — a grid
of measured refractive-index samples — and the same array feeds two medium
families:

* ``rt.grid_medium_from_samples``  — the reference's exact pipeline
  (bilinear n + independently fitted bicubic gradients); use when parity
  with the published method matters.
* ``rt.c1_medium_from_samples``    — ONE spline serving n AND grad n
  (media/c1.py): conservation holds at the medium level, trajectories
  track the underlying field to O(h^4), and each evaluation gathers 16
  floats/cell instead of 36.

The script "measures" a lens-like index field on a coarse grid, traces the
same fan through both media (on the scan tier, where 2-D grid media run),
and scores each against the smooth truth: trajectory deviation and the
momentum behavior that separates consistent from inconsistent media.

Run:  python examples/measured_medium.py [rays] [steps]
"""
import sys
import time

import jax
import numpy as np

jax.config.update("jax_enable_x64", True)   # the truth trace below is f64

import raytracing_tpu as rt
from raytracing_tpu.engine.fast import fast_trace

rays = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 16
steps = int(sys.argv[2]) if len(sys.argv) > 2 else 600
block = 128   # padding granularity of the launch batch

# -- the "measurement": index samples of an unknown lens on a lab grid ----
def true_field(x, y):
    return 1.0 / (1.0 + 0.4 * x * x + 0.6 * y * y)


gx = np.linspace(-2.0, 2.0, 161)
gy = np.linspace(-1.5, 1.5, 121)
Z = true_field(gx[None, :], gy[:, None])          # what the lab delivers

parity = rt.grid_medium_from_samples(Z, gx, gy, dtype=np.float32)
c1 = rt.c1_medium_from_samples(Z, gx, gy, dtype=np.float32)

# -- one fan, both media, scan tier ---------------------------------------
import dataclasses

box = (-1.8, 1.8, -1.3, 1.3)
# a real ScenarioConfig (the engines read box/gamma/is_* off it); the
# launch fan below overrides pos0/theta0 per call
_Scen = dataclasses.replace(rt.scenario("fisheye"), name="measured",
                            gamma=1.0, box=box)


pos0 = np.stack([np.full(rays, -1.5, np.float32),
                 np.linspace(-0.6, 0.6, rays).astype(np.float32)], -1)
theta0 = np.zeros(rays, np.float32)
ds = np.float32(0.005)

for tag, med in (("parity", parity), ("c1", c1)):
    out = fast_trace("op6", _Scen, med, delta_s=ds, pos0=pos0,
                     theta0=theta0, steps=steps, block_rays=block)
    np.asarray(out.pos[:1])
    t0 = time.perf_counter()
    out = fast_trace("op6", _Scen, med, delta_s=ds, pos0=pos0,
                     theta0=theta0, steps=steps, block_rays=block)
    np.asarray(out.pos[:1])
    dt = time.perf_counter() - t0
    print(f"{tag:7s} [{out.engine}]: {rays * steps / dt / 1e9:.2f} G "
          f"ray-steps/s, final x mean {float(np.asarray(out.pos)[:, 0].mean()):+.4f}")

# -- accuracy vs the smooth truth: f64 scan on an analytic CustomMedium ---
from raytracing_tpu.media.medium import CustomMedium

truth = CustomMedium(n_fn=lambda x, y: 1.0 / (1.0 + 0.4 * x * x
                                              + 0.6 * y * y))
# strided subset — the first-k rays of a linspace fan would all sample
# one edge of the launch span
sel = slice(None, None, max(1, rays // 512))
spos, sth = pos0[sel], theta0[sel]
sub = len(spos)
ref = rt.trace("op6", _Scen, truth, delta_s=float(ds), mode="metrics",
               dtype=np.float64, max_size=steps + 1,
               pos0=spos.astype(np.float64),
               theta0=sth.astype(np.float64))
ref_pos = np.asarray(ref.final.pos)
for tag, med in (("parity", parity), ("c1", c1)):
    out = fast_trace("op6", _Scen, med, delta_s=ds, pos0=spos,
                     theta0=sth, steps=steps,
                     block_rays=128)
    dev = float(np.linalg.norm(np.asarray(out.pos) - ref_pos, axis=1).max())
    print(f"{tag:7s} max trajectory deviation from the true field: {dev:.2e}")

print("c1 advantage: consistent grad (conservation-grade) and the same "
      "samples track the smooth truth closer — see docs/PARITY.md #29")

# -- f64-substitute: double-word f32 on the same measured samples ---------
# (engine/df_grid.py; compare against an f64 RK4 of the smooth truth so
# both sides carry the same integrator error)
dfm = rt.df_c1_medium_from_samples(Z, gx, gy)
p = rt.df_grid_trace(spos, sth, ds, dfm, steps=steps)
tru = rt.trace("op12", _Scen, truth, delta_s=float(ds), mode="metrics",
               dtype=np.float64, max_size=steps + 1,
               pos0=spos.astype(np.float64),
               theta0=sth.astype(np.float64))
dev = float(np.abs(p - np.asarray(tru.final.pos)).max())
print(f"df32+c1 deviation from an f64 trace of the true field: {dev:.2e} "
      "(pure-f32 arithmetic, medium-limited)")
