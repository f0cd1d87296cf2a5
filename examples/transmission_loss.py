"""Transmission loss vs range in a SOFAR channel — the sonar product.

The reference stops at ray geometry (RT_bench.py:964-1197 plots
trajectories and wavefronts); an acoustician's deliverable is the FIELD: at
each hydrophone, which ray paths arrive, when, how strong, and what the
coherent interference does to the received level.  This example produces
exactly that from a measured sound-speed profile:

1. measured c(z) samples -> consistent-gradient C1 medium
   (``rt.c1_stratified_from_samples``),
2. ``rt.find_eigenrays`` — ONE dynamic fan trace shared by every receiver,
   then a batched paraxial-Newton polish (slope = q / cos angle, exact from
   the jvp tangent) for every arrival at every range,
3. per-arrival travel time / amplitude / KMAH caustic phase ->
   ``rt.incoherent_tl`` and ``rt.coherent_tl`` per receiver.

Run:  python examples/transmission_loss.py [n_ranges] [n_fan]
"""
import sys

import jax
import numpy as np

# eigenray work is f64 end to end (see the dtype note below); the medium
# TABLES must be built under x64 too or the f64 request silently downcasts
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")   # f64 host-side solve

import raytracing_tpu as rt  # noqa: E402

n_ranges = int(sys.argv[1]) if len(sys.argv) > 1 else 8
n_fan = int(sys.argv[2]) if len(sys.argv) > 2 else 192

# -- measured Munk-style profile (same lab data shape as ocean_waveguide) --
depth = np.linspace(-3.0, 0.0, 121)                       # km, 0 = surface
eta = 2.0 * (depth + 1.0)                                 # axis at -1 km
c = 1.49 * (1.0 + 0.0057 * (eta - 1.0 + np.exp(-eta)))    # km/s
n_samples = c.min() / c
# f64 tables: the eigenray Newton converges to the landing curve's noise
# floor, and f32 coefficient tables put that floor at ~1e-5 km (10 m of
# receiver miss); production kernel tracing keeps the f32 default
medium = rt.c1_stratified_from_samples(n_samples, depth, dtype=np.float64)

# -- source on the channel axis; receiver line at axis depth ---------------
source = (0.0, -1.0)
ranges = np.linspace(5.0, 40.0, n_ranges)                 # km
receivers = np.stack([ranges, np.full(n_ranges, -1.0)], -1)

ds = 0.01                                                 # 10 m arc steps
max_size = int(ranges.max() / ds * 1.2)
eig = rt.find_eigenrays(
    "op6", medium, source=source, receivers=receivers, delta_s=ds,
    max_size=max_size, box=(-1.0, ranges.max() + 2.0, -3.0, 0.0),
    fan=(-0.21, 0.21, n_fan), tol=1e-9)

freq_hz = 50.0
# traveltime is in seconds once multiplied by 1/c0 (n is normalized
# slowness c_min/c, so optical path / c_min = time); fold c_min in here
omega = 2.0 * np.pi * freq_hz / float(c.min())
itl = rt.incoherent_tl(eig, n_receivers=n_ranges)
ctl = rt.coherent_tl(eig, omega, n_receivers=n_ranges)

print(f"SOFAR transmission loss, source on axis, f = {freq_hz:g} Hz")
print(f"{'range km':>9} {'paths':>6} {'first tau s':>12} {'spread ms':>10} "
      f"{'TL incoh dB':>12} {'TL coh dB':>10} {'max kmah':>9}")
for i, r in enumerate(ranges):
    e = eig.for_receiver(i)
    tau = np.asarray(e.traveltime) / float(c.min())
    spread = 1e3 * (tau.max() - tau.min()) if len(tau) else np.nan
    first = tau.min() if len(tau) else np.nan
    km = int(np.asarray(e.kmah).max()) if len(tau) else -1
    print(f"{r:9.1f} {len(tau):6d} {first:12.4f} {spread:10.2f} "
          f"{itl[i]:12.2f} {ctl[i]:10.2f} {km:9d}")

n_arrivals = len(np.asarray(eig.theta0))
assert n_arrivals >= n_ranges, "every range should collect arrivals"
assert bool(np.all(np.asarray(eig.converged))), "all arrivals converged"
assert np.all(np.isfinite(itl)), "incoherent TL finite at every range"
# channel trapping: TL grows far SLOWER than the 10 log10 r of free
# cylindrical spreading — that is what the waveguide is for
free = 10 * np.log10(ranges / ranges[0])
trapped = itl - itl[0]
assert trapped[-1] < free[-1], (trapped[-1], free[-1])
print(f"arrivals: {n_arrivals}; TL growth over {ranges[0]:g}->{ranges[-1]:g} km: "
      f"{trapped[-1]:.2f} dB (free cylindrical would be {free[-1]:.2f} dB)")
print("ok")
