"""Transmission-loss field map — the classic ocean-acoustics product.

One ``rt.find_eigenrays`` call serves an entire (range x depth) receiver
GRID: the dynamic fan is traced once and every grid cell brackets its own
multipath arrivals, so the full field costs one fan + one batched Newton,
not a trace per receiver.  The output is the TL map a sonar engineer
reads daily (Bellhop's classic pcolormesh): the SOFAR channel shows as a
low-loss duct around the sound axis, shadow zones as empty cells.

Run:  python examples/tl_field_map.py [n_ranges] [n_depths] [fan] [out.png]

``RT_TL_DEVICE=1`` runs the WHOLE pipeline on the default device (the
GPU) in f32: the crossing scans ride inside the dynamic scan
(engine/dynamic.trace_crossings_*), so only O(receivers) scalars come back
to the host per Newton iteration.  Unset, the solve runs in f64 on the
host CPU.
"""
import os
import sys

import jax
import numpy as np

ON_DEVICE = os.environ.get("RT_TL_DEVICE", "0") == "1"
DTYPE = np.float32 if ON_DEVICE else np.float64
if not ON_DEVICE:
    jax.config.update("jax_enable_x64", True)   # f64 reference solve...
    jax.config.update("jax_platforms", "cpu")    # ... on the host

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

n_ranges = int(sys.argv[1]) if len(sys.argv) > 1 else 19
n_depths = int(sys.argv[2]) if len(sys.argv) > 2 else 12
n_fan = int(sys.argv[3]) if len(sys.argv) > 3 else 256
out_png = sys.argv[4] if len(sys.argv) > 4 else None

# -- measured Munk-style profile, source on the channel axis ---------------
depth = np.linspace(-3.0, 0.0, 121)
eta = 2.0 * (depth + 1.0)
c = 1.49 * (1.0 + 0.0057 * (eta - 1.0 + np.exp(-eta)))
if ON_DEVICE:
    # split-word-evaluated profile: every n_and_grad is the correctly-
    # rounded f32 of the f64 interpolant on ANY backend — the accuracy-
    # grade medium for float32 eigenray work (engine/df_grid.DfEvalProfile)
    medium = rt.df_eval_profile_medium(c.min() / c, depth)
else:
    medium = rt.c1_stratified_from_samples(c.min() / c, depth, dtype=DTYPE)

ranges = np.linspace(4.0, 40.0, n_ranges)
depths = np.linspace(-2.5, -0.2, n_depths)
receivers = np.stack(np.meshgrid(ranges, depths, indexing="ij"),
                     -1).reshape(-1, 2)

eig = rt.find_eigenrays(
    "op6", medium, source=(0.0, -1.0), receivers=receivers, delta_s=0.01,
    max_size=int(ranges.max() / 0.01 * 1.2),
    box=(-1.0, ranges.max() + 2.0, -3.0, 0.0),
    fan=(-0.3, 0.3, n_fan), tol=2e-6 if ON_DEVICE else 1e-7,
    dtype=DTYPE, on_host=not ON_DEVICE)

itl = rt.incoherent_tl(eig, n_receivers=len(receivers))
tl_map = itl.reshape(n_ranges, n_depths)          # (range, depth)

covered = np.isfinite(tl_map)
print(f"TL field map: {n_ranges} ranges x {n_depths} depths, "
      f"{len(np.asarray(eig.theta0))} arrivals "
      f"({covered.mean() * 100:.0f} % of cells reached by the fan)")
# per-range duct check: the axis depth should be among the quietest cells
axis_j = int(np.argmin(np.abs(depths + 1.0)))
duct_wins = 0
for i in range(n_ranges):
    row = tl_map[i]
    if np.isfinite(row[axis_j]) and np.isfinite(row).sum() >= 3:
        duct_wins += row[axis_j] <= np.nanmedian(row)
print(f"channel-axis cell at or below the row median TL in "
      f"{duct_wins}/{n_ranges} ranges (duct trapping)")

assert covered.mean() > 0.3, "fan should reach a third of the grid"
assert bool(np.all(np.asarray(eig.converged))), "all arrivals converged"
assert duct_wins >= n_ranges // 2, "the SOFAR duct should show"

if out_png:
    from raytracing_tpu.viz.plots import _mpl
    _, plt = _mpl()
    fig, ax = plt.subplots(figsize=(11, 5))
    m = ax.pcolormesh(ranges, depths, tl_map.T, cmap="viridis_r",
                      shading="nearest")
    fig.colorbar(m, ax=ax, label="TL (dB re 1 km)")
    ax.plot([0.0], [-1.0], "r*", markersize=14)
    ax.set_xlabel("range (km)")
    ax.set_ylabel("depth (km)")
    ax.set_title("Incoherent transmission loss, measured SOFAR profile")
    fig.savefig(out_png, dpi=110)
    print(f"map saved to {out_png}")
print("ok")
