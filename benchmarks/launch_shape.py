#!/usr/bin/env python
"""Sweep the Triton launch shape (rays per program x warps) on the GPU.

    python benchmarks/launch_shape.py

Times three kernels at 2^20 rays — the fisheye op1 headline, fused op6 on
the analytic interface, golden op11 — for each (rays per program, warps)
pair, warm calls ending in block_until_ready, and prints one line each.
kernels/launch.py keeps the winner as RAYS_PER_PROGRAM / NUM_WARPS.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from raytracing_tpu.kernels import launch  # noqa: E402
from raytracing_tpu.kernels.fisheye import fisheye_trace_final  # noqa: E402
from raytracing_tpu.kernels.fused import fused_trace_final  # noqa: E402
from raytracing_tpu.kernels.golden import golden_trace_final  # noqa: E402

RAYS = 1 << 20
SHAPES = ((64, 2), (128, 4), (128, 2), (256, 8), (256, 4), (512, 8),
          (512, 4), (1024, 8))


def main():
    i = np.arange(RAYS) / RAYS
    pos = np.stack([0.8 + 0.2 * i, np.zeros(RAYS)], -1).astype(np.float32)
    th = (np.pi / 2 + 0.2 * (i - 0.5)).astype(np.float32)
    ipos = np.tile([[-2.0, -2.0]], (RAYS, 1)).astype(np.float32)
    ith = (0.1 + 1.4 * i).astype(np.float32)
    box_if = (-2.0, 20.0, -2.0, 4.0)
    box_v = (-2.0, 5.0, -2.5, 1.0)
    work = {
        "fisheye-op1": (4587, lambda: fisheye_trace_final(
            pos, th, np.float32(2 * np.pi / 4587), steps=4587)[0]),
        "fused-op6-interface": (1500, lambda: fused_trace_final(
            ipos, ith, np.float32(0.02), field="interface", op="op6",
            steps=1500, box=box_if).pos),
        "golden-op11": (1000, lambda: golden_trace_final(
            ipos, ith, np.float32(0.02), np.float32(3.0),
            field="vert_heterogeneous", op="op11", steps=1000,
            box=box_v).pos),
    }
    print(f"device {jax.devices()[0].device_kind}", flush=True)
    for rpp, warps in SHAPES:
        launch.RAYS_PER_PROGRAM, launch.NUM_WARPS = rpp, warps
        jax.clear_caches()
        for name, (steps, fn) in work.items():
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            first = time.perf_counter() - t0
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                jax.block_until_ready(fn())
                ts.append(time.perf_counter() - t0)
            warm = float(np.median(ts))
            print(f"[shape] rays/program {rpp} warps {warps} {name}: warm "
                  f"{warm:.6f}s  {RAYS * steps / warm:.6e} ray-steps/s  "
                  f"(compile+first {first:.3f}s)", flush=True)


if __name__ == "__main__":
    main()
