"""Self-calibrate DELTA_S on the ANALYTIC media.

The reference's calibrated divisors were measured on its SIGMA/3 sampled
grid (RT_bench.py:1413 comment — "valores medidos sobre la grilla"); the
repo's `calibrated.py` keeps them for the sampled (parity) media.  Reused
on the *analytic* fields they are off-provenance: the analytic interface
sigmoid is sharper than its sampled fit at the same step, and the Snell
oracle fails (mean 0.444 deg > 0.2).

This driver runs the existing kernel-tier DELTA_S search — the same
candidate grids and acceptance policies as the reference
(RT_bench.py:1296-1406) — per (op, scenario) ON the analytic fields, and
emits the ANALYTIC_* divisor tables for `raytracing_tpu/calibrated.py`
plus a JSON artifact.  Run on the GPU (the fused sweep runs on the
Triton kernels there); each (op, scenario) is one compiled kernel +
~300-2000 launches.

    python benchmarks/calibrate_analytic.py [--scenarios interface,vert,...]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import raytracing_tpu as rt
from raytracing_tpu.media.medium import analytic_medium
from raytracing_tpu.parallel.sweep import delta_s_search

PLAN = {
    "interface": [f"op{i}" for i in range(1, 10)],
    "vert": [f"op{i}" for i in range(1, 10)],
    "fisheye": [f"op{i}" for i in range(1, 10)],
    "aniso": ["op10", "op11"],
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", default="interface,vert,fisheye,aniso")
    ap.add_argument("--out", default="ANALYTIC_CALIBRATED.json")
    args = ap.parse_args(argv)

    tables: dict[str, dict[str, float]] = {}
    metrics: dict[str, dict] = {}
    for scen_name in args.scenarios.split(","):
        scen = rt.scenario(scen_name)
        med = analytic_medium(scen.field)
        tables[scen_name] = {}
        metrics[scen_name] = {}
        for op in PLAN[scen_name]:
            # The ANALYTIC interface sigmoid is sharper than the
            # reference's SIGMA/3 sampled fit: the 0.2-deg Snell bar is
            # unreachable inside the reference's divisor grid (3.0 -> 1.0,
            # RT_bench.py:1302; every candidate floors at ~0.25 deg,
            # f64-verified) — extend the grid upward so the acceptance
            # crossing exists.  The first-order family needs a far finer
            # range still (the reference's own sampled calibration put
            # op1/op2/op7 at divisors 30-39, RT_bench.py:1413-1430).
            divisors = None
            if scen_name == "interface":
                divisors = (np.arange(80.0, 8.0, -0.05)
                            if op in ("op1", "op2", "op7")
                            else np.arange(8.0, 1.0, -0.01))
            t0 = time.time()
            res = delta_s_search(op, scen, med, engine="fused",
                                 divisors=divisors)
            dt = time.time() - t0
            tables[scen_name][op] = res.divisor
            metrics[scen_name][op] = {
                k: np.asarray(v).tolist() for k, v in res.metrics.items()}
            print(f"{scen_name:10s} {op:5s} divisor={res.divisor} "
                  f"delta_s={res.delta_s_selected} ({dt:.1f}s)",
                  file=sys.stderr)

    with open(args.out, "w") as f:
        json.dump({"divisors": tables, "metrics": metrics}, f, indent=1)
    print(f"# -> {args.out}", file=sys.stderr)

    # paste-ready tables for raytracing_tpu/calibrated.py
    for scen_name, tbl in tables.items():
        name = f"ANALYTIC_{scen_name.upper()}_DIVISOR"
        rows = ", ".join(f'"{k}": {v}' for k, v in tbl.items())
        print(f"{name} = {{{rows}}}")


if __name__ == "__main__":
    main()
