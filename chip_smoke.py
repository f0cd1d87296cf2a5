#!/usr/bin/env python
"""Smoke run of the ray tracer on one GPU, through the user entry points.

    python chip_smoke.py            # one GPU: phases 1-8
    python chip_smoke.py --four     # four GPUs: the sharded phase only

Phases (2^20 rays unless noted; every phase prints its own lines and any
failure raises, so the script exits non-zero):

1. device: a GPU, its kind, count, the JAX version, name and power limit;
2. headline: bench.py's fisheye op1 runner at divisor 4587;
3. main-path families through fast_trace, the CLI ``--rays`` path and
   bench.run_oracles' reference thresholds;
4. parity of every kernel entry with the float64 scan tier on a stride of
   4096 rays of the full batch (raytracing_tpu/bench/parity.py);
5. each kernel's warm time beside the plain-XLA scan tier's at the same
   op, medium, rays and steps;
6. 2-D and 3-D grid media on the scan tier;
7. fast_dynamic, fast_trace3 and fast_dynamic3 at 2^18 rays;
8. the HTTP server, in a thread of this process;
9. (``--four``) ray-sharded tracing and a sharded DELTA_S search on a
   4-GPU mesh against one GPU.

The last line is ``{"ok": true, "device": {...}}``.  With no GPU the
script exits non-zero before printing it.
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

RAYS = 1 << 20
#: phase 6 bounds: 4x the CPU float32-vs-float64 scan deviation, same rays
GRID_BOUND_SPLINE = 4.6e-4
GRID_BOUND_C1 = 7.2e-4


def log(*a):
    print(*a, flush=True)


def timed(fn, reps: int = 3):
    """(result, compile+first-call seconds, median warm seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, first, float(np.median(ts))


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def phase_device(expect: int):
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX runs on {devs[0].platform!r}")
    check(len(devs) >= expect, f"need {expect} GPUs, have {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(f"[device] {devs[0].device_kind} x{len(devs)}  jax {jax.__version__}")
    log(f"[device] nvidia-smi: {smi}")
    return smi


def phase_headline():
    import bench
    from raytracing_tpu.kernels.fisheye import make_fisheye_runner

    divisor, steps = 4587, 4587
    runner = make_fisheye_runner(RAYS, divisor, 1)
    pos, first, warm = timed(runner)
    pos = np.asarray(pos)
    closure = 100.0 * np.linalg.norm(pos[0] - [1.0, 0.0]) / (2 * np.pi)
    check(np.isfinite(pos).all() and pos.shape == (RAYS, 2), "headline output")
    check(closure < 5.0, f"headline closure {closure}")
    log(f"[headline] fisheye op1 {RAYS} rays x {steps} steps: compile+first "
        f"{first:.3f}s warm {warm:.6f}s  {RAYS * steps / warm:.6e} "
        f"ray-steps/s  closure {closure:.6e} %  device {bench.device_info()}")


def _fan(scen, rays):
    theta0 = np.linspace(scen.theta0[0], scen.theta0[-1], rays)
    pos0 = np.tile(scen.pos0[:1], (rays, 1))
    return pos0.astype(np.float32), theta0.astype(np.float32)


def phase_main_path():
    import raytracing_tpu as rt
    from bench import run_oracles
    from raytracing_tpu import cli, config
    from raytracing_tpu.bench import parity
    from raytracing_tpu.calibrated import calibrated
    from raytracing_tpu.engine import oracles
    from raytracing_tpu.engine.fast import fast_trace
    from raytracing_tpu.media.spline import build_stratified_medium

    def row(name, op, scen, medium, pos0, theta0, **kw):
        out, first, warm = timed(lambda: fast_trace(
            op, scen, medium, pos0=pos0, theta0=theta0, **kw))
        check(out.engine != "scan", f"{name}: routed to the scan tier")
        pos = np.asarray(out.pos)
        check(np.isfinite(pos).all(), f"{name}: non-finite positions")
        steps = kw.get("steps") or scen.max_size(
            float(kw["delta_s"]), kw.get("divisor"),
            kw.get("n_turns", 1)) - 1
        log(f"[main] {name}: engine {out.engine}  compile+first {first:.3f}s "
            f"warm {warm:.6f}s  {len(theta0) * steps / warm:.6e} ray-steps/s")
        return out, pos

    fish = rt.scenario("fisheye")
    p1 = np.tile(np.array([[1.0, 0.0]], np.float32), (RAYS, 1))
    t1 = np.full(RAYS, np.pi / 2, np.float32)
    _, pos = row("fisheye op6", "op6", fish, rt.analytic_medium("fisheye"),
                 p1, t1, delta_s=2 * np.pi / 303, steps=303 * 10)
    clo = 100 * np.linalg.norm(pos[0] - [1.0, 0.0]) / (2 * np.pi)
    log(f"[main]   fisheye N=10 closure {clo:.6e} % (threshold 5 %)")
    check(clo < 5.0, "fisheye closure")

    scen = rt.scenario("interface")
    p, t = _fan(scen, RAYS)
    med = build_stratified_medium("interface", scen.box, dtype=np.float32)
    out, _ = row("interface op6 sampled", "op6", scen, med, p, t,
                 delta_s=config.SIGMA / 2.55)
    check(out.engine == "fused-strat-seg-skip", out.engine)

    scen = rt.scenario("vert")
    p, t = _fan(scen, RAYS)
    med = build_stratified_medium("vert_heterogeneous", scen.box,
                                  dtype=np.float32)
    out, _ = row("vert op8 stats", "op8", scen, med, p, t,
                 delta_s=config.SIGMA / 2.74, stats=True)
    cv = oracles.momentum_cv_pct_from_welford(
        np.asarray(out.mom_count), np.asarray(out.mom_mean),
        np.asarray(out.mom_m2))
    cv = float(np.mean(cv[1:-1]))
    log(f"[main]   vert momentum CV {cv:.6e} % (threshold 0.05 %)")
    check(cv < 0.05, "vert momentum CV")

    scen = rt.scenario("aniso")
    p, t = _fan(scen, RAYS)
    gds, _ = calibrated("op11", "aniso")
    out, _ = row("aniso op11", "op11", scen,
                 rt.analytic_medium("vert_heterogeneous"), p, t,
                 delta_s=float(gds), steps=2000)
    check(out.engine == "golden", out.engine)

    case = parity.cases()["fused-custom"]
    p, t = case.fan(RAYS)
    out, _ = row("custom medium op6", "op6", fish,
                 parity._media("custom"), p, t, delta_s=2 * np.pi / 303,
                 steps=606)
    sub = slice(None, None, parity.STRIDE)
    dev = parity.deviation(case, np.asarray(out.pos)[sub], p[sub], t[sub])
    log(f"[main]   custom medium deviation {dev:.6e} "
        f"(bound {parity.BOUND['fused-custom']:.1e})")
    check(dev <= parity.BOUND["fused-custom"], "custom medium deviation")

    out, _ = row("op12 precision=high", "op12", fish,
                 rt.analytic_medium("fisheye"), p1, t1,
                 delta_s=2 * np.pi / 4587, steps=4587 * 10,
                 precision="high")
    err = float(np.linalg.norm(np.asarray(out.pos)[0] - [1.0, 0.0]))
    log(f"[main]   df32 ten-turn closure {err:.6e} (threshold 1e-5)")
    check(err < 1e-5, "df32 closure")

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["--scenario", "fisheye", "--op", "6", "--rays", str(RAYS),
                  "--medium", "analytic", "--n-turns", "1"])
    lines = [s.strip() for s in buf.getvalue().splitlines() if s.strip()]
    log(f"[main] cli --rays {RAYS} ({time.perf_counter() - t0:.3f}s): "
        + " | ".join(lines))
    check(any("via the fused engine" in s for s in lines), "cli engine")

    t0 = time.perf_counter()
    res = run_oracles()
    log(f"[main] run_oracles ({time.perf_counter() - t0:.3f}s):")
    for k, v in res.items():
        shown = {a: b for a, b in v.items() if a not in ("note",)}
        log(f"[main]   {k}: {shown}")
        check(v["pass"], k)


def phase_parity_and_timing():
    import jax

    from raytracing_tpu.bench import parity

    sub = slice(None, None, parity.STRIDE)
    rows = []
    for name, case in parity.cases().items():
        p, l = case.fan(parity.FULL_RAYS)
        (out, engine), first, warm = timed(lambda: case.kernel(p, l))
        out = np.asarray(out)
        check(np.isfinite(out).all(), f"{name}: non-finite output")
        dev = parity.deviation(case, out[sub], p[sub], l[sub])
        bound = parity.BOUND[name]
        log(f"[parity] {name}: engine {engine}  deviation {dev:.6e}  "
            f"bound {bound:.1e}")
        check(dev <= bound, f"{name}: deviation {dev} > {bound}")
        ref, sfirst, swarm = timed(lambda: case.scan(p, l, np.float32))
        rows.append((name, case.steps, first, warm, sfirst, swarm))
        del ref
        jax.clear_caches()
    for name, steps, first, warm, sfirst, swarm in rows:
        log(f"[kernel-vs-xla] {name}: {parity.FULL_RAYS} rays x {steps} "
            f"steps  kernel {warm:.6f}s (compile+first {first:.3f}s)  "
            f"scan-f32 {swarm:.6f}s (compile+first {sfirst:.3f}s)  "
            f"speedup {swarm / warm:.3f}x")


def phase_grid_media():
    import jax

    import raytracing_tpu as rt
    from raytracing_tpu.engine.fast import fast_trace, fast_trace3
    from raytracing_tpu.media.c1 import build_c1_medium
    from raytracing_tpu.media.grid3 import c1_medium3_from_samples
    from raytracing_tpu.media.spline import build_grid_medium

    scen = rt.scenario("fisheye")
    divisor = 4587
    ds = 2 * np.pi / divisor
    from raytracing_tpu.bench.parity import _fan_fisheye
    p, t = _fan_fisheye(RAYS)
    sub = slice(None, None, RAYS // 256)
    # 4x the float32-vs-float64 deviation of the same scan on the CPU
    bound = {"spline": GRID_BOUND_SPLINE, "c1": GRID_BOUND_C1}
    for name, build in (("spline", build_grid_medium),
                        ("c1", build_c1_medium)):
        med = build("fisheye", scen.box, dtype=np.float32)
        out, first, warm = timed(lambda: fast_trace(
            "op1", scen, med, delta_s=ds, steps=divisor, pos0=p,
            theta0=t), reps=1)
        check(out.engine == "scan", out.engine)
        with jax.enable_x64(True):
            ref = rt.trace("op1", scen, build("fisheye", scen.box,
                                              dtype=np.float64),
                           delta_s=ds, max_size=divisor + 1, mode="metrics",
                           dtype=np.float64, pos0=p[sub], theta0=t[sub])
            ref = np.asarray(ref.final.pos)
        dev = float(np.abs(np.asarray(out.pos)[sub] - ref).max())
        log(f"[grid] fisheye {name} op1 {RAYS} rays x {divisor} steps: "
            f"engine {out.engine}  compile+first {first:.3f}s warm "
            f"{warm:.6f}s  deviation from float64 {dev:.6e} "
            f"(bound {bound[name]:.1e})")
        check(dev <= bound[name], f"grid {name} deviation")

    g = np.linspace(-2.0, 2.0, 41)
    Zg, Yg, Xg = np.meshgrid(g, g, g, indexing="ij")
    med3 = c1_medium3_from_samples(1.0 / (1.0 + Xg ** 2 + Yg ** 2 + Zg ** 2),
                                   g, g, g, dtype=np.float32)
    from raytracing_tpu.bench.parity import _fan3_fisheye
    p3, d3 = _fan3_fisheye(RAYS)
    box3 = (-2.0, 2.0, -2.0, 2.0, -2.0, 2.0)
    (res, eng), first, warm = timed(lambda: fast_trace3(
        "op6", med3, pos0=p3, dir0=d3, delta_s=2 * np.pi / 300, steps=300,
        box=box3), reps=1)
    check(eng == "scan3d", eng)
    log(f"[grid] C1Grid3Medium op6 {RAYS} rays x 300 steps: engine {eng}  "
        f"compile+first {first:.3f}s warm {warm:.6f}s  finite "
        f"{bool(np.isfinite(np.asarray(res.pos)).all())}")
    check(np.isfinite(np.asarray(res.pos)).all(), "grid3 output")
    jax.clear_caches()


def phase_dynamic_3d():
    from raytracing_tpu.bench import parity
    from raytracing_tpu.engine.fast import (fast_dynamic, fast_dynamic3,
                                            fast_trace3)
    from raytracing_tpu.media.fields3d import analytic_medium3
    import raytracing_tpu as rt

    rays = 1 << 18
    stride = rays // (parity.FULL_RAYS // parity.STRIDE)
    sub = slice(None, None, stride)
    cs = parity.cases()
    import jax.numpy as jnp

    def report(name, case_name, engine, first, warm, out, p, l):
        dev = parity.deviation(cs[case_name], np.asarray(out)[sub], p[sub],
                               l[sub])
        bound = parity.BOUND[case_name]
        log(f"[dyn3d] {name}: engine {engine}  compile+first {first:.3f}s "
            f"warm {warm:.6f}s  deviation {dev:.6e} bound {bound:.1e}")
        check(dev <= bound, f"{name} deviation")

    fish = rt.scenario("fisheye")
    p, t = cs["dynamic-analytic"].fan(rays)
    (d, eng), first, warm = timed(lambda: fast_dynamic(
        "op6", fish, rt.analytic_medium("fisheye"),
        delta_s=float(np.float32(2 * np.pi / 1000)), steps=1000, pos0=p,
        theta0=t))
    check(eng == "dynamic-kernel", eng)
    report("fast_dynamic analytic", "dynamic-analytic", eng, first, warm,
           jnp.concatenate([d.pos, d.q[:, None]], 1), p, t)

    vert = rt.scenario("vert")
    p, t = cs["dynamic-strat"].fan(rays)
    (d, eng), first, warm = timed(lambda: fast_dynamic(
        "op8", vert, parity._media("vert-c1"), delta_s=0.02, steps=1500,
        pos0=p, theta0=t))
    check(eng == "dynamic-kernel-strat", eng)
    report("fast_dynamic stratified", "dynamic-strat", eng, first, warm,
           jnp.concatenate([d.pos, d.q[:, None]], 1), p, t)

    p, dr = cs["fused3d"].fan(rays)
    (f, eng), first, warm = timed(lambda: fast_trace3(
        "op6", analytic_medium3("fisheye"), pos0=p, dir0=dr,
        delta_s=float(np.float32(2 * np.pi / 1000)), steps=1000,
        box=parity.BOX3))
    check(eng == "fused3d", eng)
    report("fast_trace3", "fused3d", eng, first, warm, f.pos, p, dr)

    p, dr = cs["dynamic3d"].fan(rays)
    (f, eng), first, warm = timed(lambda: fast_dynamic3(
        "op8", analytic_medium3("interface"), pos0=p, dir0=dr, delta_s=0.01,
        steps=600, box=parity.BOX3_IF))
    check(eng == "dynamic3-kernel", eng)
    report("fast_dynamic3", "dynamic3d", eng, first, warm,
           jnp.concatenate([f.pos, f.detq[:, None]], 1), p, dr)


def phase_server():
    import urllib.request

    from raytracing_tpu import serve

    srv = serve.create_server("127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(
            url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())

    try:
        for body, engine in (
                ({"scenario": "fisheye", "op": "op6", "rays": 65536},
                 "fused"),
                ({"scenario": "interface", "op": "op6", "rays": 65536,
                  "medium": "stratified"}, "fused-strat-seg-skip"),
                ({"scenario": "aniso", "op": "op11", "rays": 65536},
                 "golden")):
            t0 = time.perf_counter()
            code, out = post("/v1/trace", body)
            check(code == 200, f"/v1/trace {body}: {code}")
            check(out["engine"] == engine, f"{body}: engine {out['engine']}")
            check(all(np.isfinite(out["mean_final_pos"])), "server output")
            log(f"[server] /v1/trace {body['scenario']} {body['op']}: 200 "
                f"engine {out['engine']}  {time.perf_counter() - t0:.3f}s")
        y = np.linspace(-2.0, 1.0, 61)
        req = {"samples": (1.0 + 0.3 * np.tanh(2.0 * y)).tolist(),
               "y": y.tolist(), "op": "op6", "family": "c1",
               "delta_s": 0.01, "steps": 400, "rays": 65536,
               "box": [-5.0, 5.0, -2.0, 1.0],
               "launch": {"x": 0.0, "y": [-1.5, -0.5], "theta": 0.3}}
        code, out = post("/v1/trace_samples", req)
        check(code == 200, f"/v1/trace_samples: {code}")
        check(out["engine"] != "scan", out["engine"])
        log(f"[server] /v1/trace_samples profile: 200 engine "
            f"{out['engine']}  {out['ray_steps_per_sec']:.6e} ray-steps/s")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)


def phase_four():
    import jax

    import raytracing_tpu as rt
    from raytracing_tpu import config
    from raytracing_tpu.engine.fast import fast_trace, fast_trace_sharded
    from raytracing_tpu.bench import parity
    from raytracing_tpu.media.c1 import build_c1_medium
    from raytracing_tpu.media.spline import build_stratified_medium
    from raytracing_tpu.parallel.mesh import make_mesh
    from raytracing_tpu.parallel.sweep import delta_s_search

    mesh = make_mesh(4)
    log(f"[four] mesh {dict(mesh.shape)} over {mesh.devices.size} GPUs")
    fish = rt.scenario("fisheye")
    p, t = parity._fan_fisheye(RAYS)
    scen_if = rt.scenario("interface")
    pi, ti = _fan(scen_if, RAYS)
    med_if = build_stratified_medium("interface", scen_if.box,
                                     dtype=np.float32)
    med_grid = build_c1_medium("fisheye", fish.box, dtype=np.float32)
    failed = []
    for name, scen, med, pos0, th0, ds, steps in (
            ("fisheye op6", fish, rt.analytic_medium("fisheye"), p, t,
             2 * np.pi / 303, 606),
            ("interface op6 sampled", scen_if, med_if, pi, ti,
             config.SIGMA / 2.55, 1500),
            ("fisheye op6 C1 grid", fish, med_grid, p, t, 2 * np.pi / 303,
             606)):
        sh, first, warm = timed(lambda: fast_trace_sharded(
            "op6", scen, med, delta_s=ds, pos0=pos0, theta0=th0, mesh=mesh,
            steps=steps, block_rays=min(4096, RAYS // 4)))
        one, first1, warm1 = timed(lambda: jax.device_put(fast_trace(
            "op6", scen, med, delta_s=ds, pos0=pos0, theta0=th0,
            steps=steps).pos, jax.devices()[0]))
        a, b = np.asarray(sh.pos), np.asarray(one)
        dev = float(np.abs(a - b).max())
        ulps = float(np.max(np.abs(a.view(np.int32).astype(np.int64)
                                   - b.view(np.int32).astype(np.int64))))
        log(f"[four] {name}: engine {sh.engine}  4 GPUs {warm:.6f}s "
            f"(compile+first {first:.3f}s)  1 GPU {warm1:.6f}s  "
            f"speedup {warm1 / warm:.3f}x  max |diff| {dev:.3e} "
            f"({ulps:.0f} ulp, bound 0 ulp)")
        if ulps != 0:
            failed.append(f"{name}: sharded differs from one GPU")
    # the sharded search runs the scan engine (the kernel sweep takes no
    # mesh), so the one-GPU search it must match is the scan engine's; the
    # one-GPU default (the kernel sweep) is printed beside them
    searches = {}
    for tag, kw in (("4 GPUs scan", dict(mesh=mesh)),
                    ("1 GPU scan", dict(engine="scan")),
                    ("1 GPU default", dict())):
        t0 = time.perf_counter()
        searches[tag] = delta_s_search("op6", fish,
                                       rt.analytic_medium("fisheye"), **kw)
        log(f"[four] delta_s_search op6 fisheye, {tag}: divisor "
            f"{searches[tag].divisor} ({time.perf_counter() - t0:.3f}s)")
    s4, s1 = searches["4 GPUs scan"], searches["1 GPU scan"]
    if s4.divisor != s1.divisor or s4.divisor is None:
        failed.append("sharded DELTA_S choice differs")
    check(not failed, "; ".join(failed))


PHASES = (("headline", phase_headline), ("main", phase_main_path),
          ("parity", phase_parity_and_timing), ("grid", phase_grid_media),
          ("dyn3d", phase_dynamic_3d), ("server", phase_server))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded phase")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    from raytracing_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    count = 4 if args.four else 1
    smi = phase_device(count)
    t_all = time.perf_counter()
    if args.four:
        phase_four()
    else:
        for name, phase in PHASES:
            t0 = time.perf_counter()
            phase()
            log(f"[{name}] phase done in {time.perf_counter() - t0:.1f}s")
    d = jax.devices()[0]
    log(f"[done] {time.perf_counter() - t_all:.1f}s  card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
