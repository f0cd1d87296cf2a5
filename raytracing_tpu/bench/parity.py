"""Kernel-vs-reference parity cases, one per kernel entry.

Each case runs one kernel entry on a *varied* launch fan (identical rays
would show nothing) and the float64 scan tier on the same rays, and
compares the final positions (plus the paraxial tangent ``q`` / ``det Q``
for the dynamic kernels).  The same case also names the plain-XLA
version of the work — the float32 scan tier at the same op, medium, rays
and steps — which the kernel has to beat.

Fans are functions of the ray's relative index ``i / rays``, so the
stride-``STRIDE`` subset of a 2^20-ray batch is exactly the fan of
``2^20 / STRIDE`` rays: the bound each case states (``BOUND``) is four
times the deviation the kernel shows on that subset in CPU interpret
mode, and on the GPU the same subset is taken out of the full batch.  The
factor covers FMA contraction and the GPU's own ``rsqrt``/``exp``
rounding; tests/test_parity_cases.py re-measures the CPU side.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np

#: rays of a full-width run, and the subset stride compared to float64
FULL_RAYS = 1 << 20
STRIDE = 4096


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    steps: int
    #: (rays) -> launch arrays (pos0, theta0) or (pos0, dir0), float32
    fan: Callable
    #: (pos0, launch) -> (compared array, engine name) through the kernel
    kernel: Callable
    #: (pos0, launch, dtype) -> compared array through the scan tier
    scan: Callable


def _i(rays):
    return np.arange(rays, dtype=np.float64) / rays


def _fan_fisheye(rays):
    i = _i(rays)
    # orbits through (0.8..1.0, 0) that stay inside the fisheye box
    pos0 = np.stack([0.8 + 0.2 * i, np.zeros(rays)], -1)
    return (pos0.astype(np.float32),
            (np.pi / 2 + 0.2 * (i - 0.5)).astype(np.float32))


def _fan_from(scen_name, lo, hi):
    def fan(rays):
        import raytracing_tpu as rt

        scen = rt.scenario(scen_name)
        pos0 = np.tile(scen.pos0[:1], (rays, 1)).astype(np.float32)
        return pos0, (lo + (hi - lo) * _i(rays)).astype(np.float32)
    return fan


def _fan3_fisheye(rays):
    t = _i(rays)
    pos0 = np.stack([0.6 + 0.6 * t, np.zeros(rays), np.zeros(rays)], -1)
    dir0 = np.stack([np.zeros(rays), np.cos(t), np.sin(t)], -1)
    return pos0.astype(np.float32), dir0.astype(np.float32)


def _fan3_interface(rays):
    th = 0.15 + 1.2 * _i(rays)
    pos0 = np.tile([[0.0, -1.0, 0.0]], (rays, 1))
    dir0 = np.stack([np.cos(th) * 0.8, np.sin(th), np.cos(th) * 0.6], -1)
    return pos0.astype(np.float32), dir0.astype(np.float32)


BOX3 = (-2.0, 2.0, -2.0, 2.0, -2.0, 2.0)
BOX3_IF = (-1.0, 6.0, -1.5, 2.0, -1.0, 6.0)
#: steps of the sampled-interface cases: no ray of their fan leaves the box
#: before step 298, and a ray that exits one step earlier or later than the
#: float64 trace would move by a whole step, far above rounding
IN_BOX = 250


def _scen(name):
    import raytracing_tpu as rt
    return rt.scenario(name)


@functools.lru_cache(maxsize=None)
def _media(kind, dtype=np.float32):
    """One medium object per (kind, dtype): a custom medium is a static
    jit argument compared by identity, so a fresh one would recompile."""
    import raytracing_tpu as rt
    from raytracing_tpu.media.c1 import build_c1_stratified
    from raytracing_tpu.media.medium import CustomMedium
    from raytracing_tpu.media.spline import build_stratified_medium

    if kind == "custom":
        return CustomMedium(_custom_n)
    if kind == "interface-strat":
        return build_stratified_medium("interface", _scen("interface").box,
                                       dtype=dtype)
    if kind == "vert-c1":
        return build_c1_stratified("vert_heterogeneous", _scen("vert").box,
                                   dtype=dtype)
    return rt.analytic_medium(kind)


def _custom_n(x, y):
    # a smooth lens with no named-field twin: exercises the in-kernel jvp
    return 1.0 / (1.0 + x * x + 0.8 * y * y)


def _scan2(op, scen_name, medium_kind, steps, ds):
    def scan(pos0, theta0, dtype):
        import raytracing_tpu as rt

        res = rt.trace(op, _scen(scen_name), _media(medium_kind, dtype),
                       delta_s=ds, max_size=steps + 1, mode="metrics",
                       dtype=dtype, pos0=pos0, theta0=theta0)
        return res.final.pos
    return scan


def _dyn_scan2(op, scen_name, medium_kind, steps, ds):
    def scan(pos0, theta0, dtype):
        from raytracing_tpu.engine.dynamic import trace_dynamic

        import jax.numpy as jnp
        d = trace_dynamic(op, _scen(scen_name), _media(medium_kind, dtype),
                          delta_s=ds, mode="metrics", dtype=dtype,
                          pos0=pos0, theta0=theta0, max_size=steps + 1,
                          step_limit=steps)
        return jnp.concatenate([d.pos, d.q[:, None]], axis=1)
    return scan


def _cases():
    import jax.numpy as jnp

    from raytracing_tpu.engine.segmented import segmented_trace
    from raytracing_tpu.kernels.df import df_trace
    from raytracing_tpu.kernels.dynamic import (dynamic_trace_final,
                                                dynamic_trace_final_strat)
    from raytracing_tpu.kernels.dynamic3d import dynamic3d_trace_final
    from raytracing_tpu.kernels.fisheye import fisheye_trace_final
    from raytracing_tpu.kernels.fused import (fused_trace_final,
                                              fused_trace_final_custom,
                                              fused_trace_final_strat)
    from raytracing_tpu.kernels.fused3d import fused3d_trace_final
    from raytracing_tpu.kernels.golden import golden_trace_final

    box = {n: tuple(_scen(n).box) for n in ("fisheye", "interface", "vert")}
    fish_ds = float(np.float32(2 * np.pi / 1000))
    if_ds = 0.02
    v_ds = 0.02

    def blk(p):
        return min(4096, len(p))

    def k_fisheye(p, t):
        pos, _ = fisheye_trace_final(p, t, fish_ds, steps=1000,
                                     block_rays=blk(p))
        return pos, "fisheye"

    def k_fused(p, t):
        return fused_trace_final(p, t, if_ds, field="interface", op="op6",
                                 steps=1500, box=box["interface"],
                                 block_rays=blk(p)).pos, "fused"

    def k_custom(p, t):
        return fused_trace_final_custom(
            p, t, 2 * np.pi / 303, medium=_media("custom"), op="op6",
            steps=606, box=box["fisheye"], block_rays=blk(p)).pos, \
            "fused-custom"

    def k_strat(kind, op, steps):
        def k(p, t):
            return fused_trace_final_strat(
                p, t, if_ds, _media(kind), op=op, steps=steps,
                box=box["interface" if kind == "interface-strat" else
                        "vert"], block_rays=blk(p)).pos, "fused-strat"
        return k

    def k_golden(p, t):
        return golden_trace_final(
            p, t, v_ds, 3.0, field="vert_heterogeneous", op="op11",
            steps=1000, box=box["vert"], block_rays=blk(p)).pos, "golden"

    def k_golden_strat(p, t):
        return golden_trace_final(
            p, t, if_ds, 1.0, field="interface", op="op9", steps=IN_BOX,
            box=box["interface"], block_rays=blk(p),
            medium=_media("interface-strat")).pos, "golden-strat"

    def k_seg(skip):
        def k(p, t):
            f = segmented_trace(
                "op8" if skip else "op6", p, t, jnp.float32(
                    v_ds if skip else fish_ds), steps=1500 if skip else 1000,
                box=box["vert" if skip else "fisheye"],
                field="vert_heterogeneous" if skip else "fisheye",
                segment=256, block_rays=blk(p), skip_frozen=skip)
            return f.pos, "fused-seg-skip" if skip else "fused-seg"
        return k

    def k_df(field, segment, steps):
        # df32 has no boundary mask: the fans stay inside the boxes
        ds = fish_ds if field == "fisheye" else v_ds

        def k(p, t):
            return df_trace(p, t, np.float32(ds), steps=steps, field=field,
                            block_rays=blk(p), segment=segment), "df32"
        return k

    def k_dyn(p, t):
        d = dynamic_trace_final(p, t, fish_ds, field="fisheye", op="op6",
                                steps=1000, box=box["fisheye"],
                                block_rays=blk(p))
        return jnp.concatenate([d.pos, d.q[:, None]], 1), "dynamic-kernel"

    def k_dyn_strat(p, t):
        d = dynamic_trace_final_strat(p, t, v_ds, _media("vert-c1"),
                                      op="op8", steps=1500, box=box["vert"],
                                      block_rays=blk(p))
        return (jnp.concatenate([d.pos, d.q[:, None]], 1),
                "dynamic-kernel-strat")

    def k_f3(p, d):
        return fused3d_trace_final(p, d, fish_ds, field="fisheye", op="op6",
                                   steps=1000, box=BOX3,
                                   block_rays=blk(p)).pos, "fused3d"

    def k_d3(p, d):
        r = dynamic3d_trace_final(p, d, 0.01, field="interface", op="op8",
                                  steps=600, box=BOX3_IF,
                                  block_rays=blk(p))
        return jnp.concatenate([r.pos, r.detq[:, None]], 1), \
            "dynamic3-kernel"

    def s3(kind, op, ds, steps, box3):
        def scan(p, d, dtype):
            from raytracing_tpu.engine.trace3d import trace3d
            from raytracing_tpu.media.fields3d import analytic_medium3

            return trace3d(op, analytic_medium3(kind), pos0=p, dir0=d,
                           delta_s=ds, steps=steps, box=box3,
                           mode="metrics", dtype=dtype).final.pos
        return scan

    def sd3(p, d, dtype):
        from raytracing_tpu.engine.dynamic3d import trace_dynamic3
        from raytracing_tpu.media.fields3d import analytic_medium3

        r = trace_dynamic3("op8", analytic_medium3("interface"), pos0=p,
                           dir0=d, delta_s=0.01, steps=600, box=BOX3_IF,
                           mode="metrics", dtype=dtype)
        return jnp.concatenate([r.pos, r.detq[:, None]], 1)

    if_fan = _fan_from("interface", 2 * np.pi / 60, 1.5)
    # rays that cross the sampled interface and stay inside the box
    if_cross = _fan_from("interface", 0.5, 1.5)
    v_fan = _fan_from("vert", 0.05, 1.5)
    return [
        Case("fisheye", 1000, _fan_fisheye, k_fisheye,
             _scan2("op1", "fisheye", "fisheye", 1000, fish_ds)),
        Case("fused-analytic", 1500, if_fan, k_fused,
             _scan2("op6", "interface", "interface", 1500, if_ds)),
        Case("fused-custom", 606, _fan_fisheye, k_custom,
             _scan2("op6", "fisheye", "custom", 606, 2 * np.pi / 303)),
        Case("fused-strat-parity", IN_BOX, if_cross,
             k_strat("interface-strat", "op6", IN_BOX),
             _scan2("op6", "interface", "interface-strat", IN_BOX, if_ds)),
        Case("fused-strat-c1", 1500, v_fan, k_strat("vert-c1", "op8", 1500),
             _scan2("op8", "vert", "vert-c1", 1500, v_ds)),
        Case("golden-analytic", 1000, v_fan, k_golden,
             _scan2("op11", "aniso", "vert_heterogeneous", 1000, v_ds)),
        Case("golden-strat", IN_BOX, if_cross, k_golden_strat,
             _scan2("op9", "interface", "interface-strat", IN_BOX, if_ds)),
        Case("segmented-resume", 1000, _fan_fisheye, k_seg(False),
             _scan2("op6", "fisheye", "fisheye", 1000, fish_ds)),
        Case("segmented-resume-skip", 1500, v_fan, k_seg(True),
             _scan2("op8", "vert", "vert_heterogeneous", 1500, v_ds)),
        Case("df32", 1000, _fan_fisheye, k_df("fisheye", None, 1000),
             _scan2("op12", "fisheye", "fisheye", 1000, fish_ds)),
        Case("df32-segmented", 150, v_fan,
             k_df("vert_heterogeneous", 64, 150),
             _scan2("op12", "vert", "vert_heterogeneous", 150, v_ds)),
        Case("dynamic-analytic", 1000, _fan_fisheye, k_dyn,
             _dyn_scan2("op6", "fisheye", "fisheye", 1000, fish_ds)),
        Case("dynamic-strat", 1500, v_fan, k_dyn_strat,
             _dyn_scan2("op8", "vert", "vert-c1", 1500, v_ds)),
        Case("fused3d", 1000, _fan3_fisheye, k_f3,
             s3("fisheye", "op6", fish_ds, 1000, BOX3)),
        Case("dynamic3d", 600, _fan3_interface, k_d3, sd3),
    ]


def cases() -> dict:
    return {c.name: c for c in _cases()}


#: deviation bound over the stride subset: four times the CPU
#: interpret-mode deviation of the same kernel from the same float64
#: reference (re-measured by tests/test_parity_cases.py), rounded up.
BOUND = {
    "fisheye": 1.3e-5,
    "fused-analytic": 3.9e-5,
    "fused-custom": 3.9e-5,
    "fused-strat-parity": 1.8e-4,
    "fused-strat-c1": 1.9e-5,
    "golden-analytic": 4.3e-5,
    "golden-strat": 1.8e-4,
    "segmented-resume": 3.7e-4,
    "segmented-resume-skip": 1.2e-5,
    "df32": 1.7e-6,
    "df32-segmented": 5.6e-7,
    "dynamic-analytic": 3.7e-4,
    "dynamic-strat": 1.9e-5,
    "fused3d": 3.2e-4,
    "dynamic3d": 7.8e-4,
}


def deviation(case: Case, kernel_out, pos0, launch) -> float:
    """max |kernel - ref| / (1 + |ref|) against the float64 scan tier over
    the given rays: absolute below 1, relative above (det Q grows large)."""
    import jax

    # float64 only here: the kernels and the timings run in JAX's default
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        ref = np.asarray(case.scan(pos0, launch, np.float64), np.float64)
    got = np.asarray(kernel_out, np.float64)
    return float(np.max(np.abs(got - ref) / (1.0 + np.abs(ref))))


def subset_fan(case: Case, rays: int = FULL_RAYS, stride: int = STRIDE):
    """The launch arrays of the stride subset of a ``rays``-ray batch."""
    return case.fan(rays // stride)
