"""Every kernel entry lowers for CUDA through Triton, checked on the CPU.

The GPU compiler is not reachable here, but the Pallas->Triton lowering is:
``jax.jit(f).trace(*args).lower(lowering_platforms=("cuda",))`` runs the
whole Triton lowering of each kernel and must produce the
``__gpu$xla.gpu.triton`` custom call (and no Mosaic call).  Also the route
table of kernels/route.py.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raytracing_tpu as rt
from raytracing_tpu.kernels import df, dynamic, dynamic3d, fused, fused3d
from raytracing_tpu.kernels import golden, launch, route
from raytracing_tpu.kernels.fisheye import fisheye_trace_final
from raytracing_tpu.media.medium import CustomMedium

R = 256
STEPS = 8
BOX = (-10.0, 10.0, -10.0, 10.0)
BOX3 = (-10.0, 10.0, -10.0, 10.0, -10.0, 10.0)


def _fan():
    th = jnp.linspace(0.2, 1.2, R, dtype=jnp.float32)
    pos = jnp.zeros((R, 2), jnp.float32)
    return pos, th


def _fan3():
    d = jnp.stack([jnp.ones(R), jnp.linspace(-0.3, 0.3, R), jnp.zeros(R)],
                  -1).astype(jnp.float32)
    return jnp.zeros((R, 3), jnp.float32), d


def _strat(c1: bool):
    scen = rt.scenario("interface")
    from raytracing_tpu.media.c1 import build_c1_stratified
    from raytracing_tpu.media.spline import build_stratified_medium

    if c1:
        return build_c1_stratified("interface", scen.box, dtype=np.float32)
    return build_stratified_medium("interface", scen.box, dtype=np.float32)


def _segments(skip: bool):
    from raytracing_tpu.engine.segmented import _initial_comps, _run_segments

    pos, th = _fan()
    state = tuple(_initial_comps("op6", pos, th, with_stats=False))
    return functools.partial(
        _run_segments, field="interface", op="op6", segment=STEPS,
        box=BOX, interpret=False, stats=False, strat=None, n_state=9,
        skip=skip), (state, None, jnp.float32(0.01), jnp.float32(32.0),
                     jnp.float32(0.0), jnp.int32(4))


def _entries():
    pos, th = _fan()
    pos3, dir3 = _fan3()
    ds = jnp.float32(0.01)
    k = dict(steps=STEPS, box=BOX, block_rays=R, interpret=False)
    custom = CustomMedium(lambda x, y: 1.0 + 0.1 * jnp.tanh(y))
    return {
        "fisheye": (functools.partial(fisheye_trace_final, steps=STEPS,
                                      block_rays=R, interpret=False),
                    (pos, th, ds)),
        "fused-analytic": (functools.partial(
            fused.fused_trace_final, field="interface", op="op6", **k),
            (pos, th, ds)),
        "fused-custom": (functools.partial(
            fused.fused_trace_final_custom, medium=custom, op="op6", **k),
            (pos, th, ds)),
        "fused-strat-parity": (functools.partial(
            fused.fused_trace_final_strat, op="op6", **k),
            (pos, th, ds, _strat(False))),
        "fused-strat-c1": (functools.partial(
            fused.fused_trace_final_strat, op="op8", **k),
            (pos, th, ds, _strat(True))),
        "golden-analytic": (functools.partial(
            golden.golden_trace_final, field="vert_heterogeneous",
            op="op11", **k), (pos, th, ds, jnp.float32(1.5))),
        "golden-strat": (functools.partial(
            golden.golden_trace_final, field="interface", op="op9",
            medium=_strat(False), **k), (pos, th, ds, jnp.float32(1.0))),
        "segmented-resume": _segments(skip=False),
        "segmented-resume-skip": _segments(skip=True),
        "df32": (functools.partial(df._df_core, field="fisheye",
                                   steps=STEPS, block_rays=R,
                                   interpret=False), (pos, th, ds)),
        "df32-segmented": (functools.partial(
            df._df_core_segmented, field="vert_heterogeneous", segment=4,
            n_full=2, rem=3, block_rays=R, interpret=False), (pos, th, ds)),
        "dynamic-analytic": (functools.partial(
            dynamic.dynamic_trace_final, field="fisheye", op="op6", **k),
            (pos, th, ds)),
        "dynamic-strat": (functools.partial(
            dynamic.dynamic_trace_final_strat, op="op8", **k),
            (pos, th, ds, _strat(True))),
        "fused3d": (functools.partial(
            fused3d.fused3d_trace_final, field="fisheye", op="op6",
            steps=STEPS, box=BOX3, block_rays=R, interpret=False),
            (pos3, dir3, ds)),
        "dynamic3d": (functools.partial(
            dynamic3d.dynamic3d_trace_final, field="interface", op="op8",
            steps=STEPS, box=BOX3, block_rays=R, interpret=False),
            (pos3, dir3, ds)),
    }


ENTRIES = ("fisheye", "fused-analytic", "fused-custom", "fused-strat-parity",
           "fused-strat-c1", "golden-analytic", "golden-strat",
           "segmented-resume", "segmented-resume-skip", "df32",
           "df32-segmented", "dynamic-analytic", "dynamic-strat", "fused3d",
           "dynamic3d")


@pytest.mark.parametrize("entry", ENTRIES)
def test_kernel_lowers_to_triton_for_cuda(entry):
    with jax.enable_x64(False):
        f, args = _entries()[entry]
        text = jax.jit(f).trace(*args).lower(
            lowering_platforms=("cuda",)).as_text()
    targets = set(re.findall(r"custom_call @([^\(]+)\(", text))
    assert "__gpu$xla.gpu.triton" in targets, targets
    assert not any("mosaic" in t.lower() for t in targets), targets


def test_entry_table_is_complete():
    assert set(_entries()) == set(ENTRIES)


@pytest.mark.parametrize("platform,expected", [("cpu", "interpret"),
                                               ("gpu", "triton")])
def test_kernel_route_table(platform, expected):
    assert route.kernel_route(platform) == expected


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_kernel_route_refuses_other_platforms(platform):
    with pytest.raises(RuntimeError, match=platform):
        route.kernel_route(platform)


def test_resolve_interpret_follows_route_on_cpu():
    assert route.resolve_interpret(None) is True
    assert route.resolve_interpret(False) is False


@pytest.mark.parametrize("rays,expected", [(128, 128), (4096, 128),
                                           (384, 128), (640, 128),
                                           (96, 32)])
def test_program_rays_divides_the_batch(rays, expected):
    assert launch.program_rays(rays) == expected
    assert rays % launch.program_rays(rays) == 0


def test_program_flags_mark_live_programs():
    # two programs of 128 rays; one ray of the second is still active
    act = jnp.zeros(256, jnp.float32).at[200].set(1.0)
    np.testing.assert_array_equal(launch.program_flags(act), [0.0, 1.0])
