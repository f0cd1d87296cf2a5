"""Grid media over a device mesh: the scan tier, sharded by rays.

2-D and 3-D sampled grid media have no kernel; their entry points run the
jitted scan tier, which takes its ray layout from the launch arrays.  Rays
are independent, so the sharded trace must match one device to the bit
and come back spread over the mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raytracing_tpu as rt
from raytracing_tpu.engine.fast import (fast_dynamic, fast_dynamic3,
                                        fast_trace, fast_trace3,
                                        fast_trace_sharded)
from raytracing_tpu.media.c1 import build_c1_medium
from raytracing_tpu.media.grid3 import c1_medium3_from_samples
from raytracing_tpu.parallel.distributed import ray_batch_sharding
from raytracing_tpu.parallel.mesh import make_mesh

RAYS = 64
BOX3 = (-2.0, 2.0, -2.0, 2.0, -2.0, 2.0)


def _fan2():
    pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (RAYS, 1))
    theta0 = (np.pi / 2 + np.linspace(-0.02, 0.02, RAYS)).astype(np.float32)
    return pos0, theta0


def _fan3():
    t = np.linspace(0.0, 1.0, RAYS)
    pos0 = np.stack([0.6 + 0.6 * t, np.zeros(RAYS), np.zeros(RAYS)], -1)
    dir0 = np.stack([np.zeros(RAYS), np.cos(t), np.sin(t)], -1)
    return pos0.astype(np.float32), dir0.astype(np.float32)


def _medium3():
    g = np.linspace(-2.0, 2.0, 9)
    zg, yg, xg = np.meshgrid(g, g, g, indexing="ij")
    return c1_medium3_from_samples(1.0 / (1.0 + xg ** 2 + yg ** 2 + zg ** 2),
                                   g, g, g, dtype=np.float32)


def _trace2(pos0, theta0):
    scen = rt.scenario("fisheye")
    med = build_c1_medium("fisheye", scen.box, dtype=np.float32)
    out = fast_trace("op6", scen, med, delta_s=2 * np.pi / 64, steps=20,
                     pos0=pos0, theta0=theta0)
    assert out.engine == "scan"
    return out.pos


def _dynamic2(pos0, theta0):
    scen = rt.scenario("fisheye")
    med = build_c1_medium("fisheye", scen.box, dtype=np.float32)
    d, eng = fast_dynamic("op6", scen, med, delta_s=2 * np.pi / 64,
                          steps=20, pos0=pos0, theta0=theta0)
    assert eng == "dynamic-scan"
    return jnp.concatenate([d.pos, d.q[:, None]], 1)


def _trace3(pos0, dir0):
    f, eng = fast_trace3("op6", _medium3(), pos0=pos0, dir0=dir0,
                         delta_s=0.05, steps=20, box=BOX3)
    assert eng == "scan3d"
    return f.pos


def _dynamic3(pos0, dir0):
    f, eng = fast_dynamic3("op6", _medium3(), pos0=pos0, dir0=dir0,
                           delta_s=0.05, steps=20, box=BOX3)
    assert eng == "dynamic3-scan"
    return jnp.concatenate([f.pos, f.detq[:, None]], 1)


@pytest.mark.parametrize("run,fan", [(_trace2, _fan2), (_dynamic2, _fan2),
                                     (_trace3, _fan3), (_dynamic3, _fan3)],
                         ids=["trace", "dynamic", "trace3", "dynamic3"])
def test_grid_scan_tier_shards_by_rays(run, fan):
    pos0, launch = fan()
    sh = ray_batch_sharding(make_mesh(8))
    sharded = run(jax.device_put(pos0, sh), jax.device_put(launch, sh))
    assert len(sharded.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(sharded),
                                  np.asarray(run(pos0, launch)))


def test_fast_trace_sharded_grid_matches_single():
    scen = rt.scenario("fisheye")
    med = build_c1_medium("fisheye", scen.box, dtype=np.float32)
    pos0, theta0 = _fan2()
    out = fast_trace_sharded("op6", scen, med, delta_s=2 * np.pi / 64,
                             steps=20, pos0=pos0, theta0=theta0,
                             mesh=make_mesh(8))
    assert out.engine == "scan-sharded"
    np.testing.assert_array_equal(np.asarray(out.pos),
                                  np.asarray(_trace2(pos0, theta0)))
