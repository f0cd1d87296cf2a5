"""Fused fisheye op1 integrator: the headline kernel.

The plain scan tier (``engine/trace.py``: ``lax.scan`` over steps, vmapped
over rays) carries the whole ray state through device memory on every
step.  This kernel keeps each ray's state in registers for all of its
steps, so state traffic falls from O(rays * steps) to O(rays) and the
35 flops per ray-step are the limit.

Math: op1 (RT_bench.py:469-491) specialized to the analytic Maxwell fisheye —
first-order position advance + the analytic momentum-impulse angle update
(RT_bench.py:393-407) expressed trig-free: instead of
``theta = atan2(sy, sx); u = (cos theta, sin theta)`` the unit tangent is the
normalization ``(sx, sy) * rsqrt(sx^2 + sy^2)`` — identical up to rounding,
no transcendentals in the hot loop.  Positions accumulate with Kahan
compensation so float32 holds to ~1e-7 over thousands of steps.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu.kernels.launch import ray_block_call


def _fisheye_kernel(steps: int, x_ref, y_ref, ux_ref, uy_ref, ds_ref,
                    out_x_ref, out_y_ref, out_tt_ref):
    ds = ds_ref[0]
    x = x_ref[...]
    y = y_ref[...]
    ux = ux_ref[...]
    uy = uy_ref[...]
    # Kahan compensation terms for the position sums.
    cx = jnp.zeros_like(x)
    cy = jnp.zeros_like(y)

    def n_and_grad(x, y):
        n = 1.0 / (1.0 + x * x + y * y)
        c = -2.0 * n * n
        return n, c * x, c * y

    n, gx, gy = n_and_grad(x, y)
    tt = jnp.zeros_like(x)

    def body(_, carry):
        x, y, cx, cy, ux, uy, n, gx, gy, tt = carry
        # first_order_taylor with Kahan-compensated accumulation
        dx = ux * ds - cx
        nx = x + dx
        cx = (nx - x) - dx
        x = nx
        dy = uy * ds - cy
        ny = y + dy
        cy = (ny - y) - dy
        y = ny

        n2, gx2, gy2 = n_and_grad(x, y)
        # theta_cost_t, trig-free: new tangent = normalized momentum+impulse
        half = ds * 0.5
        sx = n * ux + (gx + gx2) * half
        sy = n * uy + (gy + gy2) * half
        inv = jax.lax.rsqrt(sx * sx + sy * sy)
        ux = sx * inv
        uy = sy * inv
        # optical path: dist == ds for a first-order step (|u| == 1)
        tt = tt + ds * (n + n2) * 0.5
        return x, y, cx, cy, ux, uy, n2, gx2, gy2, tt

    x, y, cx, cy, ux, uy, n, gx, gy, tt = jax.lax.fori_loop(
        0, steps, body, (x, y, cx, cy, ux, uy, n, gx, gy, tt))
    out_x_ref[...] = x
    out_y_ref[...] = y
    out_tt_ref[...] = tt


@functools.partial(jax.jit, static_argnames=("steps", "block_rays", "interpret"))
def fisheye_trace_final(pos0, theta0, delta_s, *, steps: int,
                        block_rays: int = 4096, interpret: bool | None = None):
    """Integrate ``steps`` op1 fisheye steps; return final (pos, traveltime).

    ``pos0`` is (R, 2) float32, ``theta0`` (R,); R must be a multiple of
    ``block_rays`` (pad the batch — rays are independent).
    """
    r = pos0.shape[0]
    if r % block_rays:
        raise ValueError(f"rays {r} not a multiple of block {block_rays}")
    fx, fy, tt = ray_block_call(
        functools.partial(_fisheye_kernel, steps),
        [pos0[:, 0], pos0[:, 1], jnp.cos(theta0), jnp.sin(theta0)],
        jnp.asarray([delta_s], jnp.float32), 3, interpret=interpret,
        name="fisheye_op1")
    return jnp.stack([fx, fy], axis=-1), tt


def make_fisheye_runner(rays: int, divisor: int, n_turns: int,
                        block_rays: int = 4096):
    """bench.py adapter: returns a callable that runs ``pipeline``
    back-to-back launches and blocks until the last is done, returning the
    final positions as a (R, 2) array (reference step-count semantics:
    steps = n_turns * (divisor + 1) - 1, RT_bench.py:797, 1388)."""
    steps = n_turns * (divisor + 1) - 1
    pad = (-rays) % block_rays
    n = rays + pad
    # the launch batch is committed to the device once, outside the timing
    pos0 = jax.device_put(
        np.stack([np.ones(n), np.zeros(n)], -1).astype(np.float32))
    theta0 = jax.device_put(np.full(n, np.pi / 2.0, np.float32))
    ds = np.float32(2.0 * np.pi / divisor)

    def run(pipeline: int = 1):
        pos = None
        for _ in range(pipeline):
            pos, _ = fisheye_trace_final(pos0, theta0, ds, steps=steps,
                                         block_rays=block_rays)
        return jax.block_until_ready(pos[:rays])

    return run
