"""Fused integrator for the 3-D tier: analytic fields, vector ops.

The 3-D counterpart of :mod:`kernels.fused` for the method set
:data:`engine.trace3d.METHODS3` (op1/op2/op6/op8).  Each ray's state —
position, unit tangent, Kahan compensations, accumulators — stays in
registers across every step; per-step device-memory traffic is zero.

* The RK2 tangent update is the ROTATION-VECTOR Heun of engine/trace3d.py
  (the form that matches the 2-D engine's accuracy, docs/PRECISION.md
  round-3 addendum), expressed entirely in the rotation angle SQUARED:
  ``cos a = 1 - a2 * vers(a2)``, ``sinc`` and ``vers`` as degree-2
  polynomials in a2 — no sqrt, no sin/cos, no atan2 in the hot loop (the
  increments are O(ds * curvature), so the truncation sits below f32 eps).
* The momentum-impulse update is an rsqrt normalization of p = n u + J.
* The activity mask is f32; boundary exit is a 6-face per-ray mask.

Interpret-mode parity vs the scan tier is tested in tests/test_fused3d.py.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu.config import THCK_PARAM
from raytracing_tpu.kernels.launch import ray_block_call
FUSED3_FIELDS = ("fisheye", "vert_heterogeneous", "interface")
FUSED3_OPS = ("op1", "op2", "op6", "op8")
_SQRT2 = 1.4142135623730951


def _field3_fn(field: str):
    """n and its 3-D gradient, inlined into the kernel (media/fields3d.py
    twins; the stratified fields lift with dn/dz = 0)."""
    if field == "fisheye":
        def f(x, y, z):
            n = 1.0 / (1.0 + x * x + y * y + z * z)
            c = -2.0 * n * n
            return n, c * x, c * y, c * z
    elif field == "vert_heterogeneous":
        def f(x, y, z):
            n = 1.0 / (18.0 + 2.0 * y)
            zero = jnp.zeros_like(x)
            return n, zero, -2.0 * n * n, zero
    else:  # interface
        def f(x, y, z):
            sig = 1.0 / (1.0 + jnp.exp(-y / THCK_PARAM))
            n = _SQRT2 - (_SQRT2 - 1.0) * sig
            zero = jnp.zeros_like(x)
            return (n, zero,
                    -(_SQRT2 - 1.0) * sig * (1.0 - sig) / THCK_PARAM, zero)
    return f


def _rot_coeffs(a2):
    """(cos a, sin a / a, (1 - cos a) / a^2) as polynomials in a^2.

    cos comes FROM vers (cos = 1 - a2*vers) so the three stay mutually
    consistent to the truncation order; |u| is preserved to ~a^6.
    """
    sinc = 1.0 - a2 * (1.0 / 6.0) * (1.0 - a2 * 0.05)
    vers = 0.5 * (1.0 - a2 * (1.0 / 12.0) * (1.0 - a2 * (1.0 / 30.0)))
    return 1.0 - a2 * vers, sinc, vers


def _rodrigues3(ux, uy, uz, rx, ry, rz):
    """Rotate unit (ux,uy,uz) by rotation vector (rx,ry,rz), poly form."""
    a2 = rx * rx + ry * ry + rz * rz
    cos, sinc, vers = _rot_coeffs(a2)
    # rho x u
    cx = ry * uz - rz * uy
    cy = rz * ux - rx * uz
    cz = rx * uy - ry * ux
    rdotu = rx * ux + ry * uy + rz * uz
    return (ux * cos + cx * sinc + rx * rdotu * vers,
            uy * cos + cy * sinc + ry * rdotu * vers,
            uz * cos + cz * sinc + rz * rdotu * vers)


def _step_body3(op: str, box, nag, zero, ds, limit, offset=0.0):
    """The shared per-step fori body over the 16-component 3-D carry.

    One definition of the vector-op physics (position advance, poly-
    rotation Heun / impulse tangent update, optical-path accumulation,
    6-face exit).  ``offset`` is the global step count before this launch
    (resume-chained kernels).
    """
    second_order = op in ("op6", "op8")
    rk2 = op in ("op2", "op6")
    limx_i, limx_s, limy_i, limy_s, limz_i, limz_s = [float(v) for v in box]

    def body(i, carry):
        in_limit = (i.astype(jnp.float32) + offset) < limit
        (x, y, z, cx, cy, cz, ux, uy, uz, n, gx, gy, gz, tt, dsim,
         active) = carry

        # -- position advance (ops/steppers.py in vector form) -------
        if second_order:
            gdotu = gx * ux + gy * uy + gz * uz
            half_fac = ds * ds * 0.5 / n
            ddx = ux * ds + (gx - gdotu * ux) * half_fac
            ddy = uy * ds + (gy - gdotu * uy) * half_fac
            ddz = uz * ds + (gz - gdotu * uz) * half_fac
        else:
            ddx, ddy, ddz = ux * ds, uy * ds, uz * ds

        # Kahan-compensated position accumulation
        tx = ddx - cx
        nx2 = x + tx
        cx2 = (nx2 - x) - tx
        ty = ddy - cy
        ny2 = y + ty
        cy2 = (ny2 - y) - ty
        tz = ddz - cz
        nz2 = z + tz
        cz2 = (nz2 - z) - tz

        n2, gx2, gy2, gz2 = nag(nx2, ny2, nz2)

        # -- tangent update -------------------------------------------
        if rk2:
            # rotation-vector Heun (engine/trace3d.py), poly rotations
            inv_n = 1.0 / n
            gdotu = gx * ux + gy * uy + gz * uz
            k1x = ds * (gx - gdotu * ux) * inv_n
            k1y = ds * (gy - gdotu * uy) * inv_n
            k1z = ds * (gz - gdotu * uz) * inv_n
            r1x = uy * k1z - uz * k1y
            r1y = uz * k1x - ux * k1z
            r1z = ux * k1y - uy * k1x
            umx, umy, umz = _rodrigues3(ux, uy, uz, r1x, r1y, r1z)
            inv_n2 = 1.0 / n2
            gdotm = gx2 * umx + gy2 * umy + gz2 * umz
            k2x = ds * (gx2 - gdotm * umx) * inv_n2
            k2y = ds * (gy2 - gdotm * umy) * inv_n2
            k2z = ds * (gz2 - gdotm * umz) * inv_n2
            rx = (r1x + (umy * k2z - umz * k2y)) * 0.5
            ry = (r1y + (umz * k2x - umx * k2z)) * 0.5
            rz = (r1z + (umx * k2y - umy * k2x)) * 0.5
            nux, nuy, nuz = _rodrigues3(ux, uy, uz, rx, ry, rz)
        else:
            # trapezoidal impulse on p = n u (theta_cost_t's direction)
            half = ds * 0.5
            sx = n * ux + (gx + gx2) * half
            sy = n * uy + (gy + gy2) * half
            sz = n * uz + (gz + gz2) * half
            inv = jax.lax.rsqrt(sx * sx + sy * sy + sz * sz)
            nux, nuy, nuz = sx * inv, sy * inv, sz * inv

        if second_order:
            dist = jnp.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
            ntt = tt + dist * (n + n2) * 0.5
            ndsim = dsim + dist
        else:
            ntt = tt + ds * (n + n2) * 0.5
            ndsim = dsim + ds

        out = ((nx2 > limx_s) | (nx2 < limx_i)
               | (ny2 > limy_s) | (ny2 < limy_i)
               | (nz2 > limz_s) | (nz2 < limz_i))
        keep = (active > 0.5) & in_limit

        def sel(new, old):
            return jnp.where(keep, new, old)

        nactive = jnp.where(keep & out, zero, active)
        return (sel(nx2, x), sel(ny2, y), sel(nz2, z),
                sel(cx2, cx), sel(cy2, cy), sel(cz2, cz),
                sel(nux, ux), sel(nuy, uy), sel(nuz, uz),
                sel(n2, n), sel(gx2, gx), sel(gy2, gy), sel(gz2, gz),
                sel(ntt, tt), sel(ndsim, dsim), nactive)

    return body


def _make_kernel3(field: str, op: str, steps: int, box):
    nag = _field3_fn(field)

    def kernel(x_ref, y_ref, z_ref, ux_ref, uy_ref, uz_ref, ds_ref,
               *out_refs):
        x, y, z = x_ref[...], y_ref[...], z_ref[...]
        ux, uy, uz = ux_ref[...], uy_ref[...], uz_ref[...]
        zero = jnp.zeros_like(x)
        cx = cy = cz = tt = dsim = zero
        active = zero + 1.0
        ds = ds_ref[0]
        limit = ds_ref[1]

        body = _step_body3(op, box, nag, zero, ds, limit)
        n, gx, gy, gz = nag(x, y, z)
        carry0 = (x, y, z, cx, cy, cz, ux, uy, uz, n, gx, gy, gz, tt,
                  dsim, active)
        final = jax.lax.fori_loop(0, steps, body, carry0)
        (fx, fy, fz, _, _, _, fux, fuy, fuz, _, _, _, _, ftt, fdsim,
         fact) = final
        for ref, val in zip(out_refs, (fx, fy, fz, fux, fuy, fuz, ftt,
                                       fdsim, fact)):
            ref[...] = val

    return kernel


class Fused3Final(NamedTuple):
    """Final-state bundle of a fused 3-D kernel run (arrays length R)."""

    pos: Any          # (R, 3)
    tangent: Any      # (R, 3) unit tangent at exit
    traveltime: Any   # (R,)
    dist_sim: Any     # (R,)
    active: Any       # (R,) bool


@functools.partial(jax.jit, static_argnames=("field", "op", "steps", "box",
                                             "block_rays", "interpret"))
def fused3d_trace_final(pos0, dir0, delta_s, *, field: str, op: str,
                        steps: int, box, block_rays: int = 4096,
                        interpret: bool | None = None,
                        step_limit=None) -> Fused3Final:
    """Run ``steps`` fused 3-D integration steps; return a Fused3Final.

    Same contract as :func:`kernels.fused.fused_trace_final` with a 3-D
    launch (``dir0`` (R, 3), normalized internally) and a 6-face ``box``.
    """
    if field not in FUSED3_FIELDS:
        raise ValueError(f"fused 3-D kernel supports fields "
                         f"{FUSED3_FIELDS}, got {field!r}")
    if op not in FUSED3_OPS:
        raise ValueError(f"fused 3-D kernel supports ops {FUSED3_OPS}, "
                         f"got {op!r}")
    if len(box) != 6:
        raise ValueError(f"box must be 6 floats, got {box!r}")
    r = pos0.shape[0]
    if r % block_rays:
        raise ValueError(f"rays {r} not a multiple of block {block_rays}")
    dir0 = jnp.asarray(dir0, jnp.float32)
    dir0 = dir0 / jnp.linalg.norm(dir0, axis=-1, keepdims=True)
    pos0 = jnp.asarray(pos0, jnp.float32)
    if step_limit is None:
        step_limit = steps
    ds = jnp.stack([jnp.asarray(delta_s, jnp.float32),
                    jnp.asarray(step_limit, jnp.float32)])

    kernel = _make_kernel3(field, op, steps, tuple(float(v) for v in box))
    fx, fy, fz, fux, fuy, fuz, tt, dsim, act = ray_block_call(
        kernel, [pos0[:, k] for k in range(3)] + [dir0[:, k] for k in range(3)],
        ds, 9, interpret=interpret, name=f"fused3d_{op}_{field}")
    return Fused3Final(
        pos=jnp.stack([fx, fy, fz], -1),
        tangent=jnp.stack([fux, fuy, fuz], -1),
        traveltime=tt, dist_sim=dsim, active=act > 0.5)
