"""Fused 3-D dynamic integrator: two paraxial tangents in registers.

The 3-D dynamic tier (engine/dynamic3d.py) rides two exact ``jax.jvp``
tangents through the scan, at scan-tier speed.  As in 2-D (kernels/dynamic.py), ``jvp`` does not cross ``pallas_call``, so this
module hand-derives the directional derivative of the fused 3-D step map
(kernels/fused3d._step_body3's algebra) and carries BOTH launch-parameter
tangents per ray: ``(dpa, dua)`` and ``(dpb, dub)`` — d(pos)/d(angle) and
d(u)/d(angle) for the two transverse launch angles.

Unlike 2-D, the 3-D unit-tangent derivative cannot collapse to one scalar;
each ``du`` is a full 3-vector (transversality u . du = 0 holds by
construction of every update below).  The 2x2 paraxial determinant needs
NO transported frame at all:

    det Q = (dpa x dpb) . u

— the transverse-projected area, identical in every right-handed frame
transverse to ``u`` (the along-u components of dpa/dpb cancel in the
triple product).  KMAH counts its sign flips exactly as the scan tier
does; a tracked min |det Q| localizes point foci (engine/dynamic3d.py).

Tangent maps (symbols from kernels/fused3d._step_body3; H = Hessian of n,
inlined per analytic field by ``_field3_fn_h`` — the 3-D lift of the
reference's dead Hessian scaffolding, RT_bench.py:459-462):

* 1st-order position:  D = u ds          ->  dD = du ds
* 2nd-order position:  D = u ds + t ds^2/(2n),  t = g - (g.u) u
      dt = dg - ((dg.u) + (g.du)) u - (g.u) du,   dg = H dp,  dn = g . dp
      dD = du ds + (dt / (2n) - t dn / (2 n^2)) ds^2
* impulse solver:  s = n u + (g + g2) ds/2,  u' = s / |s|
      dsv = dn u + n du + (dg + dg2) ds/2
      du' = (dsv - (dsv . u') u') / |s|
* RK2 rotation-vector Heun:  differentiate every intermediate —
  dk like dt above, drho1 = du x k1 + u x dk1, and the Rodrigues rotation
  differential in its polynomial form (see ``_drodrigues3``): with
  a2 = rho . rho and (cos, sinc, vers) the polynomials of
  kernels/fused3d._rot_coeffs,
      d(R(rho) u) = du cos + (drho x u + rho x du) sinc
                    + drho (rho.u) vers + rho (drho.u + rho.du) vers
                    + da2 [u cos' + (rho x u) sinc' + rho (rho.u) vers']
      da2 = 2 rho . drho,  cos' = -(vers + a2 vers')
  (sinc' and vers' are the termwise derivatives of the same truncations,
  so the differential is the EXACT derivative of the kernel's own poly
  rotation — the hand tangent tracks the kernel's primal bit-for-bit
  semantics, not the ideal rotation's).

Launch tangents: source fixed (dp = 0), du = e1 / e2 — the orthonormal
transverse frame of engine/dynamic3d._transverse_frame, matching its
two-angle launch chart exactly at (0, 0).
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu.config import THCK_PARAM
from raytracing_tpu.kernels.fused3d import _rot_coeffs
from raytracing_tpu.kernels.launch import ray_block_call
from raytracing_tpu.media.fields import _sigmoid

#: analytic fields with inlined 3-D Hessians
DYN3_FUSED_FIELDS = ("fisheye", "vert_heterogeneous", "interface")
#: smooth vector ops with a hand tangent (all of METHODS3)
DYN3_FUSED_OPS = ("op1", "op2", "op6", "op8")

_SQRT2 = 1.4142135623730951


def _field3_fn_h(field: str):
    """n, grad n AND the (symmetric) Hessian of n, inlined.

    Returns ``f(x, y, z) -> (n, gx, gy, gz, hxx, hxy, hxz, hyy, hyz,
    hzz)`` with closed-form second derivatives — checked against
    jax.hessian in tests/test_dynamic_kernel3.py.
    """
    if field == "fisheye":
        def f(x, y, z):
            n = 1.0 / (1.0 + x * x + y * y + z * z)
            n2 = n * n
            c = -2.0 * n2
            n3_8 = 8.0 * n2 * n
            return (n, c * x, c * y, c * z,
                    c + n3_8 * x * x, n3_8 * x * y, n3_8 * x * z,
                    c + n3_8 * y * y, n3_8 * y * z,
                    c + n3_8 * z * z)
    elif field == "vert_heterogeneous":
        def f(x, y, z):
            n = 1.0 / (18.0 + 2.0 * y)
            zero = jnp.zeros_like(x)
            n2 = n * n
            return (n, zero, -2.0 * n2, zero,
                    zero, zero, zero, 8.0 * n2 * n, zero, zero)
    else:  # interface
        def f(x, y, z):
            sig = _sigmoid(y / THCK_PARAM)
            n = _SQRT2 - (_SQRT2 - 1.0) * sig
            zero = jnp.zeros_like(x)
            d = sig * (1.0 - sig)
            gy = -(_SQRT2 - 1.0) * d / THCK_PARAM
            hyy = (-(_SQRT2 - 1.0) * d * (1.0 - 2.0 * sig)
                   / (THCK_PARAM * THCK_PARAM))
            return (n, zero, gy, zero,
                    zero, zero, zero, hyy, zero, zero)
    return f


def _rot_dcoeffs(a2):
    """Termwise derivatives (d/da2) of the _rot_coeffs truncations."""
    dsinc = -1.0 / 6.0 + a2 / 60.0
    dvers = -1.0 / 24.0 + a2 / 360.0
    vers = 0.5 * (1.0 - a2 * (1.0 / 12.0) * (1.0 - a2 * (1.0 / 30.0)))
    dcos = -(vers + a2 * dvers)
    return dcos, dsinc, dvers


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _rodrigues3v(u, r):
    """fused3d._rodrigues3 on 3-tuples (primal, shared with the tangent)."""
    a2 = _dot(*r, *r)
    cos, sinc, vers = _rot_coeffs(a2)
    c = _cross(*r, *u)
    rdotu = _dot(*r, *u)
    return tuple(u[i] * cos + c[i] * sinc + r[i] * rdotu * vers
                 for i in range(3))


def _drodrigues3(u, du, r, dr):
    """Differential of the polynomial Rodrigues map in (u, rho)."""
    a2 = _dot(*r, *r)
    cos, sinc, vers = _rot_coeffs(a2)
    dcos, dsinc, dvers = _rot_dcoeffs(a2)
    da2 = 2.0 * _dot(*r, *dr)
    c = _cross(*r, *u)
    dc = tuple(p + q for p, q in zip(_cross(*dr, *u), _cross(*r, *du)))
    rdotu = _dot(*r, *u)
    drdotu = _dot(*dr, *u) + _dot(*r, *du)
    return tuple(
        du[i] * cos + dc[i] * sinc
        + dr[i] * rdotu * vers + r[i] * drdotu * vers
        + da2 * (u[i] * dcos + c[i] * dsinc + r[i] * rdotu * dvers)
        for i in range(3))


def _dyn_step_body3(op: str, box, eval_h, zero, ds, limit, offset=0.0):
    """Shared per-step fori body over the 16-slot 3-D dynamic carry.

    The paraxial twin of :func:`kernels.fused3d._step_body3`: ONE
    definition of the kinematic step + both hand-derived launch tangents
    (module docstring); ``eval_h(pos3) -> (n, gx, gy, gz, hxx, hxy, hxz,
    hyy, hyz, hzz)`` is the medium seam.  ``offset`` is the global step
    count before
    this launch (resume-chained kernels); the caustic bookkeeping
    (past-source guard, focus locator step index) runs on the GLOBAL
    step so segmented chains match one unsegmented launch.
    """
    second_order = op in ("op6", "op8")
    rk2 = op in ("op2", "op6")
    limx_i, limx_s, limy_i, limy_s, limz_i, limz_s = [float(v) for v in box]

    def hdot(h, v):
        hxx, hxy, hxz, hyy, hyz, hzz = h
        return (hxx * v[0] + hxy * v[1] + hxz * v[2],
                hxy * v[0] + hyy * v[1] + hyz * v[2],
                hxz * v[0] + hyz * v[1] + hzz * v[2])

    def tangent_quants(g, h, u, dp, du):
        """(dn, dg, dt) for the transverse-force t = g - (g.u) u."""
        dn = _dot(*g, *dp)
        dg = hdot(h, dp)
        gu = _dot(*g, *u)
        dgu = _dot(*dg, *u) + _dot(*g, *du)
        dt = tuple(dg[i] - dgu * u[i] - gu * du[i] for i in range(3))
        return dn, dg, dt

    def body(i, carry):
        gi = i.astype(jnp.float32) + offset
        in_limit = gi < limit
        # the scan tier labels steps 1-based (engine/dynamic3d feeds
        # arange(1, ...)); the post-step det below belongs to step gi+1
        # in that convention — admit and record with the SAME labels or
        # the focus locator's first admitted sample is one step late
        # (which flips the argmin for rays refocusing near the end)
        gstep = gi + 1.0
        (pos, u, dpa, dua, dpb, dub, n, g, h, tt, dsim, active,
         sgn, kmah, mind, minstep) = carry

        gu = _dot(*g, *u)
        t = tuple(g[k] - gu * u[k] for k in range(3))
        if second_order:
            half_fac = ds * ds * 0.5 / n
            D = tuple(u[k] * ds + t[k] * half_fac for k in range(3))
        else:
            D = tuple(u[k] * ds for k in range(3))
        pos2 = tuple(pos[k] + D[k] for k in range(3))
        out10 = eval_h(pos2)
        n2, g2 = out10[0], out10[1:4]
        h2 = out10[4:]

        def advance(dp, du):
            dn, dg, dt = tangent_quants(g, h, u, dp, du)
            if second_order:
                dD = tuple(du[k] * ds
                           + (dt[k] / (2.0 * n)
                              - t[k] * dn / (2.0 * n * n)) * ds * ds
                           for k in range(3))
            else:
                dD = tuple(du[k] * ds for k in range(3))
            dp2 = tuple(dp[k] + dD[k] for k in range(3))
            dn2 = _dot(*g2, *dp2)
            dg2 = hdot(h2, dp2)

            if rk2:
                inv_n = 1.0 / n
                k1 = tuple(ds * t[k] * inv_n for k in range(3))
                dk1 = tuple(ds * (dt[k] * inv_n
                                  - t[k] * dn * inv_n * inv_n)
                            for k in range(3))
                r1 = _cross(*u, *k1)
                dr1 = tuple(p + q for p, q in zip(
                    _cross(*du, *k1), _cross(*u, *dk1)))
                um = _rodrigues3v(u, r1)
                dum = _drodrigues3(u, du, r1, dr1)
                inv_n2 = 1.0 / n2
                gum = _dot(*g2, *um)
                t2v = tuple(g2[k] - gum * um[k] for k in range(3))
                dgum = _dot(*dg2, *um) + _dot(*g2, *dum)
                dt2 = tuple(dg2[k] - dgum * um[k] - gum * dum[k]
                            for k in range(3))
                k2 = tuple(ds * t2v[k] * inv_n2 for k in range(3))
                dk2 = tuple(ds * (dt2[k] * inv_n2
                                  - t2v[k] * dn2 * inv_n2 * inv_n2)
                            for k in range(3))
                r2 = _cross(*um, *k2)
                dr2 = tuple(p + q for p, q in zip(
                    _cross(*dum, *k2), _cross(*um, *dk2)))
                rho = tuple((r1[k] + r2[k]) * 0.5 for k in range(3))
                drho = tuple((dr1[k] + dr2[k]) * 0.5 for k in range(3))
                u2 = _rodrigues3v(u, rho)
                du2 = _drodrigues3(u, du, rho, drho)
            else:
                half = ds * 0.5
                s = tuple(n * u[k] + (g[k] + g2[k]) * half
                          for k in range(3))
                dsv = tuple(dn * u[k] + n * du[k]
                            + (dg[k] + dg2[k]) * half
                            for k in range(3))
                inv = jax.lax.rsqrt(_dot(*s, *s))
                u2 = tuple(s[k] * inv for k in range(3))
                proj = _dot(*dsv, *u2)
                du2 = tuple((dsv[k] - proj * u2[k]) * inv
                            for k in range(3))
            return dp2, du2, u2

        dpa2, dua2, u2 = advance(dpa, dua)
        dpb2, dub2, _ = advance(dpb, dub)

        if second_order:
            dist = jnp.sqrt(_dot(*D, *D))
            ntt = tt + dist * (n + n2) * 0.5
            ndsim = dsim + dist
        else:
            ntt = tt + ds * (n + n2) * 0.5
            ndsim = dsim + ds

        det = _dot(*_cross(*dpa2, *dpb2), *u2)
        s_new = jnp.sign(det)
        flip = ((active > 0.5) & (sgn != 0.0) & (s_new != 0.0)
                & (s_new != sgn))
        kmah2 = kmah + jnp.where(flip, zero + 1.0, zero)
        sgn2 = jnp.where((active > 0.5) & (s_new != 0.0), s_new, sgn)
        # in_limit gate: chained segments can overrun `limit` (n_seg *
        # segment > steps); the frozen iterations still COMPUTE det of
        # the hypothetical next step, which must not reach the locator
        past_src = gstep > 4.0
        better = ((active > 0.5) & in_limit & past_src
                  & (jnp.abs(det) < mind))
        mind2 = jnp.where(better, jnp.abs(det), mind)
        minstep2 = jnp.where(better, zero + gstep, minstep)

        outb = ((pos2[0] > limx_s) | (pos2[0] < limx_i)
                | (pos2[1] > limy_s) | (pos2[1] < limy_i)
                | (pos2[2] > limz_s) | (pos2[2] < limz_i))
        keep = (active > 0.5) & in_limit

        def sel(new, old):
            if isinstance(new, tuple):
                return tuple(jnp.where(keep, a, b)
                             for a, b in zip(new, old))
            return jnp.where(keep, new, old)

        nactive = jnp.where(keep & outb, zero, active)
        return (sel(pos2, pos), sel(u2, u),
                sel(dpa2, dpa), sel(dua2, dua),
                sel(dpb2, dpb), sel(dub2, dub),
                sel(n2, n), sel(g2, g), sel(h2, h),
                sel(ntt, tt), sel(ndsim, dsim), nactive,
                sel(sgn2, sgn), sel(kmah2, kmah), mind2, minstep2)

    return body


def _make_dyn_kernel3(field: str, op: str, steps: int, box):
    """Fused 3-D dynamic kernel: kinematics + two hand tangents."""
    nag = _field3_fn_h(field)

    def kernel(x_ref, y_ref, z_ref, ux_ref, uy_ref, uz_ref,
               e1x_ref, e1y_ref, e1z_ref, e2x_ref, e2y_ref, e2z_ref,
               ds_ref, *out_refs):
        pos = (x_ref[...], y_ref[...], z_ref[...])
        u = (ux_ref[...], uy_ref[...], uz_ref[...])
        dua = (e1x_ref[...], e1y_ref[...], e1z_ref[...])
        dub = (e2x_ref[...], e2y_ref[...], e2z_ref[...])
        zero = jnp.zeros_like(pos[0])
        z3 = (zero, zero, zero)
        ds = ds_ref[0]
        limit = ds_ref[1]

        def eval_h(p):
            return nag(p[0], p[1], p[2])

        body = _dyn_step_body3(op, box, eval_h, zero, ds, limit)
        out10 = eval_h(pos)
        n0, g0, h0 = out10[0], out10[1:4], out10[4:]
        big = zero + jnp.float32(np.finfo(np.float32).max)
        carry0 = (pos, u, z3, dua, z3, dub, n0, g0, h0, zero, zero,
                  zero + 1.0, zero, zero, big, zero)
        final = jax.lax.fori_loop(0, steps, body, carry0)
        (fpos, fu, fdpa, _, fdpb, _, fn, _, _, ftt, fdsim, fact,
         _, fkmah, fmind, fminstep) = final
        fdet = _dot(*_cross(*fdpa, *fdpb), *fu)
        outs = fpos + fu + (ftt, fdsim, fact, fdet, fkmah, fn,
                            fmind, fminstep)
        for ref, val in zip(out_refs, outs):
            ref[...] = val

    return kernel


class Dyn3Final(NamedTuple):
    """Final-state bundle of a fused 3-D dynamic run (arrays length R)."""

    pos: Any          # (R, 3)
    tangent: Any      # (R, 3)
    traveltime: Any   # (R,)
    dist_sim: Any     # (R,)
    active: Any       # (R,) bool
    detq: Any         # (R,) paraxial det Q (frame-free triple product)
    kmah: Any         # (R,) int32
    n: Any            # (R,)
    min_absdet: Any   # (R,)
    min_absdet_step: Any  # (R,) int32


@functools.partial(jax.jit, static_argnames=("field", "op", "steps", "box",
                                             "block_rays", "interpret"))
def dynamic3d_trace_final(pos0, dir0, delta_s, *, field: str, op: str,
                          steps: int, box, block_rays: int = 1024,
                          interpret: bool | None = None,
                          step_limit=None) -> Dyn3Final:
    """Run ``steps`` fused 3-D DYNAMIC steps; return a Dyn3Final.

    Point-source launch tangents (dpos = 0, du = the transverse frame
    vectors e1/e2 of engine/dynamic3d._transverse_frame), so ``detq``,
    ``kmah`` and the focus locator match ``trace_dynamic3``'s exact-jvp
    metrics (tests/test_dynamic_kernel3.py).
    """
    from raytracing_tpu.engine.dynamic3d import _transverse_frame

    if field not in DYN3_FUSED_FIELDS:
        raise ValueError(f"fused 3-D dynamic kernel supports fields "
                         f"{DYN3_FUSED_FIELDS}, got {field!r}")
    if op not in DYN3_FUSED_OPS:
        raise ValueError(f"fused 3-D dynamic kernel supports ops "
                         f"{DYN3_FUSED_OPS}, got {op!r}")
    if len(box) != 6:
        raise ValueError(f"box must be 6 floats, got {box!r}")
    r = pos0.shape[0]
    if r % block_rays:
        raise ValueError(f"rays {r} not a multiple of block {block_rays}")
    dir0 = jnp.asarray(dir0, jnp.float32)
    dir0 = dir0 / jnp.linalg.norm(dir0, axis=-1, keepdims=True)
    pos0 = jnp.asarray(pos0, jnp.float32)
    e1, e2 = _transverse_frame(dir0)
    if step_limit is None:
        step_limit = steps
    ds = jnp.stack([jnp.asarray(delta_s, jnp.float32),
                    jnp.asarray(step_limit, jnp.float32)])

    kernel = _make_dyn_kernel3(field, op, steps,
                               tuple(float(v) for v in box))
    comps = [a[:, k] for a in (pos0, dir0, e1, e2) for k in range(3)]
    (fx, fy, fz, fux, fuy, fuz, tt, dsim, act, det, kmah, n,
     mind, minstep) = ray_block_call(kernel, comps, ds, 14,
                                     interpret=interpret,
                                     name=f"dynamic3d_{op}_{field}")
    return Dyn3Final(
        pos=jnp.stack([fx, fy, fz], -1),
        tangent=jnp.stack([fux, fuy, fuz], -1),
        traveltime=tt, dist_sim=dsim, active=act > 0.5, detq=det,
        kmah=kmah.astype(jnp.int32), n=n, min_absdet=mind,
        min_absdet_step=minstep.astype(jnp.int32))
