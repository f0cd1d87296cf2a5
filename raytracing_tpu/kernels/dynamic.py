"""Fused dynamic integrator: kinematics + paraxial tangent in registers.

The dynamic tier (engine/dynamic.py) propagates d(state)/d(theta0) with
``jax.jvp`` through the scan engine — exact, but at scan-tier speed.
``jvp`` does not cross ``pallas_call``, so the kernel tier needs the tangent
recurrences written BY HAND.  This module is that: the closed-form
directional derivative of each fused step map, carried per ray alongside
the kinematic state, for the analytic fields x the smooth op subset
(op1/op2/op6/op8 — the golden ops are excluded by design: their cost
minimizer is piecewise constant in theta0, so their true tangent is zero
almost everywhere, engine/dynamic.py "Solver caveat").

What rides in the carry per ray (beyond kernels/fused.py's):

* ``dpx, dpy`` — d(pos)/d(theta0), the paraxial position tangent;
* ``dth``     — d(angle)/d(theta0).  The unit tangent's derivative is
  recovered as ``du = dth * u_perp`` (u_perp = (-uy, ux)) — one scalar
  instead of a 2-vector, and the normalization constraint u.du = 0 holds
  by construction;
* ``sgn, kmah`` — running sign of the transverse spreading
  ``q = dpos . u_perp`` and the KMAH caustic count (carried as f32,
  like every flag of the kernels/fused.py carry).

The recurrences need the field's HESSIAN (d(grad n) = H . dpos), which the
kinematic kernels never touch; ``_field_fn_h`` extends the inlined
analytic fields with their closed-form second derivatives — the quantity
the reference scaffolds as bicubic Hessian splines and never uses
(RT_bench.py:459-462, its only dead code).

Tangent maps, derived from kernels/fused.py's step algebra (same symbols):

* 1st-order position (op1/op2):  D = u ds
      dD = dth * u_perp * ds
* 2nd-order position (op6/op8):  D = u ds + t ds^2/(2n),  t = g - (g.u)u
      dt = dg - ((dg.u) + (g.du)) u - (g.u) du
      dD = du ds + (dt / (2n) - t dn / (2n^2)) ds^2
  with dn = g . dpos, dg = H . dpos, du = dth u_perp.
* momentum-impulse angle (op1/op8):  s = n u + (g + g2) ds/2, u' = s/|s|
      dth' = (ds_vec . u'_perp) / |s|
      ds_vec = dn u + n du + (dg + dg2) ds/2
  (the component of ds_vec along u' cancels in the normalization).
* RK2 angle (op2/op6):  k1 = ds (u x g)/n, u1 = rot(u, k1),
  k2 = ds (u1 x g2)/n2, u' = rot(u, (k1+k2)/2)
      dk1 = ds [ (du x g + u x dg)/n - (u x g) dn/n^2 ]
      du1 = (dth + dk1) u1_perp
      dk2 = ds [ (du1 x g2 + u1 x dg2)/n2 - (u1 x g2) dn2/n2^2 ]
      dth' = dth + (dk1 + dk2)/2
  where a x b = ax by - ay bx and u_perp x g = -(u . g).

Launch tangent: the source point is FIXED (dpos0 = 0, dth0 = 1) — the
point-source paraxial basis, same as engine/dynamic.py's jvp of launch.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu.config import THCK_PARAM
from raytracing_tpu.kernels.fused import _launch_state, strat_tables
from raytracing_tpu.kernels.launch import ray_block_call
from raytracing_tpu.media.fields import _sigmoid

#: analytic fields with inlined Hessians
DYN_FUSED_FIELDS = ("fisheye", "vert_heterogeneous", "interface")
#: smooth fused ops whose hand tangent is implemented
DYN_FUSED_OPS = ("op1", "op2", "op6", "op8")

_SQRT2 = 1.4142135623730951


def _field_fn_h(field: str):
    """n, grad n AND the Hessian of n, inlined (media/fields.py twins).

    Returns ``f(x, y) -> (n, gx, gy, hxx, hxy, hyy)`` with closed-form
    second derivatives — checked against jax.hessian of the field in
    tests/test_dynamic_kernel.py.
    """
    if field == "fisheye":
        def f(x, y):
            n = 1.0 / (1.0 + x * x + y * y)
            n2 = n * n
            c = -2.0 * n2
            n3_8 = 8.0 * n2 * n
            gx, gy = c * x, c * y
            hxx = c + n3_8 * x * x
            hxy = n3_8 * x * y
            hyy = c + n3_8 * y * y
            return n, gx, gy, gx, gy, hxx, hxy, hxy, hyy
    elif field == "vert_heterogeneous":
        def f(x, y):
            n = 1.0 / (18.0 + 2.0 * y)
            zero = jnp.zeros_like(x)
            n2 = n * n
            gy = -2.0 * n2
            return n, zero, gy, zero, gy, zero, zero, zero, 8.0 * n2 * n
    else:  # interface
        def f(x, y):
            # overflow-safe two-branch logistic (media/fields._sigmoid):
            # the literal 1/(1+exp(-t)) overflows f32 for t < ~-88, and
            # while the hand-derived tangent here never jvp's through it,
            # anyone autodiffing or copying this helper would inherit the
            # inf/inf NaN the fields module already fixed (PARITY.md #30)
            sig = _sigmoid(y / THCK_PARAM)
            n = _SQRT2 - (_SQRT2 - 1.0) * sig
            zero = jnp.zeros_like(x)
            d = sig * (1.0 - sig)
            gy = -(_SQRT2 - 1.0) * d / THCK_PARAM
            hyy = (-(_SQRT2 - 1.0) * d * (1.0 - 2.0 * sig)
                   / (THCK_PARAM * THCK_PARAM))
            return n, zero, gy, zero, gy, zero, zero, zero, hyy
    return f


def _strat_nag_h(tables_ref, y0: float, inv_hy: float, ny: int):
    """n / grad / n-tangent / Hessian gathered from the 1-D cell tables.

    The dynamic twin of :func:`kernels.fused._strat_nag` (same flat
    channel-major table from ``strat_tables``), extended with what the
    paraxial recurrences need:

    * ``hyy`` — the exact in-cell second derivative of the evaluated
      surface, i.e. the live form of the reference's dead Hessian splines
      (RT_bench.py:459-462);
    * ``(gnx, gny)`` — the derivative of the *n channel itself*, which for
      the PARITY family (6 channels) differs from the ray-equation
      gradient: n is the bilinear of Zy while g is a separate cubic
      (media/spline.StratifiedGridMedium), so the scan tier's exact jvp
      differentiates n as (Zy[i+1] - Zy[i]) * inv_hy.  The C1 family
      (4 channels) is consistent by construction: gn == g.

    Returns ``f(x, y) -> (n, gx, gy, gnx, gny, hxx, hxy, hyy)``.
    """
    chans = tables_ref.shape[0] // ny

    def nag(x, y):
        fy = jnp.clip((y - y0) * inv_hy, 0.0, float(ny - 1))
        iy = jnp.minimum(jnp.floor(fy), float(ny - 2))
        uy = fy - iy
        ii = iy.astype(jnp.int32)
        vals = [tables_ref[ii + c * ny] for c in range(chans)]
        zero = jnp.zeros_like(x)
        if chans == 4:
            # C1: one cubic serves n, dn/dy AND d2n/dy2 (media/c1.py)
            c0, c1, c2, c3 = vals
            n = c0 + uy * (c1 + uy * (c2 + uy * c3))
            gy = (c1 + uy * (2.0 * c2 + uy * 3.0 * c3)) * inv_hy
            hyy = (2.0 * c2 + 6.0 * c3 * uy) * (inv_hy * inv_hy)
            return n, zero, gy, zero, gy, zero, zero, zero, hyy
        # parity: bilinear n + cubic gy cells (gy already in physical
        # units, media/spline.py:137 — only the chain rule d(uy)/dy
        # = inv_hy enters its derivative)
        zlo, zhi, c0, c1, c2, c3 = vals
        n = (1.0 - uy) * zlo + uy * zhi
        gy = c0 + uy * (c1 + uy * (c2 + uy * c3))
        hyy = (c1 + uy * (2.0 * c2 + uy * 3.0 * c3)) * inv_hy
        gny = (zhi - zlo) * inv_hy
        return n, zero, gy, zero, gny, zero, zero, zero, hyy

    return nag


def _make_dynamic_kernel(field: str, op: str, steps: int, box, strat=None):
    """Build the fused dynamic step kernel (kernels/fused.py structure).

    ``strat`` = (y0, inv_hy, ny) switches the field evaluation from the
    inlined analytic Hessian twins to the 1-D cell tables
    (``_strat_nag_h``), and splits the n-channel tangent from the
    ray-equation gradient (the parity stratified family is gradient-
    inconsistent by reference design, docs/PARITY.md).
    """
    # field values carried between steps: one uniform 9-channel layout
    # (n, gx, gy, gnx, gny, hxx, hxy, hyx, hyy) — gn is the n-channel's
    # OWN derivative (parity stratified/2-D tables are gradient-
    # inconsistent by reference design, docs/PARITY.md), and the Hessian
    # rows are independent (2-D parity tables fit gx and gy as separate
    # bicubics, so d(gx)/dy != d(gy)/dx in general)
    nf = 9
    second_order = op in ("op6", "op8")
    rk2 = op in ("op2", "op6")
    limx_i, limx_s, limy_i, limy_s = [float(v) for v in box]

    def kernel_impl(nag, *refs):
        (x_ref, y_ref, ux_ref, uy_ref, ds_ref), out_refs = refs[:5], refs[5:]
        x, y = x_ref[...], y_ref[...]
        ux, uy = ux_ref[...], uy_ref[...]
        zero = jnp.zeros_like(x)
        ds = ds_ref[0]
        limit = ds_ref[1]
        cx0 = cy0 = tt0 = dsim0 = sgn0 = kmah0 = zero
        kdx0 = kdy0 = kdt0 = ktt0 = dpx0 = dpy0 = zero
        act0 = zero + 1.0
        dth0 = zero + 1.0

        def rot(ax, ay, d):
            # degree-5 small-angle rotation (kernels/fused.py RK2 note)
            d2 = d * d
            s = d * (1.0 - d2 * (1.0 / 6.0) * (1.0 - d2 * 0.05))
            c = 1.0 - d2 * 0.5 * (1.0 - d2 * (1.0 / 12.0))
            return ax * c - ay * s, ax * s + ay * c

        def kadd(old, inc, comp):
            # Kahan on a TRUE increment (engine/dynamic.kadd): kills the
            # per-step carry rounding of the paraxial accumulators, whose
            # ~sqrt(steps) random walk was the measured 2.3e-5 amplitude
            # floor (docs/PRECISION.md round-4 addendum)
            y2 = inc - comp
            t = old + y2
            return t, (t - old) - y2

        def body(i, carry):
            in_limit = i.astype(jnp.float32) < limit
            x, y, cx, cy, ux, uy = carry[:6]
            fvals = carry[6:6 + nf]
            (tt, dsim, active, dpx, dpy, dth, sgn, kmah,
             kdx, kdy, kdt, ktt) = carry[6 + nf:]
            n, gx, gy, gnx, gny, hxx, hxy, hyx, hyy = fvals

            # tangent of the carried state at the step's start
            dn = gnx * dpx + gny * dpy
            dgx = hxx * dpx + hxy * dpy
            dgy = hyx * dpx + hyy * dpy
            # du = dth * u_perp
            dux = -dth * uy
            duy = dth * ux

            # -- position advance + its tangent ---------------------------
            if second_order:
                gdotu = gx * ux + gy * uy
                inv_n = 1.0 / n
                half_fac = ds * ds * 0.5 * inv_n
                txx = gx - gdotu * ux
                txy = gy - gdotu * uy
                ddx = ux * ds + txx * half_fac
                ddy = uy * ds + txy * half_fac
                dgdotu = dgx * ux + dgy * uy + gx * dux + gy * duy
                dtx = dgx - dgdotu * ux - gdotu * dux
                dty = dgy - dgdotu * uy - gdotu * duy
                ddpx = (dux * ds
                        + (dtx - txx * dn * inv_n) * half_fac)
                ddpy = (duy * ds
                        + (dty - txy * dn * inv_n) * half_fac)
            else:
                ddx = ux * ds
                ddy = uy * ds
                ddpx = dux * ds
                ddpy = duy * ds
            # Kahan on the primal positions only: the tangents are smooth
            # O(q) quantities whose own roundoff never reaches the primal
            dx = ddx - cx
            nx2 = x + dx
            cx2 = (nx2 - x) - dx
            dy = ddy - cy
            ny2 = y + dy
            cy2 = (ny2 - y) - dy
            dpx2, kdx2 = kadd(dpx, ddpx, kdx)
            dpy2, kdy2 = kadd(dpy, ddpy, kdy)

            fvals2 = nag(nx2, ny2)
            n2, gx2, gy2, gnx2, gny2, hxx2, hxy2, hyx2, hyy2 = fvals2
            dn2 = gnx2 * dpx2 + gny2 * dpy2
            dgx2 = hxx2 * dpx2 + hxy2 * dpy2
            dgy2 = hyx2 * dpx2 + hyy2 * dpy2

            # -- angle update + its tangent -------------------------------
            if rk2:
                inv_n = 1.0 / n
                inv_n2 = 1.0 / n2
                cross1 = ux * gy - uy * gx
                k1 = ds * cross1 * inv_n
                ux1, uy1 = rot(ux, uy, k1)
                cross2 = ux1 * gy2 - uy1 * gx2
                k2 = ds * cross2 * inv_n2
                nux, nuy = rot(ux, uy, (k1 + k2) * 0.5)
                # tangent: du x g = -dth (u.g); u x dg elementwise
                dcross1 = (-dth * (ux * gx + uy * gy)
                           + ux * dgy - uy * dgx)
                dk1 = ds * (dcross1 - cross1 * dn * inv_n) * inv_n
                dth1 = dth + dk1
                dcross2 = (-dth1 * (ux1 * gx2 + uy1 * gy2)
                           + ux1 * dgy2 - uy1 * dgx2)
                dk2 = ds * (dcross2 - cross2 * dn2 * inv_n2) * inv_n2
                ndth, kdt2 = kadd(dth, (dk1 + dk2) * 0.5, kdt)
            else:
                half = ds * 0.5
                sx = n * ux + (gx + gx2) * half
                sy = n * uy + (gy + gy2) * half
                inv = jax.lax.rsqrt(sx * sx + sy * sy)
                nux = sx * inv
                nuy = sy * inv
                dsx = dn * ux + n * dux + (dgx + dgx2) * half
                dsy = dn * uy + n * duy + (dgy + dgy2) * half
                # dth' = (ds_vec . u'_perp) |s|^-1 — recomputed fresh,
                # not accumulated: no compensation applies
                ndth = (dsx * (-nuy) + dsy * nux) * inv
                kdt2 = kdt

            if second_order:
                dist = jnp.sqrt(ddx * ddx + ddy * ddy)
                ntt, ktt2 = kadd(tt, dist * (n + n2) * 0.5, ktt)
                ndsim = dsim + dist
            else:
                ntt, ktt2 = kadd(tt, ds * (n + n2) * 0.5, ktt)
                ndsim = dsim + ds

            # -- caustic bookkeeping (engine/dynamic.py body) -------------
            q2 = dpx2 * (-nuy) + dpy2 * nux
            s_new = jnp.sign(q2)

            out = ((nx2 > limx_s) | (nx2 < limx_i)
                   | (ny2 > limy_s) | (ny2 < limy_i))
            keep = (active > 0.5) & in_limit

            flip = keep & (sgn != 0.0) & (s_new != 0.0) & (s_new != sgn)
            nkmah = kmah + jnp.where(flip, 1.0, 0.0)
            nsgn = jnp.where(keep & (s_new != 0.0), s_new, sgn)

            def sel(new, old):
                return jnp.where(keep, new, old)

            nactive = jnp.where(keep & out, zero, active)
            return ((sel(nx2, x), sel(ny2, y), sel(cx2, cx), sel(cy2, cy),
                     sel(nux, ux), sel(nuy, uy))
                    + tuple(sel(new, old)
                            for new, old in zip(fvals2, fvals))
                    + (sel(ntt, tt), sel(ndsim, dsim), nactive,
                       sel(dpx2, dpx), sel(dpy2, dpy), sel(ndth, dth),
                       nsgn, nkmah,
                       sel(kdx2, kdx), sel(kdy2, kdy), sel(kdt2, kdt),
                       sel(ktt2, ktt)))

        fvals0 = nag(x, y)
        carry0 = ((x, y, cx0, cy0, ux, uy) + tuple(fvals0)
                  + (tt0, dsim0, act0, dpx0, dpy0, dth0, sgn0, kmah0,
                     kdx0, kdy0, kdt0, ktt0))
        final = jax.lax.fori_loop(0, steps, body, carry0)
        fx, fy, _, _, fux, fuy = final[:6]
        fn = final[6]
        (ftt, fdsim, fact, fdpx, fdpy,
         fdth, _, fkmah) = final[6 + nf:6 + nf + 8]
        outs = (fx, fy, fux, fuy, fn, ftt, fdsim, fact, fdpx, fdpy,
                fdth, fkmah)
        for ref, val in zip(out_refs, outs):
            ref[...] = val

    if strat is None:
        nag_a = _field_fn_h(field)

        def kernel(*refs):
            kernel_impl(nag_a, *refs)
    else:
        y0, inv_hy, ny = strat

        def kernel(tables_ref, *refs):
            kernel_impl(_strat_nag_h(tables_ref, y0, inv_hy, ny), *refs)

    return kernel


class DynFinal(NamedTuple):
    """Final kinematic + paraxial state of a fused dynamic run."""

    pos: Any          # (R, 2)
    tangent: Any      # (R, 2) unit tangent (cos/sin of the exit angle)
    n: Any            # (R,)   index at the final position
    traveltime: Any   # (R,)
    dist_sim: Any     # (R,)
    active: Any       # (R,) bool
    q: Any            # (R,)   transverse spreading dpos . u_perp
    dtheta: Any       # (R,)   d(angle)/d(theta0)
    kmah: Any         # (R,) int32 caustic count

    def amplitude(self, n0):
        from raytracing_tpu.engine.dynamic import spreading_amplitude
        return spreading_amplitude(self.q, self.n, n0)


@functools.partial(jax.jit, static_argnames=("field", "op", "steps", "box",
                                             "block_rays", "interpret"))
def dynamic_trace_final(pos0, theta0, delta_s, *, field: str, op: str,
                        steps: int, box, block_rays: int = 4096,
                        interpret: bool | None = None,
                        step_limit=None) -> DynFinal:
    """Fused dynamic trace: kinematics + exact-map paraxial tangent.

    Same launch contract as :func:`kernels.fused.fused_trace_final`; the
    result adds ``q``/``dtheta``/``kmah``, from which
    :func:`engine.dynamic.spreading_amplitude` and
    :func:`engine.dynamic.transmission_loss_db` derive the point-source
    field per ray.  The scan tier (:func:`engine.dynamic.trace_dynamic`)
    remains the history-mode / sampled-media / custom-field path; this
    kernel is the million-ray metrics engine for the analytic fields.
    """
    if field not in DYN_FUSED_FIELDS:
        raise ValueError(f"dynamic kernel supports fields {DYN_FUSED_FIELDS},"
                         f" got {field!r}")
    if op not in DYN_FUSED_OPS:
        raise ValueError(
            f"dynamic kernel supports ops {DYN_FUSED_OPS} (the golden ops' "
            f"tangent is zero a.e. — engine/dynamic.py), got {op!r}")
    x, y, ux, uy, ds = _launch_state(pos0, theta0, delta_s, step_limit,
                                     steps, pos0.shape[0], block_rays)
    kernel = _make_dynamic_kernel(field, op, steps, box)
    outs = ray_block_call(kernel, [x, y, ux, uy], ds, 12,
                          interpret=interpret, name=f"dynamic_{op}_{field}")
    return _pack_dyn_final(outs)


def _pack_dyn_final(outs) -> DynFinal:
    (fx, fy, fux, fuy, fn, tt, dsim, act, dpx, dpy, dth, kmah) = outs
    # q from the carried tangent and the exit direction (engine/dynamic.py
    # computes the same contraction after its scan)
    q = dpx * (-fuy) + dpy * fux
    return DynFinal(
        pos=jnp.stack([fx, fy], axis=-1),
        tangent=jnp.stack([fux, fuy], axis=-1),
        n=fn, traveltime=tt, dist_sim=dsim, active=act > 0.5, q=q,
        dtheta=dth, kmah=kmah.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("op", "steps", "box",
                                             "block_rays", "interpret"))
def dynamic_trace_final_strat(pos0, theta0, delta_s, medium, *, op: str,
                              steps: int, box, block_rays: int = 4096,
                              interpret: bool | None = None,
                              step_limit=None) -> DynFinal:
    """Fused dynamic trace through a SAMPLED stratified medium.

    The production case for the dynamic/eigenray tier: serve
    ``/v1/eigenrays`` posts measured profiles, whose paraxial tangents
    previously only ran at scan-tier speed (jvp through the gathered
    spline).  The Hessian each tangent needs is exactly the in-cell
    second derivative the 1-D cell tables already encode — the live form
    of the reference's dead Hessian splines (RT_bench.py:459-462) — so
    the kernel evaluates it from the same per-ray gathers that fetch n and
    dn/dy (``_strat_nag_h``).  Accepts the parity
    ``media.spline.StratifiedGridMedium`` (6 channels; the n-channel
    tangent is split from the ray-equation gradient to match the scan
    tier's exact jvp of the inconsistent pair) and the consistent
    ``media.c1.C1StratifiedMedium`` (4 channels).
    """
    if op not in DYN_FUSED_OPS:
        raise ValueError(
            f"dynamic kernel supports ops {DYN_FUSED_OPS} (the golden ops' "
            f"tangent is zero a.e. — engine/dynamic.py), got {op!r}")
    x, y, ux, uy, ds = _launch_state(pos0, theta0, delta_s, step_limit,
                                     steps, pos0.shape[0], block_rays)
    tables, strat = strat_tables(medium)
    kernel = _make_dynamic_kernel("stratified", op, steps, box, strat=strat)
    outs = ray_block_call(kernel, [x, y, ux, uy], ds, 12, tables=(tables,),
                          interpret=interpret, name=f"dynamic_{op}_strat")
    return _pack_dyn_final(outs)
