"""Fused golden-section step kernels: op5/op9 (isotropic) and op10/op11
(anisotropic momentum — the v0.3.0 method, SURVEY.md §7.6's centerpiece).

Each integration step runs a complete branchless golden-section minimization
of the momentum-impulse cost (RT_bench.py:573-600, 676-764) *inside* the
Pallas kernel: bracket state lives in registers, one cost evaluation per
iteration, everything in registers.  The reference pays ~70 scipy-free Python
cost evaluations per ray per step on a CPU; here a million rays step
together.

Transcendental-free golden loop: the bracket always starts at theta +- pi/2
(DELTA_G, RT_bench.py:64), so the bracket length after k shrinks is the
*compile-time constant* pi * r^k — every probe angle is the previous probe
rotated by a constant.  The kernel therefore carries probe *unit vectors*
and applies constant rotations (4 mul + 2 add) instead of cos/sin per cost
evaluation; the probed angle sequence is identical to the reference's to
f32 rounding.  The angles themselves ride along as cheap +-constant updates
for the final midpoint.

The production default dispenses with the search entirely: the cost has a
CLOSED-FORM minimizer (iso, exact) / seed (aniso, O(ds) + Newton polish to
roundoff) — see GOLD_SEED_ITERS.  The bracket schedule above remains the
reference-parity mode (``polish=0``) and an A/B option (``gold_iters>0``).

The isotropic cost is exactly the gamma=1 limit of the anisotropic momentum
cost (moments reduce to n*(cos t, sin t)), so op5/op9 are op10/op11 with
gamma=1 — one kernel family, four ops (+ the op10n/op11n Newton extensions).

Like ``fused.py``, the kernels optionally gather n / dn/dy from a
``StratifiedGridMedium``'s cell tables (the reference's sampled production
medium) and carry a Welford tracker of the anisotropic horizontal momentum
m_x (RT_bench.py:957-958) for on-device CV oracles — which is what lets the
DELTA_S sweep run the aniso scenario at kernel speed.
"""
from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from raytracing_tpu.config import DELTA_G, GOLD_RATIO, gold_tol, golden_iters
from raytracing_tpu.kernels.fused import (_custom_nag, _field_fn, _strat_nag,
                                          strat_tables)
from raytracing_tpu.kernels.launch import ray_block_call

GOLDEN_OPS = {"op5": ("curv", "golden"), "op9": ("t2", "golden"),
              "op10": ("curv", "golden"), "op11": ("t2", "golden"),
              "op10n": ("curv", "newton"), "op11n": ("t2", "newton")}

#: Default Newton polish steps appended to the golden bracket.  The f32
#: bracket alone localizes the angle to ~1.7e-4 rad (gold_tol), which random
#: walks the conserved momentum to a CV of ~1 % over a calibrated run — far
#: over the reference's 0.05 % acceptance bar (RT_bench.py:1310).  Two Newton
#: steps on the cost gradient (quadratic convergence from the bracket
#: midpoint) polish the angle to f32 roundoff, recovering the accuracy the
#: reference's sqrt(eps_f64)-tolerance golden delivers at float64 — same
#: minimizer, tighter tolerance.  docs/PARITY.md catalogs the divergence;
#: ``polish=0`` restores the pure-bracket schedule (the f32 parity mode the
#: engine-comparison tests pin).
GOLD_POLISH: int = 2
#: Bracket iterations when a bracket is requested alongside polish: 12
#: shrinks the pi-wide bracket to ~9.7e-3 rad — comfortably inside the
#: cost's quadratic basin, where two Newton steps land at roundoff.
#: Without polish the bracket must carry the full tolerance itself
#: (config.golden_iters -> 16 at f32).
GOLD_COARSE_ITERS: int = 12
#: ``iters == 0`` selects the CLOSED-FORM schedule (the production
#: default): the iso momentum cost (n2*ct - kx)^2 + (n2*st - ky)^2 over a
#: unit (ct, st) is a nearest-point-on-circle problem whose exact global
#: minimizer is k/|k| — one rsqrt, no search at all; the aniso cost's
#: manifold (n2*ct, n2*g^2*st)/cf is an ellipse shifted by the O(ds)
#: cf*h term, and normalize(kx, ky/g^2) is its ray-intersection seed,
#: O(ds) from the minimizer, which the Newton polish then takes to f32
#: roundoff.  Same minimizer the reference's pi-wide golden bracket
#: localizes (k sits within O(ds) of the incoming tangent, so branch
#: selection is unambiguous); docs/PARITY.md #26.
GOLD_SEED_ITERS: int = 0


def golden_schedule(polish: int | None = None, iters: int | None = None):
    """Resolve the (bracket iterations, polish steps) pair for a kernel.

    Defaults to the production schedule (closed-form seed + Newton polish,
    ``iters == 0`` — see GOLD_SEED_ITERS); ``polish=0`` selects the
    reference-parity pure-bracket schedule at the dtype tolerance
    (config.golden_iters); ``iters > 0`` with polish selects the coarse
    bracket + polish schedule (the round-3 intermediate, kept for A/B).
    """
    if polish is None:
        polish = GOLD_POLISH
    if iters is None:
        iters = GOLD_SEED_ITERS if polish else golden_iters(np.float32)
    return int(iters), int(polish)


def _rot_small(d):
    """(sin d, cos d) by degree-5/4 small-angle polynomials.

    Exact Taylor truncations (error d^7/5040 resp. d^6/720): below f32
    roundoff for |d| <~ 0.15, which covers every polish/Newton offset —
    and dodges two transcendentals per evaluation (the RK2-family trick,
    kernels/fused.py)."""
    d2 = d * d
    sd = d * (1.0 - d2 * (1.0 / 6.0) * (1.0 - d2 * 0.05))
    cd = 1.0 - d2 * 0.5 * (1.0 - d2 * (1.0 / 12.0))
    return sd, cd


def _asin_small(s):
    """asin by its odd series — below f32 roundoff for |s| <~ 0.15 (next
    term 15 s^7/336), covering every per-step angle change at calibrated
    steps.  Converts a closed-form minimizer's cross product with the
    incoming tangent into the angle increment without atan2."""
    s2 = s * s
    return s * (1.0 + s2 * ((1.0 / 6.0) + s2 * (3.0 / 40.0)))


def _golden_offsets(iters: int):
    """Per-iteration constants of the golden bracket schedule.

    Returns (c0_off, d0_off, deltas): the initial probe offsets from the
    launch angle and the fresh-probe rotation magnitude per iteration,
    delta_k = L0 * r^(k+2) with L0 = 2*DELTA_G.
    """
    r = GOLD_RATIO
    L0 = 2.0 * DELTA_G
    c0 = DELTA_G - L0 * r          # c = b - L*r, relative to ang
    d0 = -DELTA_G + L0 * r         # d = a + L*r
    deltas = [L0 * r ** (k + 2) for k in range(iters)]
    return c0, d0, deltas


def _make_kernel(field: str, op: str, steps: int, box, gold_iters_n: int,
                 curv_tol: float, strat=None, stats: bool = False,
                 custom=None, resume: bool = False,
                 skip: bool = False, polish: int = 0):
    """Build the fused golden/Newton step kernel.

    ``resume`` makes the kernel segmentable (mirrors fused._make_kernel):
    the full integration state (Kahan compensations, Welford stats) reads
    from input refs and writes back, with the global step offset at
    ``scal_ref[3]`` — the hook for segmented traces (engine/segmented.py).
    ``skip`` prepends a per-program liveness flag and bypasses all-frozen
    programs (see fused._make_kernel — the golden search makes skipped work
    ~40x a fused step, so the bypass pays off even faster here).  ``polish`` adds
    that many Newton steps on the cost gradient after the golden bracket,
    parameterized as a small-angle offset from the bracket midpoint
    (transcendental-free — see GOLD_POLISH).
    """
    if skip and not resume:
        raise ValueError("skip is a resume-kernel feature")
    if custom is not None:
        nag_analytic = _custom_nag(custom)
    elif strat is not None:
        nag_analytic = None
    else:
        nag_analytic = _field_fn(field)
    stepper, solver = GOLDEN_OPS[op]
    # op5/op9 are the gamma == 1 limit: the anisotropy factor folds to 1 at
    # build time, deleting the per-iteration sqrt and divides from the cost
    iso = op in ("op5", "op9")
    limx_i, limx_s, limy_i, limy_s = [float(v) for v in box]
    r = GOLD_RATIO
    c0_off, d0_off, _ = _golden_offsets(gold_iters_n)
    cos_c0, sin_c0 = math.cos(c0_off), math.sin(c0_off)
    cos_d0, sin_d0 = math.cos(d0_off), math.sin(d0_off)
    # final bracket width and the midpoint's (constant) offset from probe c:
    # c = b - L*r, m = (a+b)/2  ->  m - c = (r - 0.5) * L_final
    L_final = 2.0 * DELTA_G * r ** gold_iters_n
    mid_off = (r - 0.5) * L_final
    cos_m, sin_m = math.cos(mid_off), math.sin(mid_off)

    def kernel_impl(nag, *refs):
        live_ref = None
        if skip:
            live_ref, refs = refs[0], refs[1:]
        if resume:
            n_in = 8 + (3 if stats else 0)
            in_refs, scal_ref = refs[:n_in], refs[n_in]
            out_refs = refs[n_in + 1:]
            vals = [rf[...] for rf in in_refs]
            x, y, cx, cy, ang, tt, dsim, active = vals[:8]
            stats0 = tuple(vals[8:])
            zero = jnp.zeros_like(x)
        else:
            (x_ref, y_ref, ang_ref, scal_ref) = refs[:4]
            out_refs = refs[4:]
            x, y = x_ref[...], y_ref[...]
            ang = ang_ref[...]
            zero = jnp.zeros_like(x)
            cx = zero
            cy = zero
            tt = zero
            dsim = zero
            active = zero + 1.0
            stats0 = None
        ds = scal_ref[0]
        gamma = scal_ref[1]
        limit = scal_ref[2]   # traced step count; rays freeze after
        offset = scal_ref[3]  # applied steps before this segment (global)

        g2 = gamma * gamma
        inv_g2 = 1.0 / g2

        def coef_of(ct, st):
            if iso:
                return jnp.ones_like(ct)
            return jnp.sqrt((gamma * st) ** 2 + ct * ct)

        def mom_x(nv, cf, ct, st):
            # The reference's m_x = n*cf*ct*(1 - st^2*(g^2-1)/cf^2)
            # (RT_bench.py:215-228) collapses exactly: cf^2 - st^2*(g^2-1)
            # = g^2 st^2 + ct^2 - st^2 g^2 + st^2 = 1, so m_x = n*ct/cf.
            # Same algebra, but cancellation-free in f32 — the long form's
            # O(g^2) subtraction was the kernel tier's CV floor
            # (docs/PRECISION.md "the golden family's f32 conservation
            # floor").
            if iso:
                return nv * ct
            return nv * ct / cf

        def body(i, carry):
            in_limit = (i.astype(jnp.float32) + offset) < limit
            x, y, cx, cy, ang, ux, uy, n, gx, gy, tt, dsim, active = carry[:13]
            if stats:
                cnt, mean, m2 = carry[13:]
            # ---- position advance -------------------------------------
            gdotu = gx * ux + gy * uy
            txx = gx - gdotu * ux      # transverse gradient
            txy = gy - gdotu * uy
            if stepper == "t2":
                half_fac = ds * ds * 0.5 / n
                ddx = ux * ds + txx * half_fac
                ddy = uy * ds + txy * half_fac
                significant = zero < 1.0   # always update the angle
            else:  # curvature arc step (RT_bench.py:335-365)
                curv = jnp.sqrt(txx * txx + txy * txy) / n
                significant = curv >= curv_tol
                safe = jnp.where(significant, curv, 1.0)
                d = curv * ds
                sgn = jnp.where(gx * uy - gy * ux > 0, -1.0, 1.0)
                half = sgn * d * 0.5
                # small-angle rotation (_rot_small): |half| = curv*ds/2
                # stays well under ~0.2 at calibrated steps, so the
                # truncation is far below the golden bracket tolerance —
                # and dodges two VPU transcendentals per step
                sh, ch = _rot_small(half)
                coefc = 2.0 * sh * sgn / safe
                # cos(ang+half), sin(ang+half) by rotation of (ux, uy)
                arc_dx = (ux * ch - uy * sh) * coefc
                arc_dy = (ux * sh + uy * ch) * coefc
                ddx = jnp.where(significant, arc_dx, ux * ds)
                ddy = jnp.where(significant, arc_dy, uy * ds)
            dxx = ddx - cx
            nx2 = x + dxx
            cx2 = (nx2 - x) - dxx
            dyy = ddy - cy
            ny2 = y + dyy
            cy2 = (ny2 - y) - dyy

            n2, gx2, gy2 = nag(nx2, ny2)

            # ---- golden search on the momentum cost -------------------
            coef_i = coef_of(ux, uy)
            half_ds = ds * 0.5
            if iso:
                mi_x = n * ux
                mi_y = n * uy
                # constants of the residual, hoisted out of the loop
                kx = mi_x + (gx + gx2) * half_ds
                ky = mi_y + (gy + gy2) * half_ds

                def cost_uv(ct, st):
                    rx = n2 * ct - kx
                    ry = n2 * st - ky
                    return rx * rx + ry * ry
            else:
                # exact collapsed momenta (see mom_x): m = (n ct, n g^2 st)/cf
                inv_i = jax.lax.rsqrt((gamma * uy) ** 2 + ux * ux)
                mi_x = n * ux * inv_i
                mi_y = n * g2 * uy * inv_i
                # residual constants hoisted out of the search loop
                kx = mi_x + coef_i * gx * half_ds
                ky = mi_y + coef_i * gy * half_ds
                hx = gx2 * half_ds
                hy = gy2 * half_ds
                n2g2 = n2 * g2

                def cost_uv(ct, st):
                    # one rsqrt; cf = s2 * inv, no divides
                    s2 = (gamma * st) ** 2 + ct * ct
                    inv = jax.lax.rsqrt(s2)
                    cf = s2 * inv
                    rx = n2 * ct * inv - kx - cf * hx
                    ry = n2g2 * st * inv - ky - cf * hy
                    return rx * rx + ry * ry

            def newton_polish(mc, ms, t0, n_steps, clip_b):
                # Newton on d(cost)/d(delta) via nested forward-mode jvp
                # (ops/newton.py): quadratic convergence.  The offset delta
                # is measured from the seed unit vector (mc, ms) and probed
                # by small-angle polynomial rotations (_rot_small) — zero
                # transcendentals in the solve; every offset stays well
                # under the poly validity range (clip_b <= 0.45).
                def cost_d(dd):
                    sd, cd = _rot_small(dd)
                    return cost_uv(mc * cd - ms * sd, mc * sd + ms * cd)

                def dcost(dd):
                    return jax.jvp(cost_d, (dd,), (jnp.ones_like(dd),))[1]

                dlt = jnp.zeros_like(t0)
                for _ in range(n_steps):
                    d1, d2v = jax.jvp(dcost, (dlt,), (jnp.ones_like(dlt),))
                    safe = jnp.where(jnp.abs(d2v) < 1e-12, 1e-12,
                                     jnp.abs(d2v))
                    dlt = dlt - jnp.clip(d1 / safe, -clip_b, clip_b)
                dlt = jnp.clip(dlt, -clip_b, clip_b)
                sd, cd = _rot_small(dlt)
                return t0 + dlt, mc * cd - ms * sd, mc * sd + ms * cd

            def seed_uv():
                # Closed-form minimizer / seed (GOLD_SEED_ITERS): the iso
                # cost is nearest-point-on-circle — k/|k| is the EXACT
                # global minimizer; the aniso manifold (n2 ct, n2 g^2 st)/cf
                # is an ellipse shifted by the O(ds) cf*h term, and
                # normalize(kx, ky/g^2) is its ray-intersection point,
                # O(ds) from the true minimizer.
                if iso:
                    inv_k = jax.lax.rsqrt(kx * kx + ky * ky)
                    return kx * inv_k, ky * inv_k
                kyg = ky * inv_g2
                inv_k = jax.lax.rsqrt(kx * kx + kyg * kyg)
                return kx * inv_k, kyg * inv_k

            if solver == "newton":
                # seeded Newton: start at the closed-form direction (O(ds)
                # from the minimizer) instead of the incoming tangent
                # (O(ds*curv)) — same per-step cost, one contraction ahead
                mc, ms = seed_uv()
                t0 = ang + _asin_small(ux * ms - uy * mc)
                t_new, tc, ts = newton_polish(mc, ms, t0, 3, 0.3)
            elif gold_iters_n == 0:
                # closed-form schedule (production default, GOLD_SEED_ITERS)
                mc, ms = seed_uv()
                t_new = ang + _asin_small(ux * ms - uy * mc)
                if iso or not polish:
                    # iso: the seed IS the exact minimizer; polish is moot
                    tc, ts = mc, ms
                else:
                    t_new, tc, ts = newton_polish(mc, ms, t_new, polish,
                                                  0.15)
            else:
                # Transcendental-free golden schedule (module docstring):
                # probe unit vectors advance by the compile-time constant
                # rotations in scal_ref[2:]; probe/endpoint angles advance by
                # +-constants for the final midpoint.
                a_ang = ang - DELTA_G
                b_ang = ang + DELTA_G
                # initial probes as constant rotations of the tangent
                pc = ux * cos_c0 - uy * sin_c0   # cos(c), c = ang + c0_off
                ps = ux * sin_c0 + uy * cos_c0
                qc = ux * cos_d0 - uy * sin_d0   # cos(d)
                qs = ux * sin_d0 + uy * cos_d0
                fc = cost_uv(pc, ps)
                fd = cost_uv(qc, qs)

                def gold_body(k, g):
                    a_ang, b_ang, pc, ps, qc, qs, fc, fd = g
                    cth = scal_ref[4 + 2 * k]       # cos(delta_k)
                    sth = scal_ref[5 + 2 * k]       # sin(delta_k)
                    left = fc < fd
                    # surviving probe becomes the other side's probe; the
                    # fresh probe is the old far probe rotated by -+delta_k
                    sth_s = jnp.where(left, -sth, sth)
                    base_c = jnp.where(left, qc, pc)
                    base_s = jnp.where(left, qs, ps)
                    fresh_c = base_c * cth - base_s * sth_s
                    fresh_s = base_c * sth_s + base_s * cth
                    ff = cost_uv(fresh_c, fresh_s)
                    pc2 = jnp.where(left, fresh_c, qc)
                    ps2 = jnp.where(left, fresh_s, qs)
                    qc2 = jnp.where(left, pc, fresh_c)
                    qs2 = jnp.where(left, ps, fresh_s)
                    fc2 = jnp.where(left, ff, fd)
                    fd2 = jnp.where(left, fc, ff)
                    # endpoint angles: left keeps a, pulls b in; right mirror
                    dk = scal_ref[4 + 2 * gold_iters_n + k]  # delta_k itself
                    a2 = jnp.where(left, a_ang, a_ang + dk)
                    b2 = jnp.where(left, b_ang - dk, b_ang)
                    return a2, b2, pc2, ps2, qc2, qs2, fc2, fd2

                a_ang, b_ang, pc, ps, *_rest = jax.lax.fori_loop(
                    0, gold_iters_n, gold_body,
                    (a_ang, b_ang, pc, ps, qc, qs, fc, fd))
                t_new = (a_ang + b_ang) * 0.5
                if polish:
                    # midpoint unit vector = final probe c rotated by the
                    # compile-time constant mid_off; Newton offsets from it
                    # are small-angle rotations (see GOLD_POLISH).  Per-
                    # update clip: the minimizer is bracketed within
                    # +-L_final/2 of the midpoint (plus f32 bracket noise).
                    mc = pc * cos_m - ps * sin_m
                    ms = pc * sin_m + ps * cos_m
                    t_new, tc, ts = newton_polish(mc, ms, t_new, polish,
                                                  L_final)
            nang = jnp.where(significant, t_new, ang)
            if solver == "newton" or polish or gold_iters_n == 0:
                # tangent by rotation (tc, ts) — zero per-step
                # transcendentals; one rsqrt renormalization stops ulp-level
                # norm drift compounding across steps
                inv_nrm = jax.lax.rsqrt(tc * tc + ts * ts)
                nux = jnp.where(significant, tc * inv_nrm, ux)
                nuy = jnp.where(significant, ts * inv_nrm, uy)
            else:
                # parity mode: tangent re-derived from the angle each step
                nux, nuy = jnp.cos(nang), jnp.sin(nang)

            dist = jnp.sqrt(ddx * ddx + ddy * ddy)
            cf_new = coef_of(nux, nuy)
            ntt = tt + dist * (coef_i * n + cf_new * n2) * 0.5
            ndsim = dsim + dist

            out = ((nx2 > limx_s) | (nx2 < limx_i)
                   | (ny2 > limy_s) | (ny2 < limy_i))
            keep = (active > 0.5) & in_limit

            def sel(new, old):
                return jnp.where(keep, new, old)

            # gated on `keep` so a frozen ray's phantom step can't exit it
            nactive = jnp.where(keep & out, zero, active)
            base = (sel(nx2, x), sel(ny2, y), sel(cx2, cx), sel(cy2, cy),
                    sel(nang, ang), sel(nux, ux), sel(nuy, uy), sel(n2, n),
                    sel(gx2, gx), sel(gy2, gy), sel(ntt, tt),
                    sel(ndsim, dsim), nactive)
            if stats:
                # Welford over the post-step anisotropic m_x — the scan
                # carry's tracker (engine/trace.py, RT_bench.py:957-958)
                mx2 = mom_x(n2, cf_new, nux, nuy)
                cnt2 = cnt + 1.0
                delta2 = mx2 - mean
                mean2 = mean + delta2 / cnt2
                m22 = m2 + delta2 * (mx2 - mean2)
                base = base + (sel(cnt2, cnt), sel(mean2, mean),
                               sel(m22, m2))
            return base

        def integrate():
            ux, uy = jnp.cos(ang), jnp.sin(ang)
            n, gx, gy = nag(x, y)
            carry0 = (x, y, cx, cy, ang, ux, uy, n, gx, gy, tt, dsim, active)
            if stats:
                if resume:
                    carry0 = carry0 + stats0
                else:
                    cf0 = coef_of(ux, uy)
                    mx0 = mom_x(n, cf0, ux, uy)
                    carry0 = carry0 + (zero + 1.0, mx0, zero)
            final = jax.lax.fori_loop(0, steps, body, carry0)
            fx, fy, fcx, fcy, fang, _, _, _, _, _, ftt, fdsim, fact = \
                final[:13]
            if resume:
                outs = (fx, fy, fcx, fcy, fang, ftt, fdsim,
                        fact) + final[13:]
            else:
                outs = (fx, fy, fang, ftt, fdsim, fact) + (
                    final[13:16] if stats else ())
            for rf, val in zip(out_refs, outs):
                rf[...] = val

        if skip:
            block_live = live_ref[0] > 0.5
            pl.when(block_live)(integrate)

            @pl.when(jnp.logical_not(block_live))
            def _passthrough():
                for rf, val in zip(out_refs, vals):
                    rf[...] = val
        else:
            integrate()

    if strat is None:
        def kernel(*refs):
            kernel_impl(nag_analytic, *refs)
    else:
        y0, inv_hy, ny = strat

        def kernel(tables_ref, *refs):
            kernel_impl(_strat_nag(tables_ref, y0, inv_hy, ny), *refs)

    return kernel


def init_mom_x(op: str, n0, theta0, gamma):
    """First Welford sample of the horizontal momentum for op ``op``.

    Matches the kernel's tracker exactly: the iso golden ops (op5/op9) use
    the cf=1 form regardless of the caller's gamma (the kernel folds the
    anisotropy factor to 1 at build time); aniso ops use the collapsed
    m_x = n*cos(t)/cf (see ``mom_x`` in ``_make_kernel`` — algebraically the
    reference's RT_bench.py:215-228 formula, cancellation-free).
    """
    ct, st = jnp.cos(theta0), jnp.sin(theta0)
    if op in ("op5", "op9"):
        return n0 * ct
    cf = jnp.sqrt((gamma * st) ** 2 + ct * ct)
    return n0 * ct / cf


def golden_scalars(delta_s, gamma, step_limit, offset, iters):
    """The golden kernels' scalar bundle:
    [ds, gamma, limit, offset, (cos d_k, sin d_k) x iters, d_k x iters]."""
    _, _, deltas = _golden_offsets(iters)
    rot = np.empty(2 * iters, np.float32)
    rot[0::2] = np.cos(deltas)
    rot[1::2] = np.sin(deltas)
    return jnp.concatenate([
        jnp.stack([jnp.asarray(delta_s, jnp.float32),
                   jnp.asarray(gamma, jnp.float32),
                   jnp.asarray(step_limit, jnp.float32),
                   jnp.asarray(offset, jnp.float32)]),
        jnp.asarray(rot),
        jnp.asarray(deltas, jnp.float32)])


class GoldenFinal(NamedTuple):
    """Final-state bundle of a golden kernel run (all arrays length R)."""

    pos: Any          # (R, 2)
    angle: Any        # (R,) final angle
    traveltime: Any   # (R,)
    dist_sim: Any     # (R,)
    active: Any       # (R,) bool: never left the box
    mom_count: Any = None  # Welford m_x stats (with_stats=True only)
    mom_mean: Any = None
    mom_m2: Any = None


@functools.partial(jax.jit, static_argnames=("field", "op", "steps", "box",
                                             "block_rays", "interpret",
                                             "with_stats", "gold_iters",
                                             "polish"))
def golden_trace_final(pos0, theta0, delta_s, gamma, *, field: str, op: str,
                       steps: int, box, block_rays: int = 4096,
                       interpret: bool | None = None, medium=None,
                       with_stats: bool = False,
                       step_limit=None, gold_iters: int | None = None,
                       polish: int | None = None) -> GoldenFinal:
    """Run ``steps`` fused golden-section integration steps.

    ``gamma`` is the anisotropy ratio (1.0 == isotropic, i.e. op5/op9).
    ``medium``: pass a ``StratifiedGridMedium`` to evaluate the sampled
    tables instead of the analytic field (``field`` is then ignored).
    ``with_stats`` adds the Welford anisotropic-momentum tracker for
    on-device CV oracles.  ``step_limit`` (traced, default ``steps``)
    freezes rays after that many steps — one compiled kernel serves a whole
    DELTA_S candidate sweep.  ``gold_iters``/``polish`` select the golden
    schedule (default: closed-form seed + Newton polish, ``gold_iters=0``
    — see GOLD_SEED_ITERS; ``gold_iters>0`` a golden bracket;
    ``polish=0`` restores the pure f32 reference-parity bracket).
    """
    if op not in GOLDEN_OPS:
        raise ValueError(f"golden kernel supports {tuple(GOLDEN_OPS)}, got {op!r}")
    r = pos0.shape[0]
    if r % block_rays:
        raise ValueError(f"rays {r} not a multiple of block {block_rays}")
    x = jnp.asarray(pos0[:, 0], jnp.float32)
    y = jnp.asarray(pos0[:, 1], jnp.float32)
    ang = jnp.asarray(theta0, jnp.float32)

    iters, polish = golden_schedule(polish, gold_iters)
    tol = gold_tol(np.float32)
    if step_limit is None:
        step_limit = steps
    scal = golden_scalars(delta_s, gamma, step_limit, 0.0, iters)

    strat = None
    tables = ()
    custom = None
    if medium is not None:
        from raytracing_tpu.media.medium import CustomMedium
        from raytracing_tpu.media.spline import StratifiedGridMedium

        if isinstance(medium, CustomMedium):
            custom = medium
            medium = None
    if medium is not None:
        from raytracing_tpu.media.c1 import C1StratifiedMedium

        if not isinstance(medium, (StratifiedGridMedium, C1StratifiedMedium)):
            raise ValueError("golden kernel media support is limited to "
                             "StratifiedGridMedium/C1StratifiedMedium/"
                             "CustomMedium, got "
                             f"{type(medium).__name__}")
        table, strat = strat_tables(medium)
        tables = (table,)

    n_out = 9 if with_stats else 6
    outs = ray_block_call(
        _make_kernel(field, op, steps, tuple(box), iters, tol, strat=strat,
                     stats=with_stats, custom=custom, polish=polish),
        [x, y, ang], scal, n_out, tables=tables, interpret=interpret,
        name=f"golden_{op}")
    fx, fy, fang, tt, dsim, act = outs[:6]
    res = GoldenFinal(
        pos=jnp.stack([fx, fy], axis=-1), angle=fang, traveltime=tt,
        dist_sim=dsim, active=act > 0.5)
    if with_stats:
        cnt, mean, m2 = outs[6:]
        res = res._replace(mom_count=cnt, mom_mean=mean, mom_m2=m2)
    return res
