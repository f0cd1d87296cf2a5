"""Fused Pallas integrators: analytic fields x Taylor-family step methods.

Generalizes the fisheye-op1 kernel to a factory over
``field in {fisheye, vert_heterogeneous, interface}`` and
``op in {op1, op2, op6, op8}`` (the 1st/2nd-order Taylor steppers paired
with the analytic momentum-impulse and RK2 angle updates — op6 is HySA, the
headline algorithm of the JASA paper; RT_bench.py:469-515, 602-624,
652-674).  Each ray's state stays in registers across every integration
step (kernels/launch.py); per-step device-memory traffic is zero.

Design notes:

* Angle-free carry: the unit tangent (ux, uy) replaces the angle.  The
  momentum-impulse update becomes a normalization (rsqrt); the RK2 update
  rotates the tangent by the angle increments — ``cos``/``sin`` of the small
  increment only, never atan2.
* Kahan-compensated position accumulation holds float32 trajectories to
  ~1e-7 over thousands of steps.
* Boundary exit (RT_bench.py:878-879) is a per-ray mask; finished rays
  freeze.  All four scenario boxes work; the fisheye never exits and the
  mask costs a handful of compares.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from raytracing_tpu.config import THCK_PARAM
from raytracing_tpu.kernels.launch import ray_block_call

FUSED_FIELDS = ("fisheye", "vert_heterogeneous", "interface")
FUSED_OPS = ("op1", "op2", "op3", "op4", "op6", "op7", "op8", "op12")

_SQRT2 = 1.4142135623730951


def _field_fn(field: str):
    """n and its gradient, inlined into the kernel (media/fields.py twins)."""
    if field == "fisheye":
        def f(x, y):
            n = 1.0 / (1.0 + x * x + y * y)
            c = -2.0 * n * n
            return n, c * x, c * y
    elif field == "vert_heterogeneous":
        def f(x, y):
            n = 1.0 / (18.0 + 2.0 * y)
            zero = jnp.zeros_like(x)
            return n, zero, -2.0 * n * n
    else:  # interface
        def f(x, y):
            sig = 1.0 / (1.0 + jnp.exp(-y / THCK_PARAM))
            n = _SQRT2 - (_SQRT2 - 1.0) * sig
            zero = jnp.zeros_like(x)
            return n, zero, -(_SQRT2 - 1.0) * sig * (1.0 - sig) / THCK_PARAM
    return f


def _strat_nag(tables_ref, y0: float, inv_hy: float, ny: int):
    """n/grad evaluator gathering per ray from the 1-D cell tables.

    Mirrors media/spline.StratifiedGridMedium.n_and_grad: bilinear n from the
    sampled column, cubic dn/dy from per-cell coefficients (the reference's
    FITPACK pair, RT_bench.py:455-458, collapsed to 1-D for x-independent
    fields).  ``tables_ref`` holds the channel-major flat table of
    :func:`strat_tables` (channel ``c`` of cell ``i`` at ``c * ny + i``);
    every channel is one gather straight from device memory.
    """
    chans = tables_ref.shape[0] // ny    # 6 parity / 4 C1 (see strat_tables)

    def nag(x, y):
        fy = jnp.clip((y - y0) * inv_hy, 0.0, float(ny - 1))
        iy = jnp.minimum(jnp.floor(fy), float(ny - 2))
        uy = fy - iy
        ii = iy.astype(jnp.int32)
        vals = [tables_ref[ii + c * ny] for c in range(chans)]
        if chans == 4:
            # consistent C1 cubic: n and dn/dy from the same coefficients
            # (the expressions mirror media.c1.C1StratifiedMedium.n_and_grad)
            c0, c1, c2, c3 = vals
            n = c0 + uy * (c1 + uy * (c2 + uy * c3))
            gy = (c1 + uy * (2.0 * c2 + uy * 3.0 * c3)) * inv_hy
            return n, jnp.zeros_like(x), gy
        zlo, zhi, c0, c1, c2, c3 = vals
        n = (1.0 - uy) * zlo + uy * zhi
        gy = c0 + uy * (c1 + uy * (c2 + uy * c3))
        return n, jnp.zeros_like(x), gy

    return nag


def strat_tables(medium):
    """Pack a 1-D stratified medium into the kernels' channel table.

    Returns (tables, strat_meta): tables is the flat channel-major
    (C * ny,) float32 array :func:`_strat_nag` gathers from; strat_meta is
    the (y0, inv_hy, ny) literal tuple for ``_make_kernel(strat=...)``.
    C = 6 for the parity StratifiedGridMedium (channels Zy[i], Zy[i+1],
    cy[i, 0..3]); C = 4 for the consistent-gradient C1StratifiedMedium
    (channels cn[i, 0..3] — one cubic serves n AND dn/dy, media/c1.py).
    The ONE definition shared by the fused, golden, dynamic and segmented
    wrappers.
    """
    ny = medium.ny
    if hasattr(medium, "cn"):            # C1StratifiedMedium
        cpad = jnp.pad(jnp.asarray(medium.cn, jnp.float32), ((0, 1), (0, 0)))
        chans = [cpad[:, 0], cpad[:, 1], cpad[:, 2], cpad[:, 3]]
    else:
        zy = jnp.asarray(medium.Zy, jnp.float32)
        cy = jnp.asarray(medium.cy, jnp.float32)
        zhi = jnp.pad(zy[1:], (0, 1), mode="edge")
        cpad = jnp.pad(cy, ((0, 1), (0, 0)))
        chans = [zy, zhi, cpad[:, 0], cpad[:, 1], cpad[:, 2], cpad[:, 3]]
    tables = jnp.concatenate(chans)
    strat = (float(medium.y0), float(medium.inv_hy), int(ny))
    return tables, strat


def _custom_nag(medium):
    """nag from a user CustomMedium: n_and_grad inlined into the kernel.

    The user's ``n_fn`` (and autodiff jvp when no ``grad_fn`` is given) must
    consist of elementwise jnp ops the Triton route lowers — true for
    ordinary closed-form fields; exotic primitives surface as lowering
    errors, and the scan engine (``engine/trace.py``) runs any such field.
    """
    def nag(x, y):
        n, (gx, gy) = medium.n_and_grad(x, y)
        return n, gx, gy

    return nag


def _make_kernel(field: str, op: str, steps: int, box, curv_tol: float = 0.0,
                 strat=None, stats: bool = False, resume: bool = False,
                 custom=None, skip: bool = False):
    """Build the fused step kernel.

    ``stats`` adds a Welford tracker of the horizontal momentum m_x = n*u_x
    to the carry (count/mean/M2) — the on-device momentum-conservation
    oracle for the stratified scenarios (RT_bench.py:957-958, 1352-1360) at
    kernel speed.  Isotropic only (gamma == 1), which is exactly the fused
    op set's domain.

    ``resume`` makes the kernel *segmentable*: it reads the FULL integration
    state (incl. Kahan compensations, accumulators, the op7 window) from
    input refs and writes it back, with a global step offset in the scalar
    bundle — so an outer loop can chain bounded-trip-count launches
    (engine/segmented.py) and compact live rays between segments.

    ``skip`` (resume only) prepends a per-program liveness flag (a (1,)
    block of the table from ``launch.program_flags``): a program whose flag
    is 0 — every ray frozen by boundary exit or the step limit — bypasses
    the whole step loop and copies its state through (``pl.when``).  With
    launch batches ordered so rays that exit together sit in the same
    program (e.g. the interface fan sorted by angle), frozen programs cost
    only their state copy — the device-side answer to the reference's
    data-dependent break (RT_bench.py:878-879) without a host round-trip.
    """
    if skip and not resume:
        raise ValueError("skip is a resume-kernel feature")
    if custom is not None:
        nag = _custom_nag(custom)
    elif strat is not None:
        nag = None
    else:
        nag = _field_fn(field)
    second_order = op in ("op6", "op7", "op8")
    curvature = op in ("op3", "op4")
    rk2 = op in ("op2", "op3", "op6")
    window = op == "op7"
    rk4 = op == "op12"
    # python floats fold into the kernel as literals (jnp scalars would be
    # captured tracer constants, which pallas_call rejects)
    limx_i, limx_s, limy_i, limy_s = [float(v) for v in box]

    def kernel_impl(nag, *refs):
        live_ref = None
        if skip:
            live_ref, refs = refs[0], refs[1:]
        if resume:
            n_in = 9 + (3 if stats else 0) + (4 if window else 0)
            in_refs, ds_ref = refs[:n_in], refs[n_in]
            out_refs = refs[n_in + 1:]
            vals = [r[...] for r in in_refs]
            x, y, ux, uy, cx, cy, tt, dsim, active = vals[:9]
            extra0 = tuple(vals[9:])
            zero = jnp.zeros_like(x)
            offset = ds_ref[2]  # applied steps before this segment
        else:
            (x_ref, y_ref, ux_ref, uy_ref, ds_ref), out_refs = \
                refs[:5], refs[5:]
            x, y = x_ref[...], y_ref[...]
            ux, uy = ux_ref[...], uy_ref[...]
            zero = jnp.zeros_like(x)
            cx = zero
            cy = zero
            tt = zero
            dsim = zero
            active = zero + 1.0  # f32 mask, shared with the resume layout
            offset = 0.0
            extra0 = None
        ds = ds_ref[0]
        limit = ds_ref[1]  # effective steps (traced); rays freeze after

        def body(i, carry):
            if resume:
                in_limit = (i.astype(jnp.float32) + offset) < limit
            else:
                in_limit = i.astype(jnp.float32) < limit
            x, y, cx, cy, ux, uy, n, gx, gy, tt, dsim, active = carry[:12]
            rest = carry[12:]
            if stats:
                cnt, mean, m2 = rest[:3]
                rest = rest[3:]
            if window:
                wax, way, wbx, wby = rest

            # -- position advance ---------------------------------------
            if rk4:
                # joint RK4 (ops/registry.py op12) with the tangent carried
                # as (cos t, sin t); intermediate angles are rotations of the
                # tangent by the small k increments — no atan2 anywhere.
                # Rotations use degree-5 small-angle polynomials: the
                # increments are O(ds * curvature), so the d^5/120 truncation
                # sits below float32 eps for any practical step — and chains
                # of real sin/cos cost far more than these few mul-adds.
                def rot(ax, ay, d):
                    d2 = d * d
                    s = d * (1.0 - d2 * (1.0 / 6.0) * (1.0 - d2 * 0.05))
                    c = 1.0 - d2 * 0.5 * (1.0 - d2 * (1.0 / 12.0))
                    return ax * c - ay * s, ax * s + ay * c

                h = ds
                k1t = (ux * gy - uy * gx) / n
                u1x, u1y = rot(ux, uy, 0.5 * h * k1t)
                nb, gbx, gby = nag(x + 0.5 * h * ux, y + 0.5 * h * uy)
                k2t = (u1x * gby - u1y * gbx) / nb
                u2x, u2y = rot(ux, uy, 0.5 * h * k2t)
                nc, gcx, gcy = nag(x + 0.5 * h * u1x, y + 0.5 * h * u1y)
                k3t = (u2x * gcy - u2y * gcx) / nc
                u3x, u3y = rot(ux, uy, h * k3t)
                nd, gdx, gdy = nag(x + h * u2x, y + h * u2y)
                k4t = (u3x * gdy - u3y * gdx) / nd
                ddx = (h / 6.0) * (ux + 2 * u1x + 2 * u2x + u3x)
                ddy = (h / 6.0) * (uy + 2 * u1y + 2 * u2y + u3y)
                dth = (h / 6.0) * (k1t + 2 * k2t + 2 * k3t + k4t)
                rk4_ux, rk4_uy = rot(ux, uy, dth)
                significant = None
            elif second_order:
                # transverse = grad - (grad.u)u ; r += u ds + transverse ds^2/2n
                gdotu = gx * ux + gy * uy
                half_fac = ds * ds * 0.5 / n
                ddx = ux * ds + (gx - gdotu * ux) * half_fac
                ddy = uy * ds + (gy - gdotu * uy) * half_fac
                significant = None
            elif curvature:
                # arc step on the circle of curvature (RT_bench.py:335-365),
                # chord via rotations of the tangent (ops/steppers.py)
                gdotu = gx * ux + gy * uy
                txx = gx - gdotu * ux
                txy = gy - gdotu * uy
                curv = jnp.sqrt(txx * txx + txy * txy) / n
                significant = curv >= curv_tol
                safe = jnp.where(significant, curv, 1.0)
                d = curv * ds
                sgn = jnp.where(gx * uy - gy * ux > 0, -1.0, 1.0)
                halfd = sgn * d * 0.5
                # degree-5 small-angle polys (see the RK4 note above): the
                # d^5/120 truncation at |halfd| <= ~0.2 sits ~2e-6, and the
                # chord it seeds is scaled by ds again — below f32 noise
                hd2 = halfd * halfd
                shh = halfd * (1.0 - hd2 * (1.0 / 6.0) * (1.0 - hd2 * 0.05))
                chh = 1.0 - hd2 * 0.5 * (1.0 - hd2 * (1.0 / 12.0))
                coefc = 2.0 * shh * sgn / safe
                arc_dx = (ux * chh - uy * shh) * coefc
                arc_dy = (ux * shh + uy * chh) * coefc
                ddx = jnp.where(significant, arc_dx, ux * ds)
                ddy = jnp.where(significant, arc_dy, uy * ds)
            else:
                ddx = ux * ds
                ddy = uy * ds
                significant = None
            dx = ddx - cx
            nx2 = x + dx
            cx2 = (nx2 - x) - dx
            dy = ddy - cy
            ny2 = y + dy
            cy2 = (ny2 - y) - dy

            n2, gx2, gy2 = nag(nx2, ny2)

            # -- angle update -------------------------------------------
            if rk4:
                nux, nuy = rk4_ux, rk4_uy
            elif window:
                # MxSA: backward difference over the 4-position window with
                # the in-scan order ramp (ops/registry.py, RT_bench.py:833-
                # 864, 370-372).  The reference takes atan2 of the
                # combination vector then cos/sin — the tangent is just the
                # normalized combination, so no atan2 here.
                step_f = i.astype(jnp.float32) + offset + 1.0  # global step no.
                is1 = step_f == 1.0
                is2 = step_f == 2.0
                ca = jnp.where(is1, 0.0, jnp.where(is2, 0.0, -2.0))
                cb = jnp.where(is1, 0.0, jnp.where(is2, 1.0, 9.0))
                cc = jnp.where(is1, -1.0, jnp.where(is2, -4.0, -18.0))
                cd = jnp.where(is1, 1.0, jnp.where(is2, 3.0, 11.0))
                vx = ca * wax + cb * wbx + cc * x + cd * nx2
                vy = ca * way + cb * wby + cc * y + cd * ny2
                inv = jax.lax.rsqrt(vx * vx + vy * vy)
                nux = vx * inv
                nuy = vy * inv
            elif rk2:
                # tfinal_2o: k1/k2 angle increments; rotate the tangent.
                # Degree-5 small-angle polynomials instead of cos/sin (the
                # RK4/curvature paths' trick): the increments are
                # O(ds * curvature), so the d^5/120 truncation sits below
                # f32 noise at any practical step, and the step needs no
                # transcendental pairs.
                def rot(ax, ay, d):
                    d2 = d * d
                    s = d * (1.0 - d2 * (1.0 / 6.0) * (1.0 - d2 * 0.05))
                    c = 1.0 - d2 * 0.5 * (1.0 - d2 * (1.0 / 12.0))
                    return ax * c - ay * s, ax * s + ay * c

                k1 = ds * (ux * gy - uy * gx) / n
                ux1, uy1 = rot(ux, uy, k1)
                k2 = ds * (ux1 * gy2 - uy1 * gx2) / n2
                nux, nuy = rot(ux, uy, (k1 + k2) * 0.5)
            else:
                # theta_cost_t: normalized momentum + trapezoid impulse.
                half = ds * 0.5
                sx = n * ux + (gx + gx2) * half
                sy = n * uy + (gy + gy2) * half
                inv = jax.lax.rsqrt(sx * sx + sy * sy)
                nux = sx * inv
                nuy = sy * inv

            if significant is not None:
                # curvature ops keep the old angle when curvature is
                # negligible (RT_bench.py:538-541, 566-569)
                nux = jnp.where(significant, nux, ux)
                nuy = jnp.where(significant, nuy, uy)

            # first-order steps move exactly ds
            if second_order or curvature or rk4:
                dist = jnp.sqrt(ddx * ddx + ddy * ddy)
                ntt = tt + dist * (n + n2) * 0.5
                ndsim = dsim + dist
            else:
                ntt = tt + ds * (n + n2) * 0.5
                ndsim = dsim + ds

            # -- boundary exit mask (strict, RT_bench.py:878) -----------
            out = ((nx2 > limx_s) | (nx2 < limx_i)
                   | (ny2 > limy_s) | (ny2 < limy_i))
            keep = (active > 0.5) & in_limit

            def sel(new, old):
                return jnp.where(keep, new, old)

            # gated on `keep`: a limit-frozen ray's phantom step must not
            # flip its activity (engine/trace.py `st.active & ~out`)
            nactive = jnp.where(keep & out, zero, active)
            base = (sel(nx2, x), sel(ny2, y), sel(cx2, cx), sel(cy2, cy),
                    sel(nux, ux), sel(nuy, uy), sel(n2, n), sel(gx2, gx),
                    sel(gy2, gy), sel(ntt, tt), sel(ndsim, dsim), nactive)
            if stats:
                # Welford over the post-step momentum m_x = n2 * nux — same
                # accumulation the scan carry keeps (engine/trace.py body)
                mx2 = n2 * nux
                cnt2 = cnt + 1.0
                delta = mx2 - mean
                mean2 = mean + delta / cnt2
                m22 = m2 + delta * (mx2 - mean2)
                base = base + (sel(cnt2, cnt), sel(mean2, mean), sel(m22, m2))
            if window:
                base = base + (sel(wbx, wax), sel(wby, way),
                               sel(x, wbx), sel(y, wby))
            return base

        def integrate():
            n, gx, gy = nag(x, y)
            carry0 = (x, y, cx, cy, ux, uy, n, gx, gy, tt, dsim, active)
            if resume:
                carry0 = carry0 + extra0
            else:
                if stats:
                    # row 0 included
                    carry0 = carry0 + (zero + 1.0, n * ux, zero)
                if window:
                    carry0 = carry0 + (x, y, x, y)  # p_{-2} = p_{-1} = p_0
            final = jax.lax.fori_loop(0, steps, body, carry0)
            fx, fy, fcx, fcy, fux, fuy, _, _, _, ftt, fdsim, fact = final[:12]
            if resume:
                outs = (fx, fy, fux, fuy, fcx, fcy, ftt, fdsim,
                        fact) + final[12:]
            else:
                outs = (fx, fy, fux, fuy, ftt, fdsim, fact) + (
                    final[12:15] if stats else ())
            for ref, val in zip(out_refs, outs):
                ref[...] = val

        if skip:
            block_live = live_ref[0] > 0.5
            pl.when(block_live)(integrate)

            @pl.when(jnp.logical_not(block_live))
            def _passthrough():
                # every ray frozen: state rides through unchanged
                for ref, val in zip(out_refs, vals):
                    ref[...] = val
        else:
            integrate()

    if strat is None:
        def kernel(*refs):
            kernel_impl(nag, *refs)
    else:
        y0, inv_hy, ny = strat

        def kernel(tables_ref, *refs):
            kernel_impl(_strat_nag(tables_ref, y0, inv_hy, ny), *refs)

    return kernel


class FusedFinal(NamedTuple):
    """Final-state bundle of a fused kernel run (all arrays length R)."""

    pos: Any          # (R, 2) final positions
    tangent: Any      # (R, 2) final unit tangent (cos/sin of the exit angle)
    traveltime: Any   # (R,)
    dist_sim: Any     # (R,)
    active: Any       # (R,) bool: never left the box
    mom_count: Any = None  # Welford m_x stats (with_stats=True only)
    mom_mean: Any = None
    mom_m2: Any = None


def _call_kernel(kernel, tables, x, y, ux, uy, ds, *, with_stats, interpret,
                 name):
    n_out = 10 if with_stats else 7
    outs = ray_block_call(kernel, [x, y, ux, uy], ds, n_out,
                          tables=() if tables is None else (tables,),
                          interpret=interpret, name=name)
    fx, fy, fux, fuy, tt, dsim, act = outs[:7]
    res = FusedFinal(
        pos=jnp.stack([fx, fy], axis=-1),
        tangent=jnp.stack([fux, fuy], axis=-1),
        traveltime=tt, dist_sim=dsim, active=act > 0.5)
    if with_stats:
        cnt, mean, m2 = outs[7:]
        res = res._replace(mom_count=cnt, mom_mean=mean, mom_m2=m2)
    return res


def _launch_state(pos0, theta0, delta_s, step_limit, steps, r, block_rays):
    """Flat (R,) launch components + the (delta_s, limit) scalar bundle."""
    if r % block_rays:
        raise ValueError(f"rays {r} not a multiple of block {block_rays}")
    theta0 = jnp.asarray(theta0, jnp.float32)
    x = jnp.asarray(pos0[:, 0], jnp.float32)
    y = jnp.asarray(pos0[:, 1], jnp.float32)
    if step_limit is None:
        step_limit = steps
    ds = jnp.stack([jnp.asarray(delta_s, jnp.float32),
                    jnp.asarray(step_limit, jnp.float32)])
    return x, y, jnp.cos(theta0), jnp.sin(theta0), ds


@functools.partial(jax.jit, static_argnames=("field", "op", "steps", "box",
                                             "block_rays", "interpret",
                                             "with_stats"))
def fused_trace_final(pos0, theta0, delta_s, *, field: str, op: str,
                      steps: int, box, block_rays: int = 4096,
                      interpret: bool | None = None, step_limit=None,
                      with_stats: bool = False) -> FusedFinal:
    """Run ``steps`` fused integration steps; return a :class:`FusedFinal`.

    ``step_limit`` (traced scalar, default ``steps``) freezes every ray
    after that many steps — the padded-scan trick that lets ONE compiled
    kernel serve a whole DELTA_S candidate sweep (engine/trace.py's
    ``step_limit``, SURVEY.md §7.5), at kernel speed.  ``with_stats`` adds
    the Welford momentum-conservation tracker (RT_bench.py:957-958) to the
    carry for on-device CV oracles."""
    if field not in FUSED_FIELDS:
        raise ValueError(f"fused kernel supports fields {FUSED_FIELDS}, got {field!r}")
    if op not in FUSED_OPS:
        raise ValueError(f"fused kernel supports ops {FUSED_OPS}, got {op!r}")
    x, y, ux, uy, ds = _launch_state(pos0, theta0, delta_s, step_limit,
                                     steps, pos0.shape[0], block_rays)
    from raytracing_tpu.config import gold_tol
    kernel = _make_kernel(field, op, steps, box, gold_tol(np.float32),
                          stats=with_stats)
    return _call_kernel(kernel, None, x, y, ux, uy, ds,
                        with_stats=with_stats, interpret=interpret,
                        name=f"fused_{op}_{field}")


@functools.partial(jax.jit, static_argnames=("medium", "op", "steps", "box",
                                             "block_rays", "interpret",
                                             "with_stats"))
def fused_trace_final_custom(pos0, theta0, delta_s, *, medium, op: str,
                             steps: int, box, block_rays: int = 4096,
                             interpret: bool | None = None, step_limit=None,
                             with_stats: bool = False) -> FusedFinal:
    """Fused integration through a user-defined :class:`CustomMedium`.

    The reference requires editing its source to add a medium
    (RT_bench.py:104-116, 1567-1580); here any elementwise ``n(x, y)`` the
    Triton route lowers runs at kernel speed, gradient by forward-mode
    autodiff inlined into the step body.  Same contract as
    :func:`fused_trace_final`.
    """
    if op not in FUSED_OPS:
        raise ValueError(f"fused kernel supports ops {FUSED_OPS}, got {op!r}")
    x, y, ux, uy, ds = _launch_state(pos0, theta0, delta_s, step_limit,
                                     steps, pos0.shape[0], block_rays)
    from raytracing_tpu.config import gold_tol
    kernel = _make_kernel("custom", op, steps, box, gold_tol(np.float32),
                          stats=with_stats, custom=medium)
    return _call_kernel(kernel, None, x, y, ux, uy, ds,
                        with_stats=with_stats, interpret=interpret,
                        name=f"fused_{op}_custom")


@functools.partial(jax.jit, static_argnames=("op", "steps", "box",
                                             "block_rays", "interpret",
                                             "with_stats"))
def fused_trace_final_strat(pos0, theta0, delta_s, medium, *, op: str,
                            steps: int, box, block_rays: int = 4096,
                            interpret: bool | None = None, step_limit=None,
                            with_stats: bool = False) -> FusedFinal:
    """Fused integration through a sampled stratified medium.

    The kernel path for the reference's grid/spline media on x-independent
    fields (interface / vert): the 1-D cell tables of a
    ``media.spline.StratifiedGridMedium`` stay in device memory and the
    kernel gathers n / dn/dy per ray and step — the replacement for the
    three FITPACK evaluations per step that dominate the reference's hot
    loop (RT_bench.py:435-464, 141-156).
    """
    if op not in FUSED_OPS:
        raise ValueError(f"fused kernel supports ops {FUSED_OPS}, got {op!r}")
    x, y, ux, uy, ds = _launch_state(pos0, theta0, delta_s, step_limit,
                                     steps, pos0.shape[0], block_rays)
    tables, strat = strat_tables(medium)
    from raytracing_tpu.config import gold_tol
    kernel = _make_kernel("stratified", op, steps, box, gold_tol(np.float32),
                          strat=strat, stats=with_stats)
    return _call_kernel(kernel, tables, x, y, ux, uy, ds,
                        with_stats=with_stats, interpret=interpret,
                        name=f"fused_{op}_strat")
