"""Double-word float32 RK4 kernels: float64-grade trajectories in float32.

A plain float32 integrator's tangent update injects ~eps_f32 of direction
noise per step — a random walk that floors million-step trajectories around
1e-5.  This kernel carries position *and* tangent as double-word float32
pairs (value = hi + lo, "df32"):

* position increments accumulate through exact two_prod/two_sum chains
  (error-free transformations; Dekker products over a bit-mask split);
* the tangent never passes through a normalization: each step rotates it by
  the RK4 angle increment using ``(1 + cm, s)`` with ``cm = cos(d) - 1``
  and ``s = sin(d)`` evaluated as small-angle polynomials, applied as a
  *correction term* df-added to the tangent.  The rotation is orthogonal to
  O(d^6), so |u| drifts by ~1e-14 per step instead of being re-rounded;
* medium evaluations and RK4 stage algebra stay plain f32 — their errors
  enter only through O(ds)-sized increments and stay ~1e-10/step.

Net: per-step direction noise drops from ~6e-8 to ~1e-10 rad, putting the
whole-trajectory RMS error near 1e-8, at roughly 3-4x the flops of the
plain kernel.

Compilers for the GPU contract ``a * b + c`` into one fused multiply-add.
The error-free transformations here stay exact under contraction: the
split is a bit mask (no ``a * SPLIT - a`` for a compiler to fuse), and
every product in ``_two_prod``'s error term is exact, so fused and unfused
evaluation agree.

The technique is classic compensated (double-word) arithmetic; the reference
has no counterpart (it simply runs float64 on CPUs, RT_bench.py:810).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu.kernels.launch import ray_block_call

#: clears the low 12 of float32's 23 stored mantissa bits
_SPLIT_MASK = np.int32(-4096)
_SIXTH_HI = float(np.float32(1.0 / 6.0))
_SIXTH_LO = float(np.float32(1.0 / 6.0 - np.float64(np.float32(1.0 / 6.0))))


def _two_sum(a, b):
    # Knuth: s = a+b exactly representable as s + err
    s = a + b
    bv = s - a
    return s, (a - (s - bv)) + (b - bv)


def _fast_two_sum(a, b):  # requires |a| >= |b|
    s = a + b
    return s, b - (s - a)


def _split(a):
    """a = hi + lo exactly, each half with at most 12 significant bits."""
    if isinstance(a, float):           # a literal: split it here
        hi = (np.array(a, np.float32).view(np.int32) & _SPLIT_MASK)
        hi = hi.view(np.float32)
        return float(hi), float(np.float32(a) - hi)
    a = jnp.asarray(a, jnp.float32)
    bits = jax.lax.bitcast_convert_type(a, jnp.int32)
    hi = jax.lax.bitcast_convert_type(bits & _SPLIT_MASK, jnp.float32)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _df_add_f(xh, xl, y):
    """(xh + xl) + y, renormalized."""
    s, e = _two_sum(xh, y)
    return _fast_two_sum(s, e + xl)


def _sin_poly(d):
    d2 = d * d
    return d * (1.0 - d2 * (1.0 / 6.0) * (1.0 - d2 * 0.05))


def _cosm1_poly(d):
    d2 = d * d
    return -d2 * 0.5 * (1.0 - d2 * (1.0 / 12.0))


def _apply_rotation(uxh, uxl, uyh, uyl, dth_h, dth_l):
    """Rotate the df tangent by the df angle (dth_h + dth_l).

    sin carries the angle's low word (d(sin)/d(dth) ~ 1 at these step
    sizes), the increment is applied as a correction df-added to the
    tangent, and the polynomial rotation is orthogonal to O(dth^6) so no
    renormalization is ever needed.
    """
    dth = dth_h
    dth2 = dth * dth
    s_corr = -dth * dth2 * (1.0 / 6.0) * (1.0 - dth2 * 0.05)
    sh_, sl_ = _df_add_f(dth, dth_l, s_corr)
    cm = _cosm1_poly(dth) - dth * dth_l
    s = sh_ + sl_
    dux = uxh * cm - uyh * s + uxl * cm - uyl * s
    duy = uyh * cm + uxh * s + uyl * cm + uxl * s
    nxh, nxl = _df_add_f(uxh, uxl, dux)
    nyh, nyl = _df_add_f(uyh, uyl, duy)
    return nxh, nxl, nyh, nyl


DF_FIELDS = ("fisheye", "vert_heterogeneous")


def _df_recip(dh, dl):
    """1/(dh + dl) as df via one Newton refinement of the f32 quotient."""
    n0 = 1.0 / dh
    th, tl = _two_prod(dh, n0)
    resid = ((1.0 - th) - tl) - dl * n0
    return n0, n0 * resid


def make_df_rk4_body(df_k, ds):
    """One double-word RK4 step as a ``fori_loop`` body.

    ``df_k(pxh, pxl, pyh, pyl, vxh, vxl, vyh, vyl) -> (kh, kl)`` is the
    df angle rate (u x grad n)/n at a df position/tangent.  The body is
    pure jnp, so the SAME step serves the Triton kernel (analytic fields,
    below) and the jnp-level sampled-media tracer
    (engine/df_grid.py) — one definition of the accuracy-critical
    compensation choreography.
    """
    h2 = ds * 0.5
    h6 = ds * (1.0 / 6.0)

    def body(_, carry):
        xh, xl, yh, yl, uxh, uxl, uyh, uyl = carry
        ux, uy = uxh, uyh

        def corr(a):
            s, cm = _sin_poly(a), _cosm1_poly(a)
            return ux * cm - uy * s, uy * cm + ux * s

        def midpoint(hc, vx, vy):
            """df position + hc * (f32 stage tangent)."""
            pxh, pxe = _two_prod(hc, vx)
            pyh, pye = _two_prod(hc, vy)
            mxh, mxl = _df_add_f(xh, xl + pxe, pxh)
            myh, myl = _df_add_f(yh, yl + pye, pyh)
            return mxh, mxl, myh, myl

        # Stage angles use the FULL k value (hi + lo): once the stage-tangent
        # corrections ride in the low word, k's low word is c-sized, and
        # dropping it from the stage rotations costs ~1e-8 per step.
        k1h, k1l = df_k(xh, xl, yh, yl, uxh, uxl, uyh, uyl)
        c1x, c1y = corr(h2 * (k1h + k1l))
        m = midpoint(h2, ux, uy)
        # stage tangents are u + c_i: the angle rate is linear in the
        # tangent, so evaluate at u and carry c_i in the low word.
        k2h, k2l = df_k(*m, uxh, uxl + c1x, uyh, uyl + c1y)
        c2x, c2y = corr(h2 * (k2h + k2l))
        m = midpoint(h2, ux + c1x, uy + c1y)
        k3h, k3l = df_k(*m, uxh, uxl + c2x, uyh, uyl + c2y)
        c3x, c3y = corr(ds * (k3h + k3l))
        m = midpoint(ds, ux + c2x, uy + c2y)
        k4h, k4l = df_k(*m, uxh, uxl + c3x, uyh, uyl + c3y)

        # position: delta = h*u + h/6*(2c1 + 2c2 + c3), df-accumulated
        px, pex = _two_prod(ds, uxh)
        py, pey = _two_prod(ds, uyh)
        rx = h6 * (2.0 * c1x + 2.0 * c2x + c3x) + ds * uxl + pex
        ry = h6 * (2.0 * c1y + 2.0 * c2y + c3y) + ds * uyl + pey
        xh, xl = _df_add_f(xh, xl + rx, px)
        yh, yl = _df_add_f(yh, yl + ry, py)

        # dth = ds * (k1 + 2k2 + 2k3 + k4) / 6, all in df: any plain-f32
        # scale here carries an O(eps) systematic bias that drifts the
        # tangent against the exactly-accumulated positions.
        ksh, kse = _two_sum(k1h, k4h)
        ksh2, kse2 = _two_sum(2.0 * k2h, 2.0 * k3h)
        sh_, se_ = _two_sum(ksh, ksh2)
        ksum_h = sh_
        ksum_l = se_ + kse + kse2 + (k1l + 2.0 * k2l + 2.0 * k3l + k4l)
        ph, pe = _two_prod(ds, ksum_h)
        pe = pe + ds * ksum_l
        # the * (1/6) scaling itself must keep its rounding error: dropping
        # it biases dth by ~eps*dth per step, a systematic phase drift
        ah, al = _two_prod(ph, _SIXTH_HI)
        dth_h, dth_l = _fast_two_sum(ah, al + ph * _SIXTH_LO + pe * _SIXTH_HI)
        uxh, uxl, uyh, uyl = _apply_rotation(uxh, uxl, uyh, uyl,
                                             dth_h, dth_l)
        return xh, xl, yh, yl, uxh, uxl, uyh, uyl

    return body


def _df_rk4_kernel(field: str, steps: int, resume: bool, *refs):
    if resume:
        (xh_ref, xl_ref, yh_ref, yl_ref, uxh_ref, uxl_ref, uyh_ref, uyl_ref,
         ds_ref, oxh, oxl, oyh, oyl, ouxh, ouxl, ouyh, ouyl) = refs
    else:
        (xh_ref, yh_ref, uxh_ref, uyh_ref, ds_ref,
         oxh, oxl, oyh, oyl) = refs
    ds = ds_ref[0]
    if field == "fisheye":
        def df_k(pxh, pxl, pyh, pyl, vxh, vxl, vyh, vyl):
            """Angle rate k = -2 n (v_x y - v_y x) at df position/tangent.

            The fisheye simplification (u x grad n)/n = -2 n (u_x y - u_y x)
            removes the division; n = 1/(1 + r^2) is Newton-refined so the
            whole rate is df-accurate.  f32 stage evaluations were the
            dominant error: their rounding varies *smoothly* along the
            trajectory, so it integrates linearly, not as a random walk.
            """
            ah, al = _two_prod(vxh, pyh)
            al = al + (vxh * pyl + vxl * pyh)
            bh, bl = _two_prod(vyh, pxh)
            bl = bl + (vyh * pxl + vyl * pxh)
            ch, ce = _two_sum(ah, -bh)
            cl = ce + (al - bl)
            xxh, xxl = _two_prod(pxh, pxh)
            xxl = xxl + 2.0 * pxh * pxl
            yyh, yyl = _two_prod(pyh, pyh)
            yyl = yyl + 2.0 * pyh * pyl
            sh, se = _two_sum(xxh, yyh)
            dh, de = _two_sum(1.0, sh)
            dl = de + se + xxl + yyl
            n0, nl = _df_recip(dh, dl)
            kh, ke = _two_prod(-2.0 * n0, ch)
            kl = ke + (-2.0) * (nl * ch + n0 * cl)
            return kh, kl
    else:  # vert_heterogeneous: n = 1/(18 + 2y), k = (u x g)/n = -2 n u_x
        def df_k(pxh, pxl, pyh, pyl, vxh, vxl, vyh, vyl):
            dh, de = _two_sum(18.0, 2.0 * pyh)   # 2*y exact in binary
            dl = de + 2.0 * pyl
            n0, nl = _df_recip(dh, dl)
            kh, ke = _two_prod(-2.0 * n0, vxh)
            kl = ke + (-2.0) * (nl * vxh + n0 * vxl)
            return kh, kl

    body = make_df_rk4_body(df_k, ds)

    if resume:
        # full df state rides between segment launches
        init = (xh_ref[...], xl_ref[...], yh_ref[...], yl_ref[...],
                uxh_ref[...], uxl_ref[...], uyh_ref[...], uyl_ref[...])
    else:
        zero = jnp.zeros_like(xh_ref[...])
        init = (xh_ref[...], zero, yh_ref[...], zero,
                uxh_ref[...], zero, uyh_ref[...], zero)
    xh, xl, yh, yl, uxh, uxl, uyh, uyl = jax.lax.fori_loop(0, steps, body, init)
    oxh[...] = xh
    oxl[...] = xl
    oyh[...] = yh
    oyl[...] = yl
    if resume:
        ouxh[...] = uxh
        ouxl[...] = uxl
        ouyh[...] = uyh
        ouyl[...] = uyl


def _df_launch(pos0, theta0, r, block_rays, field):
    if field not in DF_FIELDS:
        raise ValueError(f"df kernel supports {DF_FIELDS}, got {field!r}")
    if r % block_rays:
        raise ValueError(f"rays {r} not a multiple of block {block_rays}")
    theta0 = jnp.asarray(theta0, jnp.float32)
    return (jnp.asarray(pos0[:, 0], jnp.float32),
            jnp.asarray(pos0[:, 1], jnp.float32),
            jnp.cos(theta0), jnp.sin(theta0))


@functools.partial(jax.jit, static_argnames=("field", "steps", "block_rays",
                                             "interpret"))
def _df_core(pos0, theta0, delta_s, *, field: str, steps: int,
             block_rays: int = 4096, interpret: bool | None = None):
    xh, yh, uxh, uyh = _df_launch(pos0, theta0, pos0.shape[0], block_rays,
                                  field)
    return ray_block_call(
        functools.partial(_df_rk4_kernel, field, steps, False),
        [xh, yh, uxh, uyh], jnp.asarray([delta_s], jnp.float32), 4,
        interpret=interpret, name=f"df32_rk4_{field}")


@functools.partial(jax.jit, static_argnames=("field", "segment", "n_full",
                                             "rem", "block_rays", "interpret"))
def _df_core_segmented(pos0, theta0, delta_s, *, field: str, segment: int,
                       n_full: int, rem: int, block_rays: int = 4096,
                       interpret: bool | None = None):
    """Chain bounded-trip-count resumable df kernels.

    ``segment``-step launches with the full df state riding in device
    memory between them: one ``segment``-sized body (plus one
    ``rem``-sized one) serves ANY trajectory length.  Bit-identical to the
    one-shot kernel: the state is exactly the loop carry.
    """
    xh, yh, uxh, uyh = _df_launch(pos0, theta0, pos0.shape[0], block_rays,
                                  field)
    ds = jnp.asarray([delta_s], jnp.float32)
    zero = jnp.zeros_like(xh)

    def launch(nsteps, st):
        return tuple(ray_block_call(
            functools.partial(_df_rk4_kernel, field, nsteps, True),
            list(st), ds, 8, interpret=interpret,
            name=f"df32_rk4_{field}_resume"))

    st = (xh, zero, yh, zero, uxh, zero, uyh, zero)
    if n_full:
        st = jax.lax.fori_loop(0, n_full,
                               lambda _, s: launch(segment, s), st)
    if rem:
        st = launch(rem, st)
    return st[0], st[1], st[2], st[3]


def df_trace(pos0, theta0, delta_s, *, steps: int,
             field: str = "fisheye", block_rays: int = 4096,
             interpret: bool | None = None, segment: int | None = 512):
    """Double-word RK4 integration; returns float64 final positions
    (hi + lo recombined on host).

    ``segment`` (default 512) runs the trace as chained resumable kernels
    of that many steps; pass ``segment=None`` for the single-launch kernel.
    """
    if segment is not None and steps > segment:
        oxh, oxl, oyh, oyl = _df_core_segmented(
            pos0, theta0, delta_s, field=field, segment=segment,
            n_full=steps // segment, rem=steps % segment,
            block_rays=block_rays, interpret=interpret)
    else:
        oxh, oxl, oyh, oyl = _df_core(
            pos0, theta0, delta_s, field=field, steps=steps,
            block_rays=block_rays, interpret=interpret)

    def comb(h, l):
        return (np.asarray(h, np.float64).reshape(-1)
                + np.asarray(l, np.float64).reshape(-1))

    return np.stack([comb(oxh, oxl), comb(oyh, oyl)], axis=-1)


#: backwards-compatible alias
def df_fisheye_trace(pos0, theta0, delta_s, *, steps, block_rays=4096,
                     interpret=None):
    return df_trace(pos0, theta0, delta_s, steps=steps, field="fisheye",
                    block_rays=block_rays, interpret=interpret)
