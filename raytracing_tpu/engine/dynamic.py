"""Dynamic ray tracing: paraxial spreading, caustics, and amplitudes.

The reference traces ray *kinematics* only — positions and angles
(RT_bench.py:766-948); field amplitudes need the evolution of a ray's
*neighborhood* (dynamic ray tracing in the Cerveny sense), which classic
codes integrate as a separate paraxial (q, p) ODE system driven by second
derivatives of the index.  The reference even scaffolds that input — it
builds bicubic Hessian splines and never uses them (RT_bench.py:459-462,
its only dead code, SURVEY.md §2.17) — but ships no dynamic tier.

Here the whole tier costs no new physics code: because every step method is
a pure JAX function (ops/registry.build_op), the paraxial system IS the
directional derivative of the step map with respect to the launch angle,
and ``jax.jvp`` propagates it *exactly* — the tangent of the discrete
integrator, not a separately-discretized ODE that would drift from the rays
it describes.  Media differentiate automatically too: analytic fields give
closed-form Hessians, spline/C1 media the exact in-cell second derivative
of the evaluated surface (what the reference's dead Hessian splines
approximate), ParametricMedium anything the user wrote.

Quantities per ray:

* ``q(s)``   — transverse geometric spreading, the perpendicular component
  of d(pos)/d(theta0).  Near the source q ~ s in any medium; a zero
  crossing of q is a caustic.
* ``kmah``   — the KMAH index: number of caustics passed (sign changes of
  q), which advances the field's phase by -pi/2 each.
* ``dtheta`` — d(angle)/d(theta0), the paraxial slope (the "p" of the
  classic system in angle form).

Energy flux conservation in a ray tube of width ``|q| dtheta0`` gives the
2-D point-source pressure amplitude ``A = sqrt(n0 / (n |q|))``, normalized
to unit pressure at unit arc length from the source in a locally
homogeneous medium (so in n == n0 exactly, TL(s) = 10 log10 s — cylindrical
spreading).  Amplitude transport assumes ISOTROPIC media; for gamma != 1
the energy velocity is not along the ray and q/kmah remain purely
geometric quantities.

Solver caveat (same as engine/diff.py): the golden-section ops
(op5/op9/op10/op11) are piecewise constant in their cost, so their jvp
tangents are zero almost everywhere — use the smooth solvers (op1-op4,
op6-op8, op12) or the Newton extensions op10n/op11n for dynamic runs.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu import config
from raytracing_tpu.media.fields import anisotropy
from raytracing_tpu.ops import angles as A
from raytracing_tpu.ops.registry import RayPoint, build_op, canonical

#: history row layout of :func:`trace_dynamic` (mode="history")
DYN_COLS = ("x", "y", "traveltime", "angle", "q", "kmah", "n")

#: use the compensated hand-written tangent recursion for op6 (see
#: ``hand_tangent`` in :func:`_build_dynamic_fn`); False restores the
#: plain ``jax.jvp`` tangent for every op
HAND_TANGENT = True


class DynamicResult(NamedTuple):
    """Kinematic + paraxial state after a dynamic trace."""

    pos: Any          # (R, 2) final positions
    angle: Any        # (R,)   final angles
    n: Any            # (R,)   isotropic index at the final position
    traveltime: Any   # (R,)   optical path (trapezoid of coef*n)
    dist_sim: Any     # (R,)   accumulated Euclidean distance
    dist_real: Any    # (R,)   accumulated expected arc length
    exit_step: Any    # (R,)   int32 last written step
    q: Any            # (R,)   transverse spreading d(pos_perp)/d(theta0)
    dtheta: Any       # (R,)   paraxial slope d(angle)/d(theta0)
    kmah: Any         # (R,)   int32 caustic count (sign changes of q)
    n0: Any           # (R,)   index at the source (amplitude reference)
    history: Any      # (max_size, R, 7) DYN_COLS rows, or None

    def amplitude(self):
        """Point-source pressure amplitude at the final position."""
        return spreading_amplitude(self.q, self.n, self.n0)

    def transmission_loss_db(self):
        """-20 log10 of :meth:`amplitude` (dB re unit arc length)."""
        return transmission_loss_db(self.q, self.n, self.n0)


def spreading_amplitude(q, n, n0):
    """2-D point-source amplitude ``sqrt(n0 / (n |q|))``.

    Energy flux through a ray tube of width ``|q| dtheta0`` at sound speed
    ``1/n`` is conserved, so ``|p|^2 |q| / n^{-1}`` is constant along the
    ray; the normalization makes ``p = 1`` at unit arc length from the
    source in a homogeneous medium (where q == s exactly).  At a caustic
    (q == 0) ray theory diverges; the value is clamped to the dtype's
    finite range rather than inf so downstream sums stay finite.
    """
    q = jnp.abs(q)
    tiny = jnp.asarray(np.finfo(jnp.result_type(q)).tiny, q.dtype)
    return jnp.sqrt(n0 / (n * jnp.maximum(q, tiny)))


def transmission_loss_db(q, n, n0):
    """Transmission loss ``10 log10(n |q| / n0)`` dB re unit arc length."""
    q = jnp.abs(q)
    tiny = jnp.asarray(np.finfo(jnp.result_type(q)).tiny, q.dtype)
    return 10.0 * jnp.log10(n * jnp.maximum(q, tiny) / n0)


def _perp(angle):
    """Unit normal to the ray direction: e_perp = (-sin, cos)."""
    return jnp.stack([-jnp.sin(angle), jnp.cos(angle)], axis=-1)


class CrossingFan(NamedTuple):
    """Range-line crossings of a whole fan, recorded ON DEVICE.

    ``depths[r, j, k]`` is the depth of fan ray ``r``'s k-th crossing of
    the range line ``x == ranges[j]`` (nan where the ray crosses fewer
    than k+1 times); ``counts`` the total crossings (which may exceed the
    recorded ``max_ord``).  This is the landing-curve view the eigenray
    bracket scan needs, at O(R x NR x max_ord) readback instead of the
    full (S x R x 7) history.
    """

    depths: Any   # (R, NR, max_ord)
    counts: Any   # (R, NR) int32


#: column order of CrossingPick.state (and the kernels' crossing records)
CROSS_COLS = ("y", "traveltime", "angle", "q", "kmah", "n")


class CrossingPick(NamedTuple):
    """Per-ray state at ITS OWN target crossing, recorded on device.

    Ray ``r`` records the full interpolated state (CROSS_COLS layout; the
    step-quantized kmah is taken from the pre-crossing step, matching
    ``engine.eigenray._pick_crossings``) at its ``min(ordk[r],
    count-1)``-th crossing of ``x == xr[r]`` — the Newton-polish view,
    O(candidates x 6) readback per iteration.
    """

    state: Any    # (R, 6) CROSS_COLS; zero rows where found is False
    found: Any    # (R,) bool: at least one crossing


@functools.lru_cache(maxsize=None)
def _build_dynamic_fn(op_name: str, max_size: int, mode: str,
                      dtype_name: str, max_ord: int = 0):
    """Compile-cached dynamic scan: primal step + exact jvp tangent.

    ``box`` enters ``run`` as a TRACED (4,) operand, not a cache key: the
    eigenray serving endpoint forwards request-supplied boxes, and keying
    the unbounded lru_cache on user floats would pin one compiled scan per
    distinct box for the life of the server.

    ``mode``: "history" / "metrics" as before, plus the two on-device
    crossing-recording modes ("cross_fan" / "cross_pick", see
    :class:`CrossingFan` / :class:`CrossingPick`) whose extra operands
    ride in ``aux`` (the receiver ranges, or the per-ray (xr, ordk)
    targets) — traced, so one compiled scan serves every receiver set of
    the same shape.
    """
    dtype = np.dtype(dtype_name)
    op = build_op(op_name, dtype)
    history = mode == "history"
    cross_fan = mode == "cross_fan"
    cross_pick = mode == "cross_pick"
    # op6 (HySA, the eigenray/TL default) gets the hand-written tangent
    # recursion with compensated accumulators; every other smooth op keeps
    # the exact jax.jvp (see hand_tangent below for why jvp's f32 carry
    # rounding cannot be compensated from outside).  HAND_TANGENT is a
    # module-level escape hatch (tests compare the two directly via
    # ``_build_dynamic_fn.__wrapped__``; flipping the flag at runtime
    # requires clearing the lru cache).
    hand = HAND_TANGENT and op_name == "op6"

    def run(pos0, theta0, medium, gamma, delta_s, step_limit, box,
            aux=None):
        limx_i, limx_s, limy_i, limy_s = box[0], box[1], box[2], box[3]
        pos0 = jnp.asarray(pos0, dtype)
        theta0 = jnp.asarray(theta0, dtype)
        r = theta0.shape[0]

        def launch(th):
            unitv = jnp.stack([jnp.cos(th), jnp.sin(th)], axis=-1)
            n0, (gx, gy) = medium.n_and_grad(pos0[..., 0], pos0[..., 1])
            grad0 = jnp.stack([gx, gy], axis=-1)
            window = (jnp.broadcast_to(pos0[:, None, :], (r, 4, 2))
                      if op.uses_window else None)
            # pos0 enters as a CLOSURE constant: jvp instantiates its
            # tangent as zero, i.e. the source point is held fixed
            return RayPoint(pos=pos0, angle=th, unitv=unitv, n=n0,
                            grad=grad0, coef=anisotropy(th, gamma),
                            window=window)

        # d(launch)/d(theta0): the source point is FIXED (dpos = 0), only
        # the take-off angle varies — the point-source paraxial basis.
        pt0, dpt0 = jax.jvp(launch, (theta0,), (jnp.ones_like(theta0),))
        n_src = pt0.n

        def step_pt(pt, i):
            res = op(pt, i, medium, gamma, delta_s)
            unitv_f = jnp.stack([jnp.cos(res.angle), jnp.sin(res.angle)],
                                axis=-1)
            window = (A.push_window(pt.window, res.pos)
                      if pt.window is not None else None)
            return RayPoint(pos=res.pos, angle=res.angle, unitv=unitv_f,
                            n=res.n, grad=res.grad,
                            coef=anisotropy(res.angle, gamma), window=window)

        def sel(keep, new, old):
            def one(a, b):
                m = keep.reshape(keep.shape + (1,) * (a.ndim - keep.ndim))
                return jnp.where(m, a, b)
            return jax.tree.map(one, new, old)

        def kadd(old, inc, comp):
            """Kahan step: add a TRUE (unrounded-sum) increment.

            Only increments computed *before* any accumulator addition
            qualify — recovering an increment from an already-rounded sum
            (``new - old``) is exactly vacuous (Fast2Sum: re-adding it
            reproduces the same rounded sum bit-for-bit).  With true
            increments the compensation removes the per-step carry
            rounding whose random walk over ~4k steps was the measured
            floors (traveltime 9.0e-6 -> 8.2e-8 rel in the same log).
            """
            y = inc - comp
            t = old + y
            return t, (t - old) - y

        def hand_step(pt, dpt, comps, i):
            """op6's step AND paraxial tangent with compensated carries.

            ``jax.jvp`` propagates the tangent exactly in REAL arithmetic
            but its f32 carry additions round inside the traced step
            where no compensation can reach — and the measured amplitude
            floor turned out to be slaved to the PRIMAL f32 trajectory
            (Kahan on the tangents alone moved it 2.28e-5 -> 2.20e-5
            only) — so for the eigenray op the WHOLE step is
            written out by hand: the same discrete map as the op
            (ops/steppers.second_order_taylor + ops/angles.tfinal_2o,
            f64-equal to the op path) with Kahan carries on all four
            accumulators — primal (pos, angle), the kernel tier's proven
            primal treatment (kernels/fused.py), and tangent
            (dpos, dangle).  Field values and their exact directional
            derivatives along dpos come from one ``jax.jvp`` of
            ``medium.n_and_grad`` per evaluation point — per-step
            functions, no accumulation.  Isotropic by construction
            (op6); the anisotropy channel never enters the map.
            """
            cpp, cpa, cdp, cda, ctt = comps
            ds = delta_s
            a = pt.angle
            ux, uy = pt.unitv[..., 0], pt.unitv[..., 1]
            dpx, dpy = dpt.pos[..., 0], dpt.pos[..., 1]
            da = dpt.angle
            dux, duy = -da * uy, da * ux
            (n, (gx, gy)), (dn, (dgx, dgy)) = jax.jvp(
                medium.n_and_grad,
                (pt.pos[..., 0], pt.pos[..., 1]), (dpx, dpy))

            # second_order_taylor increment: D = u ds + T ds^2/(2n),
            # T = g - (g.u)u — and its tangent
            gdotu = gx * ux + gy * uy
            tx = gx - gdotu * ux
            ty = gy - gdotu * uy
            dgdotu = dgx * ux + dgy * uy + gx * dux + gy * duy
            dtx = dgx - dgdotu * ux - gdotu * dux
            dty = dgy - dgdotu * uy - gdotu * duy
            inv_n = 1.0 / n
            half = ds * ds * 0.5 * inv_n
            dd = jnp.stack([ux * ds + tx * half, uy * ds + ty * half], -1)
            ddp = jnp.stack([dux * ds + (dtx - tx * dn * inv_n) * half,
                             duy * ds + (dty - ty * dn * inv_n) * half],
                            -1)
            pos_c, cpp_n = kadd(pt.pos, dd, cpp)
            dpos_c, cdp_n = kadd(dpt.pos, ddp, cdp)

            # field value + tangent at the stepped point (one jvp serves
            # the primal k2 and its derivative along the NEW dpos)
            (n2, (gx2, gy2)), (dn2, (dgx2, dgy2)) = jax.jvp(
                medium.n_and_grad,
                (pos_c[..., 0], pos_c[..., 1]),
                (dpos_c[..., 0], dpos_c[..., 1]))

            # tfinal_2o: k1 = ds (ca gy - sa gx)/n at the start point,
            # k2 the same form at (angle + k1, stepped point)
            ca, sa = ux, uy              # unitv IS (cos a, sin a)
            c1 = ca * gy - sa * gx
            k1 = ds * c1 * inv_n
            dc1 = da * (-sa * gy - ca * gx) + ca * dgy - sa * dgx
            dk1 = ds * (dc1 - c1 * dn * inv_n) * inv_n
            a1 = a + k1
            ca1, sa1 = jnp.cos(a1), jnp.sin(a1)
            inv_n2 = 1.0 / n2
            c2 = ca1 * gy2 - sa1 * gx2
            k2 = ds * c2 * inv_n2
            dc2 = ((da + dk1) * (-sa1 * gy2 - ca1 * gx2)
                   + ca1 * dgy2 - sa1 * dgx2)
            dk2 = ds * (dc2 - c2 * dn2 * inv_n2) * inv_n2
            ang_c, cpa_n = kadd(a, (k1 + k2) * 0.5, cpa)
            dang_c, cda_n = kadd(dpt.angle, (dk1 + dk2) * 0.5, cda)

            unitv_n = jnp.stack([jnp.cos(ang_c), jnp.sin(ang_c)], -1)
            pt_n = RayPoint(pos=pos_c, angle=ang_c, unitv=unitv_n, n=n2,
                            grad=jnp.stack([gx2, gy2], -1),
                            coef=anisotropy(ang_c, gamma), window=None)
            uperp = jnp.stack([-unitv_n[..., 1], unitv_n[..., 0]], -1)
            dpt_n = dpt._replace(
                pos=dpos_c, angle=dang_c,
                unitv=dang_c[..., None] * uperp, n=dn2,
                grad=jnp.stack([dgx2, dgy2], -1))
            return pt_n, dpt_n, (cpp_n, cpa_n, cdp_n, cda_n, ctt)

        def body(carry, i):
            (pt, dpt, tt, dsim, dreal, active, exit_step, sgn,
             kmah) = carry[:9]
            comps = carry[9]
            cross = carry[10:]
            if hand:
                pt_n, dpt_n, comps_n = hand_step(pt, dpt, comps, i)
            else:
                pt_n, dpt_n = jax.jvp(lambda p: step_pt(p, i),
                                      (pt,), (dpt,))
                comps_n = comps

            # traveltime's increment is formed here, BEFORE the carry
            # addition — a true increment, so Kahan applies in both modes
            dist = jnp.linalg.norm(pt_n.pos - pt.pos, axis=-1)
            tt_inc = dist * (pt.coef * pt.n + pt_n.coef * pt_n.n) / 2.0
            tt_n, ctt_n = kadd(tt, tt_inc, comps_n[4])
            comps_n = comps_n[:4] + (ctt_n,)

            pt2 = sel(active, pt_n, pt)
            dpt2 = sel(active, dpt_n, dpt)
            tt2 = jnp.where(active, tt_n, tt)
            comps2 = tuple(
                jnp.where(active.reshape(active.shape
                                         + (1,) * (c.ndim - active.ndim)),
                          c, o)
                for c, o in zip(comps_n, comps))
            dsim2 = jnp.where(active, dsim + dist, dsim)
            dreal2 = jnp.where(active, dreal + delta_s, dreal)

            q = jnp.sum(dpt2.pos * _perp(pt2.angle), axis=-1)
            s_new = jnp.sign(q).astype(jnp.int8)
            flip = active & (sgn != 0) & (s_new != 0) & (s_new != sgn)
            kmah2 = kmah + flip.astype(jnp.int32)
            sgn2 = jnp.where(active & (s_new != 0), s_new, sgn)

            x, y = pt2.pos[..., 0], pt2.pos[..., 1]
            out = (x > limx_s) | (x < limx_i) | (y > limy_s) | (y < limy_i)
            newly_exited = active & out
            exit2 = jnp.where(newly_exited, i, exit_step)
            active2 = active & ~out & (i < step_limit)

            # -- on-device crossing records --------------------------------
            # frozen rays self-exclude: pt2 == pt gives d0, d1 the same
            # sign, which matches the host scan's step_ok masking (the
            # exit step itself still counts, exactly as `step_ok` includes
            # j = last-1).  The predicate is a SIGN TRANSITION, not
            # d0*d1 < 0: a step landing EXACTLY on the range line must
            # count once (frac = 1), or the arrival vanishes — the
            # compensated position carries make exact landings routine
            # when delta_s and the range are commensurate (x after 50
            # Kahan steps of fl(0.02) IS 1.0; found by the axial-arrival
            # eigenray test the day the carries landed).
            if cross_fan or cross_pick:
                x0, x1 = pt.pos[..., 0], pt2.pos[..., 0]
            if cross_fan:
                cnt, depths = cross
                ranges = aux
                d0 = x0[:, None] - ranges[None, :]
                d1 = x1[:, None] - ranges[None, :]
                hit = (d0 < 0) != (d1 < 0)
                frac = jnp.where(
                    hit, d0 / jnp.where(hit, (x0 - x1)[:, None], 1.0), 0.0)
                ycross = (pt.pos[..., 1][:, None]
                          + frac * (pt2.pos[..., 1]
                                    - pt.pos[..., 1])[:, None])
                oh = hit[:, :, None] & (cnt[:, :, None] == jnp.arange(
                    max_ord, dtype=jnp.int32)[None, None, :])
                cross = (cnt + hit.astype(jnp.int32),
                         jnp.where(oh, ycross[:, :, None], depths))
            elif cross_pick:
                cnt, rec = cross
                xr, ordk = aux
                d0, d1 = x0 - xr, x1 - xr
                hit = (d0 < 0) != (d1 < 0)
                frac = jnp.where(hit, d0 / jnp.where(hit, x0 - x1, 1.0),
                                 0.0)
                q0 = jnp.sum(dpt.pos * _perp(pt.angle), axis=-1)

                def lerp(a, b):
                    return a + frac * (b - a)

                row = jnp.stack([
                    lerp(pt.pos[..., 1], pt2.pos[..., 1]),
                    lerp(tt, tt2),
                    lerp(pt.angle, pt2.angle),
                    lerp(q0, q),
                    kmah.astype(dtype),   # pre-crossing step (host's h0)
                    lerp(pt.n, pt2.n),
                ], axis=-1)
                # the LAST crossing with ordinal <= ordk is exactly
                # min(ordk, count - 1): the host _pick_crossings fallback
                take = hit & (cnt <= ordk)
                cross = (cnt + hit.astype(jnp.int32),
                         jnp.where(take[:, None], row, rec))

            carry2 = (pt2, dpt2, tt2, dsim2, dreal2, active2, exit2,
                      sgn2, kmah2, comps2) + cross
            if history:
                # rows FREEZE after exit (unlike the parity engine's zero
                # rows, RT_bench.py:800-805) — frozen rows interpolate
                # cleanly in the eigenray range scan
                row = jnp.stack([x, y, tt2, pt2.angle, q,
                                 kmah2.astype(dtype), pt2.n], axis=-1)
                return carry2, row
            return carry2, None

        # *_like constructors: under shard_map the carry inits must inherit
        # theta0's varying mesh axes or the scan rejects the carry types
        active0 = jnp.ones_like(theta0, dtype=bool)
        exit0 = jnp.minimum(jnp.full_like(theta0, max_size - 1,
                                          dtype=jnp.int32), step_limit)
        sgn0 = jnp.zeros_like(theta0, dtype=jnp.int8)
        kmah0 = jnp.zeros_like(theta0, dtype=jnp.int32)
        zeros = jnp.zeros_like(theta0)
        if cross_fan:
            nr = aux.shape[0]
            cross0 = (jnp.zeros(theta0.shape + (nr,), jnp.int32),
                      jnp.full(theta0.shape + (nr, max_ord), jnp.nan,
                               dtype))
        elif cross_pick:
            cross0 = (jnp.zeros_like(theta0, dtype=jnp.int32),
                      jnp.zeros(theta0.shape + (6,), dtype))
        else:
            cross0 = ()
        comps0 = (jnp.zeros_like(pt0.pos), zeros,
                  jnp.zeros_like(pt0.pos), zeros, zeros)
        carry0 = (pt0, dpt0, zeros, zeros, zeros, active0, exit0, sgn0,
                  kmah0, comps0) + cross0
        steps = jnp.arange(1, max_size, dtype=jnp.int32)
        finalc, rows = jax.lax.scan(body, carry0, steps)
        (ptf, dptf, ttf, dsimf, drealf, _, exitf, _, kmahf) = finalc[:9]
        if cross_fan:
            return CrossingFan(depths=finalc[11], counts=finalc[10])
        if cross_pick:
            return CrossingPick(state=finalc[11], found=finalc[10] > 0)

        qf = jnp.sum(dptf.pos * _perp(ptf.angle), axis=-1)
        if history:
            row0 = jnp.stack([pt0.pos[..., 0], pt0.pos[..., 1], zeros,
                              pt0.angle, zeros, zeros, pt0.n], axis=-1)
            hist = jnp.concatenate([row0[None], rows], axis=0)
        else:
            hist = None
        return DynamicResult(pos=ptf.pos, angle=ptf.angle, n=ptf.n,
                             traveltime=ttf, dist_sim=dsimf,
                             dist_real=drealf, exit_step=exitf, q=qf,
                             dtheta=dptf.angle, kmah=kmahf, n0=n_src,
                             history=hist)

    return run, jax.jit(run)


def trace_dynamic(op_name: str, scen: config.ScenarioConfig, medium, *,
                  delta_s: float, divisor: int | None = None,
                  n_turns: int = config.N_TURNS, mode: str = "history",
                  dtype=np.float32, pos0=None, theta0=None,
                  step_limit: int | None = None, max_size: int | None = None,
                  jit: bool = True) -> DynamicResult:
    """Trace rays AND their paraxial neighborhoods (spreading/caustics).

    Same launch interface as :func:`engine.trace.trace`; the result adds
    the dynamic quantities ``q`` (transverse spreading), ``dtheta``
    (paraxial slope) and ``kmah`` (caustic count), from which
    :func:`spreading_amplitude` / :func:`transmission_loss_db` derive the
    point-source field along each ray.  Cost is ~2x a kinematic trace (one
    exact jvp tangent rides through every step).
    """
    op_name = canonical(op_name)
    dtype = np.dtype(dtype)
    if mode not in ("history", "metrics"):
        raise ValueError(f"mode must be 'history' or 'metrics', got {mode!r}")
    if max_size is None:
        max_size = scen.max_size(delta_s, divisor, n_turns)
    if step_limit is None:
        step_limit = max_size - 1
    if pos0 is None:
        pos0 = scen.pos0
    if theta0 is None:
        theta0 = scen.theta0

    run, run_jit = _build_dynamic_fn(op_name, int(max_size), mode,
                                     dtype.name)
    fn = run_jit if jit else run
    return fn(jnp.asarray(pos0, dtype), jnp.asarray(theta0, dtype), medium,
              jnp.asarray(scen.gamma, dtype), jnp.asarray(delta_s, dtype),
              jnp.asarray(step_limit, jnp.int32),
              jnp.asarray(tuple(scen.box), dtype))


def _crossing_args(scen, delta_s, dtype, pos0, theta0, step_limit,
                   max_size, divisor, n_turns):
    dtype = np.dtype(dtype)
    if max_size is None:
        max_size = scen.max_size(delta_s, divisor, n_turns)
    if step_limit is None:
        step_limit = max_size - 1
    if pos0 is None:
        pos0 = scen.pos0
    if theta0 is None:
        theta0 = scen.theta0
    return dtype, int(max_size), int(step_limit), (
        jnp.asarray(pos0, dtype), jnp.asarray(theta0, dtype))


def trace_crossings_fan(op_name: str, scen: config.ScenarioConfig, medium,
                        *, delta_s: float, ranges, max_ord: int = 8,
                        divisor: int | None = None,
                        n_turns: int = config.N_TURNS, dtype=np.float32,
                        pos0=None, theta0=None,
                        step_limit: int | None = None,
                        max_size: int | None = None) -> CrossingFan:
    """Dynamic fan trace that records range-line crossings ON DEVICE.

    The eigenray bracket scan's input (every fan ray's landing depths at
    every receiver range, per crossing ordinal up to ``max_ord``) without
    materializing the (S, R, 7) history: the crossing detection and linear
    interpolation run inside the scan, so only (R, NR, max_ord) comes back
    — a few hundred KB per Newton iteration instead of a 100+ MB
    history readback.  Crossings beyond
    ``max_ord`` per (ray, range) are counted but not recorded; raise it
    for loopy multi-turn traces.
    """
    op_name = canonical(op_name)
    dtype, max_size, step_limit, (p0, t0) = _crossing_args(
        scen, delta_s, dtype, pos0, theta0, step_limit, max_size,
        divisor, n_turns)
    _, run_jit = _build_dynamic_fn(op_name, max_size, "cross_fan",
                                   dtype.name, int(max_ord))
    return run_jit(p0, t0, medium, jnp.asarray(scen.gamma, dtype),
                   jnp.asarray(delta_s, dtype),
                   jnp.asarray(step_limit, jnp.int32),
                   jnp.asarray(tuple(scen.box), dtype),
                   aux=jnp.asarray(ranges, dtype))


def trace_crossings_pick(op_name: str, scen: config.ScenarioConfig, medium,
                         *, delta_s: float, xr, ordk,
                         divisor: int | None = None,
                         n_turns: int = config.N_TURNS, dtype=np.float32,
                         pos0=None, theta0=None,
                         step_limit: int | None = None,
                         max_size: int | None = None) -> CrossingPick:
    """Dynamic trace recording each ray's own target crossing on device.

    The Newton-polish view: candidate ray ``r`` brings home the full
    interpolated state (:data:`CROSS_COLS`) at its ``ordk[r]``-th crossing
    of ``x == xr[r]`` — O(candidates x 6) per iteration instead of the
    full history (the semantics of ``engine.eigenray._pick_crossings``,
    including the fall-back to the last crossing when the path has fewer
    than ``ordk`` of them).
    """
    op_name = canonical(op_name)
    dtype, max_size, step_limit, (p0, t0) = _crossing_args(
        scen, delta_s, dtype, pos0, theta0, step_limit, max_size,
        divisor, n_turns)
    _, run_jit = _build_dynamic_fn(op_name, max_size, "cross_pick",
                                   dtype.name)
    return run_jit(p0, t0, medium, jnp.asarray(scen.gamma, dtype),
                   jnp.asarray(delta_s, dtype),
                   jnp.asarray(step_limit, jnp.int32),
                   jnp.asarray(tuple(scen.box), dtype),
                   aux=(jnp.asarray(xr, dtype),
                        jnp.asarray(ordk, jnp.int32)))
