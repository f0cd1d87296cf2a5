"""3-D dynamic ray tracing: the 2x2 paraxial Jacobian, exactly.

The 3-D twin of :mod:`engine.dynamic`: a point source's neighborhood is
two-parameter (two launch angles), so the spreading is the 2x2 Jacobian
``Q_ij = e_i . d(pos)/d(alpha_j)`` — transverse displacement per launch
angle, per transverse direction.  Both tangents ride through the step map
as exact ``jax.jvp`` directional derivatives of the DISCRETE integrator
(engine/trace3d._step3), so no separately-discretized paraxial ODE can
drift from the rays it describes; any differentiable 3-D medium works
(analytic, Custom3D autodiff, Stratified3D over measured tables).

Geometry of the outputs:

* ``det Q``  — the ray-tube area per unit solid angle; |det Q| -> s^2
  near the source in any medium.  A SIGN CHANGE of det Q is a caustic
  (KMAH +1).  Degenerate POINT foci (both transverse dimensions
  collapsing at once, e.g. the Maxwell fisheye's perfect image) make
  det Q touch zero quadratically without a sign change — physically a
  +2 KMAH event that sign-counting cannot see; the tracked minimum
  |det Q| (and its step) localizes such foci instead.
* amplitude — energy-flux conservation through the tube gives
  ``A = sqrt(n0 / (n |det Q|))``, normalized to unit pressure at unit
  arc length in a homogeneous medium (TL(s) = 20 log10 s, spherical
  spreading — the 3-D counterpart of the 2-D tier's 10 log10 s).

The transverse frame (e1, e2) is carried in the scan and re-orthogonalized
against the advancing tangent each step (Gram-Schmidt transport): smooth,
so the sign of det Q never flips from a frame jump; |det Q| itself is
invariant to the frame choice.

Solver caveat as in 2-D: golden-section ops have zero jvp tangents a.e.;
trace3d's method set (op1/op2/op6/op8) is all smooth, so every 3-D method
is dynamic-capable.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu.engine.trace3d import (_eval3, _normalize, _step3,
                                           METHODS3, canonical3)

#: history row layout of :func:`trace_dynamic3` (mode="history")
DYN3_COLS = ("x", "y", "z", "traveltime", "n", "detq", "kmah")
#: extended layout (``full_history=True``): + the unit tangent and the raw
#: position tangents d(pos)/d(alpha), d(pos)/d(beta) — what the 3-D
#: eigenray Newton needs at a range-plane crossing (engine/eigenray3d.py)
DYN3_FULL_COLS = DYN3_COLS + ("ux", "uy", "uz",
                              "dpax", "dpay", "dpaz",
                              "dpbx", "dpby", "dpbz")
#: on-device crossing-record layout (mode="cross_pick"): everything the
#: 3-D eigenray Gauss-Newton consumes at a range-plane crossing, linearly
#: interpolated between the bracketing steps — the 3-D twin of
#: engine.dynamic.CROSS_COLS.  ``kmah`` is the PRE-crossing count.
CROSS3_COLS = ("y", "z", "traveltime", "n", "detq", "kmah",
               "ux", "uy", "uz", "dpax", "dpay", "dpaz",
               "dpbx", "dpby", "dpbz")


class Crossing3Fan(NamedTuple):
    """Fan landing records: (y, z) per (ray, range, crossing ordinal)."""

    depths: Any       # (R, NR, max_ord, 2) f; nan where not recorded
    counts: Any       # (R, NR) int32 total crossings (may exceed max_ord)


class Crossing3Pick(NamedTuple):
    """Per-ray target-crossing state rows (:data:`CROSS3_COLS`)."""

    state: Any        # (R, 15)
    found: Any        # (R,) bool: the ray crossed its range at least once


class Dynamic3Result(NamedTuple):
    pos: Any          # (R, 3)
    unitv: Any        # (R, 3)
    n: Any            # (R,)
    traveltime: Any   # (R,)
    dist_real: Any    # (R,)
    dist_sim: Any     # (R,) sum of per-step |D| (== dist_real for
                      # first-order position updates; larger for the
                      # second-order op6/op8 step — the kernel tiers'
                      # dist_sim semantics, kernels/fused3d)
    exit_step: Any    # (R,) int32
    Q: Any            # (R, 2, 2) paraxial Jacobian in the transported frame
    detq: Any         # (R,) det Q
    kmah: Any         # (R,) int32: sign changes of det Q
    min_absdet: Any   # (R,) smallest |det Q| seen after the source regime
    min_absdet_step: Any  # (R,) int32 step of that minimum (focus locator)
    n0: Any           # (R,)
    history: Any      # (max_size, R, 7) DYN3_COLS rows, or None

    def amplitude(self):
        return spreading_amplitude3(self.detq, self.n, self.n0)

    def transmission_loss_db(self):
        return transmission_loss3_db(self.detq, self.n, self.n0)


def spreading_amplitude3(detq, n, n0):
    """Point-source amplitude ``sqrt(n0 / (n |det Q|))`` (3-D tube)."""
    d = jnp.abs(detq)
    tiny = jnp.asarray(np.finfo(jnp.result_type(d)).tiny, d.dtype)
    return jnp.sqrt(n0 / (n * jnp.maximum(d, tiny)))


def transmission_loss3_db(detq, n, n0):
    """``10 log10(n |det Q| / n0)`` — 20 log10 s in a homogeneous medium."""
    d = jnp.abs(detq)
    tiny = jnp.asarray(np.finfo(jnp.result_type(d)).tiny, d.dtype)
    return 10.0 * jnp.log10(n * jnp.maximum(d, tiny) / n0)


def _transverse_frame(u):
    """A stable orthonormal (e1, e2) transverse to ``u`` at launch."""
    # seed axis: the unit axis least aligned with u (stable, branch-free)
    a = jnp.abs(u)
    seed = jax.nn.one_hot(jnp.argmin(a, axis=-1), 3, dtype=u.dtype)
    e1 = _normalize(jnp.cross(seed, u))
    e2 = jnp.cross(u, e1)
    return e1, e2


@functools.lru_cache(maxsize=None)
def _build_dynamic3_fn(method: str, max_size: int, box, mode: str,
                       dtype_name: str, full_history: bool = False,
                       max_ord: int = 8):
    dtype = np.dtype(dtype_name)
    order, solver = METHODS3[method]
    history = mode == "history"
    cross_fan = mode == "cross_fan"
    cross_pick = mode == "cross_pick"

    def run(pos0, dir0, medium, delta_s, step_limit, aux=None):
        pos0 = jnp.asarray(pos0, dtype)
        u0 = _normalize(jnp.asarray(dir0, dtype))
        e1, e2 = _transverse_frame(u0)

        def launch(a, b):
            # two-angle launch chart: rotate u0 toward e1 by a, e2 by b;
            # at (0, 0) the derivative pair is exactly (e1, e2)
            u = _normalize(u0 + a[..., None] * e1 + b[..., None] * e2)
            n0, g0 = _eval3(medium, pos0)
            return pos0, u, n0, g0

        # *_like constructors: under shard_map the carry inits must inherit
        # the launch arrays' varying mesh axes (engine/trace3d.py rule)
        zeros = jnp.zeros_like(pos0[..., 0])
        ones = jnp.ones_like(pos0[..., 0])
        pt0, t1 = jax.jvp(lambda a: launch(a, zeros), (zeros,), (ones,))
        _, t2 = jax.jvp(lambda b: launch(zeros, b), (zeros,), (ones,))
        n_src = pt0[2]

        def step(pt, i):
            return _step3(order, solver, pt, medium, delta_s)

        def sel(keep, new, old):
            def one(a, b):
                m = keep.reshape(keep.shape + (1,) * (a.ndim - keep.ndim))
                return jnp.where(m, a, b)
            return jax.tree.map(one, new, old)

        def q_of(pt, tans, frame):
            e1c, e2c = frame
            cols = []
            for t in tans:
                dpos = t[0]
                cols.append(jnp.stack([jnp.sum(dpos * e1c, -1),
                                       jnp.sum(dpos * e2c, -1)], -1))
            return jnp.stack(cols, -1)      # (R, 2, 2): rows e_i, cols alpha_j

        def body(carry, i):
            (pt, ta, tb, tt, dreal, dsim, active, exit_step, e1c, e2c,
             sgn, kmah, mind, minstep) = carry[:14]
            cross = carry[14:]
            frame0 = (e1c, e2c)    # pre-step frame (e1c/e2c rebind below)
            pt_a, ta_n = jax.jvp(lambda p: step(p, i), (pt,), (ta,))
            _, tb_n = jax.jvp(lambda p: step(p, i), (pt,), (tb,))

            pos2, u2, n2, _ = pt_a
            dist = jnp.linalg.norm(pos2 - pt[0], axis=-1)
            tt_n = tt + dist * (pt[2] + n2) / 2.0

            pt2 = sel(active, pt_a, pt)
            ta2 = sel(active, ta_n, ta)
            tb2 = sel(active, tb_n, tb)
            tt2 = jnp.where(active, tt_n, tt)
            dreal2 = jnp.where(active, dreal + delta_s, dreal)
            dsim2 = jnp.where(active, dsim + dist, dsim)

            # Gram-Schmidt transport of the transverse frame (smooth: the
            # sign of det Q cannot flip from a frame jump)
            un = pt2[1]
            e1n = _normalize(e1c - jnp.sum(e1c * un, -1, keepdims=True) * un)
            e2n = jnp.cross(un, e1n)
            e1c = jnp.where(active[..., None], e1n, e1c)
            e2c = jnp.where(active[..., None], e2n, e2c)

            Q = q_of(pt2, (ta2, tb2), (e1c, e2c))
            det = Q[..., 0, 0] * Q[..., 1, 1] - Q[..., 0, 1] * Q[..., 1, 0]
            s_new = jnp.sign(det).astype(jnp.int8)
            flip = active & (sgn != 0) & (s_new != 0) & (s_new != sgn)
            kmah2 = kmah + flip.astype(jnp.int32)
            sgn2 = jnp.where(active & (s_new != 0), s_new, sgn)
            # focus locator: track min |det| once past the source regime
            # (|det| grows ~s^2 from 0; only look after a few steps)
            past_src = i > 4
            better = active & past_src & (jnp.abs(det) < mind)
            mind2 = jnp.where(better, jnp.abs(det), mind)
            minstep2 = jnp.where(better, i, minstep)

            if box is None:
                out = jnp.zeros_like(active)
            else:
                x, y, z = pos2[..., 0], pos2[..., 1], pos2[..., 2]
                out = ((x < box[0]) | (x > box[1]) | (y < box[2])
                       | (y > box[3]) | (z < box[4]) | (z > box[5]))
                out = jnp.where(active, out, False)
            exit2 = jnp.where(active & out, i, exit_step)
            active2 = active & ~out & (i < step_limit)

            if cross_fan or cross_pick:
                # range-plane crossing this step: pre-step x (pt) vs
                # post-select x (pt2) — frozen rays have x0 == x1, no hit
                x0 = pt[0][..., 0]
                x1 = pt2[0][..., 0]

            if cross_fan:
                cnt, depths = cross
                ranges = aux
                d0 = x0[:, None] - ranges[None, :]
                d1 = x1[:, None] - ranges[None, :]
                hit = (d0 < 0) != (d1 < 0)
                frac = jnp.where(
                    hit, d0 / jnp.where(hit, (x0 - x1)[:, None], 1.0), 0.0)
                ycross = (pt[0][..., 1][:, None]
                          + frac * (pt2[0][..., 1] - pt[0][..., 1])[:, None])
                zcross = (pt[0][..., 2][:, None]
                          + frac * (pt2[0][..., 2] - pt[0][..., 2])[:, None])
                oh = hit[:, :, None] & (cnt[:, :, None] == jnp.arange(
                    max_ord, dtype=jnp.int32)[None, None, :])
                yz = jnp.stack([ycross, zcross], -1)       # (R, NR, 2)
                cross = (cnt + hit.astype(jnp.int32),
                         jnp.where(oh[..., None], yz[:, :, None, :],
                                   depths))
            elif cross_pick:
                cnt, rec = cross
                xr, ordk = aux
                d0, d1 = x0 - xr, x1 - xr
                hit = (d0 < 0) != (d1 < 0)
                frac = jnp.where(hit, d0 / jnp.where(hit, x0 - x1, 1.0),
                                 0.0)
                # pre-step det Q in the PRE-step frame (the lerp partner)
                Q0 = q_of(pt, (ta, tb), frame0)
                det0 = (Q0[..., 0, 0] * Q0[..., 1, 1]
                        - Q0[..., 0, 1] * Q0[..., 1, 0])

                def lerp(a, b):
                    return a + frac * (b - a)

                row = jnp.stack(
                    [lerp(pt[0][..., 1], pt2[0][..., 1]),
                     lerp(pt[0][..., 2], pt2[0][..., 2]),
                     lerp(tt, tt2),
                     lerp(pt[2], pt2[2]),
                     lerp(det0, det),
                     kmah.astype(dtype)]                 # pre-crossing
                    + [lerp(pt[1][..., k], pt2[1][..., k])
                       for k in range(3)]
                    + [lerp(ta[0][..., k], ta2[0][..., k])
                       for k in range(3)]
                    + [lerp(tb[0][..., k], tb2[0][..., k])
                       for k in range(3)], axis=-1)
                # the LAST crossing with ordinal <= ordk (the
                # _pick_crossings fall-back semantics, engine/eigenray.py)
                take = hit & (cnt <= ordk)
                cross = (cnt + hit.astype(jnp.int32),
                         jnp.where(take[:, None], row, rec))

            carry2 = (pt2, ta2, tb2, tt2, dreal2, dsim2, active2, exit2,
                      e1c, e2c, sgn2, kmah2, mind2, minstep2) + cross
            if history:
                cols = [pt2[0][..., 0], pt2[0][..., 1], pt2[0][..., 2],
                        tt2, pt2[2], det, kmah2.astype(dtype)]
                if full_history:
                    cols += [pt2[1][..., k] for k in range(3)]
                    cols += [ta2[0][..., k] for k in range(3)]
                    cols += [tb2[0][..., k] for k in range(3)]
                row = jnp.stack(cols, -1)
                return carry2, row
            return carry2, None

        active0 = jnp.ones_like(n_src, dtype=bool)
        exit0 = jnp.minimum(jnp.full_like(n_src, max_size - 1
                                          ).astype(jnp.int32), step_limit)
        if cross_fan:
            nr = aux.shape[0]
            cross0 = (jnp.zeros(n_src.shape + (nr,), jnp.int32),
                      jnp.full(n_src.shape + (nr, max_ord, 2), jnp.nan,
                               dtype))
        elif cross_pick:
            cross0 = (jnp.zeros_like(n_src, dtype=jnp.int32),
                      jnp.zeros(n_src.shape + (len(CROSS3_COLS),), dtype))
        else:
            cross0 = ()
        carry0 = (pt0, t1, t2, zeros, zeros, zeros, active0, exit0, e1,
                  e2,
                  jnp.zeros_like(n_src, dtype=jnp.int8),
                  jnp.zeros_like(n_src, dtype=jnp.int32),
                  jnp.full_like(n_src, np.inf),
                  jnp.zeros_like(n_src, dtype=jnp.int32)) + cross0
        steps = jnp.arange(1, max_size, dtype=jnp.int32)
        finalc, rows = jax.lax.scan(body, carry0, steps)
        if cross_fan:
            return Crossing3Fan(depths=finalc[15], counts=finalc[14])
        if cross_pick:
            return Crossing3Pick(state=finalc[15], found=finalc[14] > 0)
        (ptf, taf, tbf, ttf, drealf, dsimf, _, exitf, e1f, e2f, _, kmahf,
         mindf, minstepf) = finalc[:14]

        Qf = q_of(ptf, (taf, tbf), (e1f, e2f))
        detf = (Qf[..., 0, 0] * Qf[..., 1, 1]
                - Qf[..., 0, 1] * Qf[..., 1, 0])
        if history:
            cols0 = [pt0[0][..., 0], pt0[0][..., 1], pt0[0][..., 2],
                     zeros, pt0[2], zeros, zeros]
            if full_history:
                cols0 += [pt0[1][..., k] for k in range(3)]
                cols0 += [t1[0][..., k] for k in range(3)]
                cols0 += [t2[0][..., k] for k in range(3)]
            row0 = jnp.stack(cols0, -1)
            hist = jnp.concatenate([row0[None], rows], axis=0)
        else:
            hist = None
        return Dynamic3Result(pos=ptf[0], unitv=ptf[1], n=ptf[2],
                              traveltime=ttf, dist_real=drealf,
                              dist_sim=dsimf,
                              exit_step=exitf, Q=Qf, detq=detf,
                              kmah=kmahf, min_absdet=mindf,
                              min_absdet_step=minstepf, n0=n_src,
                              history=hist)

    return run, jax.jit(run)


def trace_dynamic3(method: str, medium, *, pos0, dir0, delta_s: float,
                   steps: int, box=None, mode: str = "history",
                   dtype=np.float64, step_limit: int | None = None,
                   full_history: bool = False,
                   jit: bool = True) -> Dynamic3Result:
    """Trace 3-D rays AND their 2x2 paraxial Jacobians.

    Launch interface mirrors :func:`engine.trace3d.trace3d`; the result
    adds ``Q`` / ``det Q`` (tube area per solid angle), the KMAH count
    (det sign changes), a focus locator (minimum |det Q| and its step),
    and spherical-spreading amplitude/TL.  Cost ~3x a kinematic trace
    (two exact jvp tangents per step).
    """
    method = canonical3(method)
    dtype = np.dtype(dtype)
    if mode not in ("history", "metrics"):
        raise ValueError(f"mode must be 'history' or 'metrics', got {mode!r}")
    pos0 = jnp.asarray(pos0, dtype)
    dir0 = jnp.asarray(dir0, dtype)
    if pos0.ndim != 2 or pos0.shape[-1] != 3 or dir0.shape != pos0.shape:
        raise ValueError(f"pos0/dir0 must both be (rays, 3), got "
                         f"{pos0.shape} / {dir0.shape}")
    max_size = int(steps) + 1
    if step_limit is None:
        step_limit = max_size - 1
    box_t = tuple(float(b) for b in box) if box is not None else None
    if box_t is not None and len(box_t) != 6:
        raise ValueError(f"box must be 6 floats (x0,x1,y0,y1,z0,z1), "
                         f"got {box!r}")
    run, run_jit = _build_dynamic3_fn(method, max_size, box_t, mode,
                                      dtype.name, bool(full_history))
    fn = run_jit if jit else run
    return fn(pos0, dir0, medium, jnp.asarray(delta_s, dtype),
              jnp.asarray(step_limit, jnp.int32))


def _cross3_args(method, pos0, dir0, steps, box, step_limit, dtype):
    method = canonical3(method)
    dtype = np.dtype(dtype)
    pos0 = jnp.asarray(pos0, dtype)
    dir0 = jnp.asarray(dir0, dtype)
    max_size = int(steps) + 1
    if step_limit is None:
        step_limit = max_size - 1
    box_t = tuple(float(b) for b in box) if box is not None else None
    return method, dtype, pos0, dir0, max_size, int(step_limit), box_t


def trace_crossings_fan3(method: str, medium, *, pos0, dir0,
                         delta_s: float, steps: int, ranges,
                         max_ord: int = 8, box=None, dtype=np.float64,
                         step_limit: int | None = None) -> Crossing3Fan:
    """3-D dynamic fan trace recording range-plane crossings ON DEVICE.

    The 3-D twin of :func:`engine.dynamic.trace_crossings_fan`: every fan
    ray's (y, z) landing at every receiver range ``x == ranges[k]``, per
    crossing ordinal up to ``max_ord``, detected and linearly interpolated
    inside the scan — so the eigenray seed scan reads back
    (R, NR, max_ord, 2) instead of a full (S, R, 7+) history (as in
    2-D).
    """
    method, dtype, pos0, dir0, max_size, step_limit, box_t = _cross3_args(
        method, pos0, dir0, steps, box, step_limit, dtype)
    _, run_jit = _build_dynamic3_fn(method, max_size, box_t, "cross_fan",
                                    dtype.name, max_ord=int(max_ord))
    return run_jit(pos0, dir0, medium, jnp.asarray(delta_s, dtype),
                   jnp.asarray(step_limit, jnp.int32),
                   aux=jnp.asarray(ranges, dtype))


def trace_crossings_pick3(method: str, medium, *, pos0, dir0,
                          delta_s: float, steps: int, xr, ordk, box=None,
                          dtype=np.float64,
                          step_limit: int | None = None) -> Crossing3Pick:
    """3-D dynamic trace recording each ray's own target crossing.

    The Gauss-Newton view: candidate ray ``r`` brings home the full
    interpolated :data:`CROSS3_COLS` state at its ``ordk[r]``-th crossing
    of ``x == xr[r]`` (falling back to the last crossing when the path has
    fewer) — O(candidates x 15) per iteration instead of a full-history
    readback.
    """
    method, dtype, pos0, dir0, max_size, step_limit, box_t = _cross3_args(
        method, pos0, dir0, steps, box, step_limit, dtype)
    _, run_jit = _build_dynamic3_fn(method, max_size, box_t, "cross_pick",
                                    dtype.name)
    return run_jit(pos0, dir0, medium, jnp.asarray(delta_s, dtype),
                   jnp.asarray(step_limit, jnp.int32),
                   aux=(jnp.asarray(xr, dtype),
                        jnp.asarray(ordk, jnp.int32)))
