"""Eigenray finding: boundary-value ray solutions source -> receiver.

The reference answers only the initial-value problem — launch a fan, see
where it lands (RT_bench.py:766-948).  Production use of a ray tracer
(transmission loss at a hydrophone, travel-time tomography picks) needs the
*boundary-value* problem: every launch angle whose ray passes through a
given receiver, with travel time, amplitude and caustic phase per arrival.

Strategy, batched end to end:

1. one dynamic fan trace from the source that records its range-line
   crossings ON DEVICE (:func:`engine.dynamic.trace_crossings_fan`):
   every crossing of every receiver range ``x = xr`` is linearly
   interpolated inside the scan, so the host reads back (fan, ranges,
   ordinal) depths — O(KB) — instead of the full (steps, fan, 7) history;
2. host-side bracket scan over those depths: a sign change of
   ``y(xr) - yr`` between adjacent fan rays (same crossing ordinal)
   brackets one eigenray;
3. safeguarded Newton on the launch angle, batched over ALL brackets of
   ALL receivers in one dynamic trace per iteration, each candidate
   recording its own ordinal-k crossing state on device
   (:func:`engine.dynamic.trace_crossings_pick`).  The Newton slope is
   free: the derivative of crossing depth w.r.t. launch angle at fixed
   range is exactly ``q / cos(angle)`` — the along-ray component of the
   paraxial tangent cancels identically — so each iteration is quadratic
   where the plain fan would need thousands of rays for the same miss.

Multipath comes out naturally: each (receiver, ordinal, bracket) is its own
eigenray; :func:`coherent_tl` / :func:`incoherent_tl` then reduce arrivals
per receiver into the field, with each caustic passage (KMAH index from the
dynamic trace) contributing the standard -pi/2 phase shift.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

from raytracing_tpu import config
from raytracing_tpu.engine.dynamic import (CROSS_COLS, DYN_COLS,
                                           spreading_amplitude,
                                           trace_crossings_fan,
                                           trace_crossings_pick)

# history-row columns (DYN_COLS): the host-side crossing scans below keep
# this layout for the 3-D solver (engine/eigenray3d.py), which still reads
# full histories (its two-angle fan has no 1-D bracket structure)
_X = DYN_COLS.index("x")
_Y = DYN_COLS.index("y")
_TT = DYN_COLS.index("traveltime")
_ANG = DYN_COLS.index("angle")
_Q = DYN_COLS.index("q")
_KMAH = DYN_COLS.index("kmah")
_N = DYN_COLS.index("n")

# on-device crossing-record columns (engine/dynamic.CROSS_COLS): what the
# 2-D solver reads back per candidate per Newton iteration
_CY = CROSS_COLS.index("y")
_CTT = CROSS_COLS.index("traveltime")
_CANG = CROSS_COLS.index("angle")
_CQ = CROSS_COLS.index("q")
_CKMAH = CROSS_COLS.index("kmah")
_CN = CROSS_COLS.index("n")


class Eigenrays(NamedTuple):
    """All arrivals found, flat over (receiver, path); sorted by receiver
    then travel time."""

    receiver: Any     # (E,) int32 index into the receivers argument
    theta0: Any       # (E,) launch angle of the arrival
    traveltime: Any   # (E,) optical path / travel time at the receiver
    y_err: Any        # (E,) residual depth miss at the receiver range
    q: Any            # (E,) transverse spreading at the receiver
    kmah: Any         # (E,) int32 caustic count along the path
    angle: Any        # (E,) ray angle at the receiver
    n: Any            # (E,) index at the receiver
    n0: Any           # (E,) index at the source
    amplitude: Any    # (E,) point-source pressure amplitude
    converged: Any    # (E,) bool: |y_err| under the requested tolerance

    def for_receiver(self, i: int) -> "Eigenrays":
        m = self.receiver == i
        return Eigenrays(*[np.asarray(f)[m] for f in self])


def _crossing_vals(hist: np.ndarray, last: np.ndarray, xr: float,
                   cols, x_col: int = _X):
    """Values at every crossing of ``x == xr``, all rays at once.

    Vectorized fan scan: ``hist`` is the whole fan's (S, R, C) history,
    ``last`` its (R,) frozen-row indices, ``cols`` the columns to
    interpolate.  Returns an (R, M, len(cols)) nan-padded array ordered
    along each ray (M = max crossings, >= 1) in one numpy pass — a
    (range x depth) receiver grid then shares one call per unique range
    instead of R python-level scans per receiver.  Shared with the 3-D
    solver (engine/eigenray3d.py), whose column layout differs.
    """
    cols = list(cols)
    x = hist[:, :, x_col]                                   # (S, R)
    d = x - xr
    n_steps, n_rays = x.shape
    step_ok = np.arange(n_steps - 1)[:, None] < last[None, :]
    hit = step_ok & ((d[:-1] < 0) != (d[1:] < 0))          # (S-1, R)
    counts = hit.sum(0)
    m = max(int(counts.max()) if n_rays else 0, 1)
    out = np.full((n_rays, m, len(cols)), np.nan)
    ray, step = np.nonzero(hit.T)           # row-major: by ray, then step
    if ray.size:
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        ordinal = np.arange(ray.size) - np.repeat(starts, counts)
        frac = (d[step, ray] / (x[step, ray] - x[step + 1, ray]))[:, None]
        v0 = hist[step, ray][:, cols]
        out[ray, ordinal] = v0 + frac * (hist[step + 1, ray][:, cols] - v0)
    return out


def _crossing_depths(hist: np.ndarray, last: np.ndarray, xr: float):
    """(R, M) nan-padded crossing depths — the 2-D fan scan's view."""
    return _crossing_vals(hist, last, xr, (_Y,))[..., 0]


def _pick_crossings(h: np.ndarray, last: np.ndarray, xr: np.ndarray,
                    ordk: np.ndarray, x_col: int = _X,
                    kmah_col: int = _KMAH):
    """The ordinal-``k`` crossing state per candidate column, vectorized.

    ``h`` is (S, J, C) with per-candidate range ``xr`` (J,) and crossing
    ordinal ``ordk`` (J,).  Rays can cross a receiver range several times
    (loops, turn-backs); each ordinal is its own landing curve and its own
    bracket, so the polish must follow ordinal k, not whichever crossing
    happens to land nearest the receiver depth.  If a candidate's path has
    fewer crossings than k (family boundary), fall back to the last — the
    bracket logic treats the miss as off-family anyway.  Returns
    ``(states (J, C), found (J,) bool)``; state rows are zero where no
    crossing exists.  The ``kmah_col`` column is NOT interpolated (the
    caustic count is step-quantized).
    """
    x = h[:, :, x_col]                                       # (S, J)
    d = x - xr[None, :]
    n_steps, n_cand = x.shape
    if n_steps < 2:
        return np.zeros((n_cand, h.shape[2])), np.zeros(n_cand, bool)
    step_ok = np.arange(n_steps - 1)[:, None] < last[None, :]
    hit = step_ok & ((d[:-1] < 0) != (d[1:] < 0))           # (S-1, J)
    cum = np.cumsum(hit, 0)
    counts = cum[-1]
    found = counts > 0
    target = np.minimum(ordk, np.maximum(counts - 1, 0))
    sel = hit & (cum - 1 == target[None, :])   # one True per found column
    idx = sel.argmax(0)
    j = np.arange(n_cand)
    h0, h1 = h[idx, j], h[idx + 1, j]
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = (d[idx, j] / (x[idx, j] - x[idx + 1, j]))[:, None]
        out = np.where(found[:, None], h0 + frac * (h1 - h0), 0.0)
    out[:, kmah_col] = np.where(found, h0[:, kmah_col], 0.0)
    return out, found


def _solve_device(on_host):
    """Device scope for the host-coordinated eigenray solves.

    ``on_host=None`` (the default) resolves from ``RT_EIGENRAY_ON_HOST``
    (unset/1 = route to the CPU backend, 0 = keep the default backend).
    Where the crossover between the host and the device lies is not
    measured on the GPU yet; the host is the default.
    """
    import contextlib
    import os

    import jax

    if on_host is None:
        on_host = os.environ.get("RT_EIGENRAY_ON_HOST", "1") != "0"
    if not on_host:
        return contextlib.nullcontext()
    try:
        cpu = jax.local_devices(backend="cpu")[0]
        return (contextlib.nullcontext()
                if jax.default_backend() == "cpu"
                else jax.default_device(cpu))
    except RuntimeError:
        return contextlib.nullcontext()


def find_eigenrays(op_name: str, medium, *, source, receivers, delta_s,
                   max_size: int, box, fan=(0.0, np.pi / 2, 256),
                   gamma: float = 1.0, dtype=np.float64, iters: int = 12,
                   tol: float = 1e-9, max_arrivals: int | None = None,
                   on_host: bool | None = None, mesh=None,
                   max_ord: int = 8) -> Eigenrays:
    """Find every fan-resolved ray path from ``source`` to each receiver.

    ``receivers`` is (K, 2); ``fan`` = (theta_lo, theta_hi, count) bounds
    the launch-angle search (arrivals outside it, or multipath finer than
    the fan pitch, are not found — widen/densify the fan for more).
    ``box`` clips rays as in the forward engine; ``max_size`` bounds the
    step count.  ``max_arrivals`` (optional) caps the bracket-candidate
    count — looping paths multiply range crossings, and each candidate
    re-traces per Newton iteration; servers should set it.  Returns a
    flat :class:`Eigenrays`; an empty one if no path crosses any receiver
    range.

    The achievable miss is the noise floor of the landing curve
    ``y(xr; theta0)``, set by the medium's evaluation precision: analytic
    and f64-table media converge to ~1e-15, while float32 coefficient
    tables (the kernel-tier default for sampled media) floor around 1e-5 —
    build sampled media with ``dtype=np.float64`` for eigenray work.
    """
    import contextlib

    import jax

    # the Newton polish needs the landing curve at the requested precision;
    # scope an x64 enable to this solve instead of requiring global config
    if np.dtype(dtype).itemsize == 8 and not jax.config.jax_enable_x64:
        x64 = jax.enable_x64(True)
    else:
        x64 = contextlib.nullcontext()
    # The solve is a host-side Newton driving ~iters short fan traces with
    # crossing records read back each time; the traces run on the host CPU
    # backend by default (on_host=False or RT_EIGENRAY_ON_HOST=0 keeps the
    # default device).  Scoped: the f32 dynamic tier (trace_dynamic
    # on-mesh) is unaffected.
    with x64, _solve_device(on_host):
        return _find_eigenrays(op_name, medium, source=source,
                               receivers=receivers, delta_s=delta_s,
                               max_size=max_size, box=box, fan=fan,
                               gamma=gamma, dtype=dtype, iters=iters,
                               tol=tol, max_arrivals=max_arrivals,
                               mesh=mesh, max_ord=max_ord)


def _find_eigenrays(op_name, medium, *, source, receivers, delta_s,
                    max_size, box, fan, gamma, dtype, iters,
                    tol, max_arrivals=None, mesh=None,
                    max_ord: int = 8) -> Eigenrays:
    source = np.asarray(source, dtype)
    receivers = np.atleast_2d(np.asarray(receivers, dtype))
    th_lo, th_hi, n_fan = fan
    # a custom launch container: trace_dynamic reads only gamma/box from it
    # (pos0/theta0/max_size are passed explicitly per call below)
    scen = config.ScenarioConfig(
        name="custom", key="-", field="", gamma=float(gamma),
        ray_count=int(n_fan),
        theta0=np.linspace(th_lo, th_hi, int(n_fan)),
        pos0=np.tile(source, (int(n_fan), 1)), s_max=0.0,
        box=tuple(float(b) for b in box))

    def launch(theta0, *per_ray):
        """(pos0, theta0, extras) ready for the device — padded to the
        mesh's ray axis and sharded over it when a mesh is given, so the
        Newton iterations' trace legs (fans first, then variable candidate
        batches) become mesh programs.  Returns the true count k so
        callers slice the pad off."""
        k = len(theta0)
        pos0 = np.tile(source, (k, 1))
        if mesh is None:
            return k, pos0, theta0, per_ray
        import jax
        from jax.sharding import NamedSharding, PartitionSpec

        ndev = int(mesh.shape["rays"])
        pad = (-k) % ndev
        if pad:
            theta0 = np.concatenate([theta0,
                                     np.full(pad, theta0[-1],
                                             theta0.dtype)])
            pos0 = np.tile(source, (k + pad, 1))
            per_ray = tuple(np.concatenate([v, np.repeat(v[-1:], pad)])
                            for v in per_ray)
        rays = NamedSharding(mesh, PartitionSpec("rays"))
        theta0 = jax.device_put(theta0, rays)
        pos0 = jax.device_put(
            pos0, NamedSharding(mesh, PartitionSpec("rays", None)))
        per_ray = tuple(jax.device_put(v, rays) for v in per_ray)
        return k, pos0, theta0, per_ray

    def fan_crossings(theta0, ranges, m_ord):
        k, pos0, theta0, _ = launch(theta0)
        res = trace_crossings_fan(op_name, scen, medium, delta_s=delta_s,
                                  ranges=ranges, max_ord=m_ord, dtype=dtype,
                                  pos0=pos0, theta0=theta0,
                                  max_size=max_size)
        return np.asarray(res.depths)[:k], np.asarray(res.counts)[:k]

    def pick(theta0, xr, ordk):
        k, pos0, theta0, (xr, ordk) = launch(theta0, xr, ordk)
        res = trace_crossings_pick(op_name, scen, medium, delta_s=delta_s,
                                   xr=xr, ordk=ordk, dtype=dtype,
                                   pos0=pos0, theta0=theta0,
                                   max_size=max_size)
        return np.asarray(res.state)[:k], np.asarray(res.found)[:k]

    # --- bracket scan: ONE on-device fan trace records every range-line
    # crossing (engine/dynamic.trace_crossings_fan) — histories never
    # materialize; the host sees (R, NR, max_ord) depths.  A (range x
    # depth) receiver GRID shares the fan's crossing records across its
    # whole depth column, so a full TL field map costs one fan trace.
    uniq_xr, xr_inv = np.unique(receivers[:, 0], return_inverse=True)
    fan_th = np.asarray(scen.theta0, dtype)
    depths, counts = fan_crossings(fan_th, uniq_xr, int(max_ord))
    if counts.size and int(counts.max()) > int(max_ord):
        # loopy paths crossed more often than the record provisioned;
        # one re-run at the observed count keeps the scan exact
        depths, counts = fan_crossings(fan_th, uniq_xr,
                                       int(counts.max()))

    cand_th_lo, cand_th_hi, cand_rec = [], [], []
    cand_flo, cand_ord = [], []
    for ui, xru in enumerate(uniq_xr):
        depth = depths[:, ui, :]                       # (R, M) nan-padded
        here = np.where(xr_inv == ui)[0]               # receivers at xru
        f = depth[None, :, :] - receivers[here, 1][:, None, None]
        ok = ~np.isnan(f[:, :-1, :]) & ~np.isnan(f[:, 1:, :])
        s0, s1 = np.sign(f[:, :-1, :]), np.sign(f[:, 1:, :])
        # any sign TRANSITION brackets a root — including an exact hit
        # (a fan ray landing dead on the receiver, e.g. the axial ray
        # of a symmetric waveguide, makes f == 0: the plain product
        # test f0*f1 < 0 would drop it).  An exact hit flags both of
        # its neighboring intervals; the duplicate converges to the
        # same root and is merged below.
        sign = ok & (s0 != s1) & ~((s0 == 0) & (s1 == 0))
        ki, ri, kk = np.nonzero(sign)                  # (rec, ray, ordinal)
        cand_th_lo.extend(scen.theta0[ri])
        cand_th_hi.extend(scen.theta0[ri + 1])
        cand_flo.extend(f[ki, ri, kk])
        cand_rec.extend(here[ki])
        cand_ord.extend(kk)
    if not cand_th_lo:
        z = np.empty(0)
        zi = np.empty(0, np.int32)
        return Eigenrays(zi, z, z, z, z, zi, z, z, z, z,
                         np.empty(0, bool))
    if max_arrivals is not None and len(cand_th_lo) > int(max_arrivals):
        raise ValueError(
            f"{len(cand_th_lo)} bracket candidates exceed max_arrivals "
            f"{int(max_arrivals)} (looping paths multiply crossings); "
            f"shorten the trace, shrink the fan, or raise the cap")

    lo = np.asarray(cand_th_lo, dtype)
    hi = np.asarray(cand_th_hi, dtype)
    flo = np.asarray(cand_flo, dtype)
    rec = np.asarray(cand_rec, np.int32)
    ordk = np.asarray(cand_ord, np.int32)
    xr = receivers[rec, 0]
    yr = receivers[rec, 1]
    th = 0.5 * (lo + hi)

    # --- safeguarded Newton, batched over every candidate ------------------
    # (each candidate records ITS OWN ordinal-k crossing on device —
    # trace_crossings_pick — so an iteration reads back (J, 6) scalars)
    state = np.zeros((len(th), 6))
    fcur = np.full(len(th), np.inf)
    best_th = th.copy()
    best_f = np.full(len(th), np.inf)
    for _ in range(int(iters)):
        st, found = pick(th, xr, ordk)
        state = np.where(found[:, None], st, state)
        fcur = np.where(found, st[:, _CY] - yr, np.nan)
        # keep the best-|residual| angle seen: the loop's LAST update may
        # move past the evaluation it was judged on (a proposal or a
        # bisection jump), and near-axial roots whose rays land EXACTLY
        # on the receiver range oscillate at the sub-tol level — the
        # safeguarded-root-finding rule is to RETURN the best iterate,
        # never the last probe (stalls at ~1e-6 in the SOFAR example
        # otherwise, tests/test_examples.py::test_transmission_loss)
        better = found & (np.abs(fcur) < np.abs(best_f))
        best_th = np.where(better, th, best_th)
        best_f = np.where(better, fcur, best_f)
        # convergence check BEFORE any update: the final evaluation must
        # see the angle these residuals belong to, not the next proposal
        if np.all(np.isfinite(best_f)) and np.abs(best_f).max() < tol:
            break
        lost = np.isnan(fcur)
        # bracket bookkeeping on real signs only; a vanished crossing says
        # nothing about which half holds the root, so the bracket stays
        # put and the next probe walks toward lo (whose fan ray crossed)
        neg = ~lost & (fcur * flo > 0)
        lo = np.where(neg, th, lo)
        hi = np.where(~lost & ~neg, th, hi)
        # Newton proposal from the exact paraxial slope dy/dth = q / cos(a)
        slope = state[:, _CQ] / np.cos(state[:, _CANG])
        with np.errstate(divide="ignore", invalid="ignore"):
            prop = th - fcur / slope
        mid = 0.5 * (lo + hi)
        use = ~lost & np.isfinite(prop) & (prop > lo) & (prop < hi)
        th = np.where(use, prop, np.where(lost, 0.5 * (lo + th), mid))

    # --- final evaluation at the best-seen angles ---------------------------
    th = np.where(np.isfinite(best_f), best_th, th)
    rows, ok = pick(th, xr, ordk)
    y_err = np.where(ok, rows[:, _CY] - yr, np.inf)
    n0, _ = medium.n_and_grad(source[0], source[1])
    n0 = np.full(len(th), float(np.asarray(n0)))
    amp = np.asarray(spreading_amplitude(rows[:, _CQ], rows[:, _CN], n0))
    order = np.lexsort((rows[:, _CTT], rec))
    keep = ok[order]
    order = order[keep]
    # merge duplicate roots: adjacent brackets around an exact fan hit — or
    # around a root where the landing curve is nearly flat, so Newton stops
    # within tol at slightly different angles — converge to the same
    # arrival.  Arrivals separated by less than 1e-3 fan pitch are beyond
    # the fan's resolving power (documented above); the travel-time guard
    # keeps same-angle arrivals of DIFFERENT crossing ordinals distinct
    # (one ray can pass a receiver range several times).
    pitch = (float(th_hi) - float(th_lo)) / max(int(n_fan) - 1, 1)
    tts = rows[:, _CTT]
    dedup = []
    for j in order:
        dup = any(rec[j] == rec[i] and abs(th[j] - th[i]) < 1e-3 * pitch
                  and abs(tts[j] - tts[i]) < 1e-6 * (1.0 + abs(tts[i]))
                  for i in dedup)
        if not dup:
            dedup.append(j)
    order = np.asarray(dedup, int)
    return Eigenrays(
        receiver=rec[order], theta0=th[order],
        traveltime=rows[order, _CTT], y_err=y_err[order],
        q=rows[order, _CQ], kmah=rows[order, _CKMAH].astype(np.int32),
        angle=rows[order, _CANG], n=rows[order, _CN], n0=n0[order],
        amplitude=amp[order],
        converged=np.abs(y_err[order]) < max(tol * 1e3, 1e-6))


def pressure(eig: Eigenrays, omega: float, n_receivers: int) -> np.ndarray:
    """Coherent complex pressure per receiver at angular frequency omega.

    Each arrival contributes ``A exp(i(omega tau - pi/2 kmah))`` — the
    standard KMAH phase advance of -pi/2 per caustic passage.
    """
    ph = omega * np.asarray(eig.traveltime) - 0.5 * np.pi * np.asarray(eig.kmah)
    contrib = np.asarray(eig.amplitude) * np.exp(1j * ph)
    p = np.zeros(n_receivers, complex)
    np.add.at(p, np.asarray(eig.receiver), contrib)
    return p


def coherent_tl(eig: Eigenrays, omega: float, n_receivers: int) -> np.ndarray:
    """-20 log10 |sum of arrivals| per receiver (dB re 1 m); inf if none."""
    with np.errstate(divide="ignore"):
        return -20.0 * np.log10(np.abs(pressure(eig, omega, n_receivers)))


def incoherent_tl(eig: Eigenrays, n_receivers: int) -> np.ndarray:
    """-10 log10 sum |A|^2 per receiver — the phase-averaged field."""
    e = np.zeros(n_receivers)
    np.add.at(e, np.asarray(eig.receiver), np.asarray(eig.amplitude) ** 2)
    with np.errstate(divide="ignore"):
        return -10.0 * np.log10(e)
