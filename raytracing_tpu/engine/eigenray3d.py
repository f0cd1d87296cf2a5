"""3-D eigenrays: two-parameter boundary-value solving with the exact Q.

The 3-D twin of :mod:`engine.eigenray`.  A receiver in 3-D is hit by
tuning TWO launch angles, so bracketing becomes seeding (local minima of
the miss over a launch-direction grid) and the scalar Newton becomes a
2x2 solve — whose Jacobian is free and exact: with the on-device crossing
records of :func:`engine.dynamic3d.trace_crossings_pick3` (interpolated
tangents at the range plane — no trajectory history is ever read back,
the 2-D tier's round-4 shape), the derivative of the crossing-plane miss
``m = (y - yr, z - zr)`` w.r.t. the two launch angles is

    M[i, j] = dpos_i/da_j - dpos_x/da_j * (u_i / u_x),   i in {y, z}

(the along-ray component cancels through the crossing-time adjustment,
exactly as the 2-D solver's ``q / cos(angle)`` — engine/eigenray.py).

Stages:

1. one dynamic fan over an (alpha, beta) grid of directions around
   ``center_dir``, recording (y, z) landings per range/ordinal ON DEVICE
   (:func:`engine.dynamic3d.trace_crossings_fan3` — (F, NR, 8, 2) comes
   back, never a history); for every receiver and range-crossing ordinal,
   grid cells that locally minimize |m|^2 seed one candidate each
   (multipath = several minima; arrivals finer than the grid pitch, or
   whose seed sits on the fan edge, are not found — widen/densify);
2. damped Gauss-Newton on all candidates of all receivers at once, one
   crossing-pick trace per iteration (O(candidates x 15) readback),
   steps clamped to the grid pitch;
3. final evaluation: travel time, |det Q| amplitude, KMAH and residual
   miss per arrival.  The result duck-types :class:`engine.eigenray.
   Eigenrays` where it matters, so ``pressure`` / ``coherent_tl`` /
   ``incoherent_tl`` reduce 3-D arrivals unchanged.

Same precision note as 2-D: the Newton floor is the landing surface's
noise — build sampled media float64 for eigenray work.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

from raytracing_tpu.engine.dynamic3d import (CROSS3_COLS,
                                             _transverse_frame,
                                             spreading_amplitude3,
                                             trace_crossings_fan3,
                                             trace_crossings_pick3)


class Eigenrays3(NamedTuple):
    """3-D arrivals, flat over (receiver, path); sorted by receiver then
    travel time.  Field names match the 2-D :class:`Eigenrays` where the
    TL reductions read them."""

    receiver: Any     # (E,) int32
    dir0: Any         # (E, 3) launch direction of the arrival
    traveltime: Any   # (E,)
    miss: Any         # (E,) residual |(y, z) - receiver| at its range
    detq: Any         # (E,) paraxial det Q at the receiver
    kmah: Any         # (E,) int32
    amplitude: Any    # (E,) point-source spherical-spreading amplitude
    n: Any            # (E,)
    n0: Any           # (E,)
    converged: Any    # (E,) bool

    def for_receiver(self, i: int) -> "Eigenrays3":
        m = self.receiver == i
        return Eigenrays3(*[np.asarray(f)[m] for f in self])


def _grid_dirs(center, a, b):
    import jax.numpy as jnp
    u0 = np.asarray(center, np.float64)
    u0 = u0 / np.linalg.norm(u0)
    e1, e2 = (np.asarray(v) for v in _transverse_frame(
        jnp.asarray(u0[None, :])))
    d = (u0[None, None, :] + a[:, None, None] * e1 + b[None, :, None] * e2)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True),
            e1[0], e2[0])


def find_eigenrays3(method: str, medium, *, source, receivers, delta_s,
                    max_size: int, box=None, center_dir=None,
                    fan=(-0.3, 0.3, 25, -0.3, 0.3, 25), iters: int = 12,
                    tol: float = 1e-9, dtype=np.float64,
                    on_host: bool | None = None,
                    mesh=None, max_ord: int = 8) -> Eigenrays3:
    """Every fan-resolved 3-D ray path from ``source`` to each receiver.

    ``fan`` = (a_lo, a_hi, n_a, b_lo, b_hi, n_b): the launch-direction
    grid around ``center_dir`` (default: from the source toward the mean
    receiver).  ``mesh``: a Mesh with a "rays" axis — every crossing
    trace's launch batch is padded to it and sharded over it (the 2-D
    solver's launch contract, engine/eigenray.py).  ``dtype`` is the
    solve precision: f64 default; pass np.float32 for device work with
    an f32 medium — the accuracy-grade combination is the split-word
    facade ``df_eval_medium3_from_samples`` (engine/df_grid3.py), whose
    evaluations stay f64-grade under an f32 solve.  ``max_ord`` caps
    the range-crossing ordinals the on-device records resolve (the 2-D
    solver's knob, engine/eigenray.py): looping/ducting paths that
    cross a receiver range more than ``max_ord`` times need it raised
    or their later arrivals are not seeded.  See the module docstring
    for the algorithm and its resolution caveats.
    """
    import contextlib

    import jax

    from raytracing_tpu.engine.eigenray import _solve_device

    # an f64 solve without a scoped x64 enable (serve daemon / CLI never
    # set it globally) silently downcasts to f32 and the default tol=1e-9
    # is unreachable — mirror find_eigenrays (engine/eigenray.py:220-222)
    if np.dtype(dtype).itemsize == 8 and not jax.config.jax_enable_x64:
        x64 = jax.enable_x64(True)
    else:
        x64 = contextlib.nullcontext()
    # host-side solve over short fan traces: the CPU backend by default
    # (same scoping and on_host/RT_EIGENRAY_ON_HOST opt-out as
    # engine/eigenray.find_eigenrays)
    with x64, _solve_device(on_host):
        return _find_eigenrays3(method, medium, source=source,
                                receivers=receivers, delta_s=delta_s,
                                max_size=max_size, box=box,
                                center_dir=center_dir, fan=fan, iters=iters,
                                tol=tol, dtype=np.dtype(dtype).type,
                                mesh=mesh, max_ord=max_ord)


def _find_eigenrays3(method, medium, *, source, receivers, delta_s,
                     max_size, box, center_dir, fan, iters,
                     tol, dtype=np.float64, mesh=None,
                     max_ord: int = 8) -> Eigenrays3:
    source = np.asarray(source, np.float64)
    receivers = np.atleast_2d(np.asarray(receivers, np.float64))
    if center_dir is None:
        center_dir = receivers.mean(0) - source
    a_lo, a_hi, n_a, b_lo, b_hi, n_b = fan
    a = np.linspace(a_lo, a_hi, int(n_a))
    b = np.linspace(b_lo, b_hi, int(n_b))
    pitch = max((a_hi - a_lo) / max(int(n_a) - 1, 1),
                (b_hi - b_lo) / max(int(n_b) - 1, 1))
    dirs, _, _ = _grid_dirs(center_dir, a, b)
    dirs_flat = dirs.reshape(-1, 3)

    def launch(dir_batch, *per_ray):
        """(pos0, dir0, extras) padded to the mesh's ray axis and sharded
        over it when a mesh is given (the 2-D solver's launch contract,
        engine/eigenray.py); returns the true count k to slice the pad."""
        k = len(dir_batch)
        if mesh is None:
            return k, np.tile(source, (k, 1)), dir_batch, per_ray
        import jax
        from jax.sharding import NamedSharding, PartitionSpec

        ndev = int(mesh.shape["rays"])
        pad = (-k) % ndev
        if pad:
            dir_batch = np.concatenate(
                [dir_batch, np.repeat(dir_batch[-1:], pad, axis=0)])
            per_ray = tuple(np.concatenate([v, np.repeat(v[-1:], pad)])
                            for v in per_ray)
        rows = NamedSharding(mesh, PartitionSpec("rays", None))
        rays = NamedSharding(mesh, PartitionSpec("rays"))
        pos0 = jax.device_put(np.tile(source, (k + pad, 1)), rows)
        dir_batch = jax.device_put(np.asarray(dir_batch), rows)
        per_ray = tuple(jax.device_put(np.asarray(v), rays)
                        for v in per_ray)
        return k, pos0, dir_batch, per_ray

    # --- seed scan over ON-DEVICE crossing records (trace_crossings_fan3):
    # every fan ray's (y, z) landing per receiver range and crossing
    # ordinal comes back as (F, NRu, max_ord, 2) — no trajectory history
    # is ever materialized (the 2-D tier's shape).
    # Grid-local minima of the miss per (receiver, ordinal) seed one
    # Gauss-Newton candidate each.
    uniq_xr, xr_inv = np.unique(receivers[:, 0], return_inverse=True)
    kf, fan_pos0, fan_dir0, _ = launch(dirs_flat)
    fanres = trace_crossings_fan3(
        method, medium, pos0=fan_pos0, dir0=fan_dir0, delta_s=delta_s,
        steps=int(max_size), box=box, ranges=uniq_xr,
        max_ord=int(max_ord), dtype=dtype)
    depths = np.asarray(fanres.depths)[:kf]      # (F, NRu, max_ord, 2)

    cand_dir, cand_rec, cand_ord = [], [], []
    for ui in range(len(uniq_xr)):
        yz = depths[:, ui].reshape(int(n_a), int(n_b), -1, 2)
        for ri in np.where(xr_inv == ui)[0]:
            m2 = ((yz[..., 0] - receivers[ri, 1]) ** 2
                  + (yz[..., 1] - receivers[ri, 2]) ** 2)
            m2 = np.where(np.isnan(m2), np.inf, m2)
            # interior nodes beating their 4-neighborhood seed a candidate
            c = m2[1:-1, 1:-1]
            is_min = (np.isfinite(c)
                      & (c <= m2[:-2, 1:-1]) & (c <= m2[2:, 1:-1])
                      & (c <= m2[1:-1, :-2]) & (c <= m2[1:-1, 2:]))
            ii, jj, kk = np.nonzero(is_min)
            cand_dir.extend(dirs[ii + 1, jj + 1])
            cand_rec.extend([ri] * len(ii))
            cand_ord.extend(kk)
    if not cand_dir:
        z = np.empty(0)
        zi = np.empty(0, np.int32)
        return Eigenrays3(zi, np.empty((0, 3)), z, z, z, zi, z, z, z,
                          np.empty(0, bool))

    u = np.asarray(cand_dir, np.float64)
    rec = np.asarray(cand_rec, np.int32)
    ordk = np.asarray(cand_ord, np.int32)
    xr = receivers[rec, 0]
    tgt = receivers[rec, 1:3]

    # --- damped Gauss-Newton, all candidates in one trace per iteration --
    # (each candidate follows its seeded crossing ORDINAL — hopping to the
    # nearest miss could jump crossings of a looping path mid-polish).
    # Each iteration reads back ONE (J, 15) crossing-state block
    # (trace_crossings_pick3) instead of a full history.
    import jax.numpy as jnp

    cY, cZ, cTT, cN, cDETQ, cKMAH = (CROSS3_COLS.index(k) for k in
                                     ("y", "z", "traveltime", "n",
                                      "detq", "kmah"))
    cU = CROSS3_COLS.index("ux")
    cDPA = CROSS3_COLS.index("dpax")
    cDPB = CROSS3_COLS.index("dpbx")

    def run_pick(dir_batch):
        k, p0, d0, (xr_s, ordk_s) = launch(dir_batch, xr, ordk)
        res = trace_crossings_pick3(
            method, medium, pos0=p0, dir0=d0, delta_s=delta_s,
            steps=int(max_size), box=box, xr=xr_s, ordk=ordk_s,
            dtype=dtype)
        return np.asarray(res.state)[:k], np.asarray(res.found)[:k]

    miss = np.full(len(u), np.inf)
    for _ in range(int(iters)):
        st, found = run_pick(u)
        m = st[:, [cY, cZ]] - tgt                           # (J, 2)
        miss = np.where(found, np.linalg.norm(m, axis=1), np.inf)
        uc = st[:, cU:cU + 3]
        dpa, dpb = st[:, cDPA:cDPA + 3], st[:, cDPB:cDPB + 3]
        ux = np.where(np.abs(uc[:, 0]) > 1e-9, uc[:, 0],
                      np.copysign(1e-9, uc[:, 0]))
        m00 = dpa[:, 1] - dpa[:, 0] * uc[:, 1] / ux
        m01 = dpb[:, 1] - dpb[:, 0] * uc[:, 1] / ux
        m10 = dpa[:, 2] - dpa[:, 0] * uc[:, 2] / ux
        m11 = dpb[:, 2] - dpb[:, 0] * uc[:, 2] / ux
        det = m00 * m11 - m01 * m10
        mmax = np.maximum(np.maximum(np.abs(m00), np.abs(m01)),
                          np.maximum(np.abs(m10), np.abs(m11)))
        newton_ok = np.abs(det) > 1e-12 * (mmax ** 2 + 1e-30)
        safe_det = np.where(newton_ok, det, 1.0)
        d_n = np.stack([-(m11 * m[:, 0] - m01 * m[:, 1]) / safe_det,
                        -(m00 * m[:, 1] - m10 * m[:, 0]) / safe_det], 1)
        # near-caustic: damped gradient step -M^T m / |M|^2
        ss = m00 ** 2 + m01 ** 2 + m10 ** 2 + m11 ** 2 + 1e-30
        d_g = np.stack([-(m00 * m[:, 0] + m10 * m[:, 1]) / ss,
                        -(m01 * m[:, 0] + m11 * m[:, 1]) / ss], 1)
        delta = np.where(found[:, None],
                         np.where(newton_ok[:, None], d_n, d_g), 0.0)
        # clamp to one grid pitch: seeds are at most a cell away
        nrm = np.linalg.norm(delta, axis=1, keepdims=True)
        delta = np.where(nrm > pitch, delta * (pitch / np.maximum(nrm, 1e-300)),
                         delta)
        if np.nanmax(np.where(np.isinf(miss), np.nan, miss),
                     initial=0.0) < tol and np.all(np.isfinite(miss)):
            break
        e1c, e2c = (np.asarray(v) for v in _transverse_frame(jnp.asarray(u)))
        u = u + delta[:, :1] * e1c + delta[:, 1:] * e2c
        u /= np.linalg.norm(u, axis=1, keepdims=True)

    # --- final evaluation --------------------------------------------------
    rows, ok = run_pick(u)
    miss = np.where(ok, np.linalg.norm(rows[:, [cY, cZ]] - tgt, axis=1),
                    np.inf)
    n0, _ = medium.n_and_grad3(*(np.asarray(v) for v in source))
    n0 = np.full(len(u), float(np.asarray(n0)))
    amp = np.asarray(spreading_amplitude3(rows[:, cDETQ], rows[:, cN], n0))

    order = np.lexsort((rows[:, cTT], rec))
    order = order[ok[order]]
    # dedup below the fan's resolving power; the travel-time guard keeps
    # same-direction arrivals of different crossing ordinals distinct
    # (same rationale as engine/eigenray.py)
    dedup = []
    for j in order:
        if not any(rec[j] == rec[i]
                   and np.linalg.norm(u[j] - u[i]) < 1e-3 * pitch
                   and abs(rows[j, cTT] - rows[i, cTT])
                   < 1e-6 * (1.0 + abs(rows[i, cTT]))
                   for i in dedup):
            dedup.append(j)
    order = np.asarray(dedup, int)
    return Eigenrays3(
        receiver=rec[order], dir0=u[order], traveltime=rows[order, cTT],
        miss=miss[order], detq=rows[order, cDETQ],
        kmah=rows[order, cKMAH].astype(np.int32), amplitude=amp[order],
        n=rows[order, cN], n0=n0[order],
        converged=miss[order] < max(tol * 1e3, 1e-6))
