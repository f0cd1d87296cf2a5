"""Differentiable tracing: gradients THROUGH the integrator.

The reference is a forward simulator only — fitting a medium to observed
rays means hand-tuned parameter sweeps re-running the whole program
(its only search loop is the DELTA_S calibration, RT_bench.py:1296-1406,
and it optimizes the step size, never the physics).  Because this
framework's integrator is a pure ``lax.scan`` of pure step kernels
(ops/registry.build_op), the whole trace is a differentiable function of
everything it closes over: medium parameters, launch positions/angles,
the step size, the anisotropy gamma.  That turns inverse problems —
"which medium bends rays like THIS?" — into ordinary gradient descent,
something the reference cannot express at all.

Two pieces:

* :class:`ParametricMedium` — a medium whose refractive index is
  ``n_fn(params, x, y)`` with ``params`` a pytree LEAF (traced), so
  ``jax.grad`` w.r.t. the parameters flows through every spline-free
  evaluation.  The x/y gradient the step kernels need comes from
  forward-mode autodiff, like :class:`media.medium.CustomMedium`.
* :func:`trace_diff` — a compact jit/grad-compatible integrator over the
  SAME op matrix as the production engine (any of op1-op12): fixed trip
  count, masked boundary exit, vmapped over rays, and no data-dependent
  host control flow, so it composes with ``jax.grad``, ``jax.vmap``,
  ``jax.jit`` and mesh sharding like any other JAX function.

Use the scan/kernel tiers for production forward tracing (they carry
Kahan compensation, history streaming, oracles); use this module when
the trace sits inside an optimization loop.  See
examples/inverse_medium.py and tests/test_diff.py.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from raytracing_tpu.media import fields as _fields
from raytracing_tpu.ops.registry import RayPoint, build_op, canonical


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ParametricMedium:
    """Medium ``n = n_fn(params, x, y)`` with TRACED parameters.

    Unlike :class:`media.medium.CustomMedium` (a static pytree whose
    closure is hashed into the jit cache), the parameters here are pytree
    leaves: a new parameter value re-uses the compiled trace, and
    ``jax.grad`` w.r.t. ``params`` differentiates through every index
    evaluation along every ray.  The x/y gradient the Fermat equations
    need is forward-mode autodiff of ``n_fn`` (exact, no finite
    differences), matching CustomMedium's treatment.
    """

    n_fn: Any                    # static: (params, x, y) -> n, elementwise
    params: Any                  # traced pytree

    def tree_flatten(self):
        return (self.params,), self.n_fn

    @classmethod
    def tree_unflatten(cls, n_fn, children):
        return cls(n_fn, children[0])

    def n(self, x, y):
        return self.n_fn(self.params, x, y)

    def n_and_grad(self, x, y):
        def f(xx, yy):
            return self.n_fn(self.params, xx, yy)

        n = f(x, y)
        ones = jnp.ones_like(x)
        zeros = jnp.zeros_like(x)
        _, dndx = jax.jvp(f, (x, y), (ones, zeros))
        _, dndy = jax.jvp(f, (x, y), (zeros, ones))
        return n, (dndx, dndy)


class DiffTrace(NamedTuple):
    """Final ray state of :func:`trace_diff` (unpacks like a 4-tuple)."""

    pos: Any          # (r, 2) final positions
    angle: Any        # (r,) final angles
    traveltime: Any   # (r,) optical path (trapezoid of n, RT_bench.py:874)
    active: Any       # (r,) 1.0 while inside the box, 0.0 after exit


def parametric_grid_medium(values, x0: float, y0: float, hx: float,
                           hy: float) -> ParametricMedium:
    """A sampled medium whose NODE VALUES are the traced parameters.

    ``values`` is a (ny, nx) array of n samples on a uniform grid with
    origin (x0, y0) and pitch (hx, hy); evaluation is bilinear (clamped at
    the edges), so ``jax.grad`` of any trace_diff loss w.r.t. ``values``
    is the tomography adjoint — see examples/tomography.py, which fits
    144 node values from crossing-ray travel times.  This is the
    differentiable counterpart of ``rt.grid_medium_from_samples`` (whose
    coefficient tables are precomputed host-side and therefore opaque to
    autodiff).
    """
    values = jnp.asarray(values)
    ny, nx = values.shape
    inv_hx, inv_hy = 1.0 / float(hx), 1.0 / float(hy)

    def n_fn(grid, x, y):
        fx = jnp.clip((x - x0) * inv_hx, 0.0, nx - 1 - 1e-9)
        fy = jnp.clip((y - y0) * inv_hy, 0.0, ny - 1 - 1e-9)
        ix = jnp.floor(fx).astype(jnp.int32)
        iy = jnp.floor(fy).astype(jnp.int32)
        u, v = fx - ix, fy - iy
        return (grid[iy, ix] * (1 - u) * (1 - v)
                + grid[iy, ix + 1] * u * (1 - v)
                + grid[iy + 1, ix] * (1 - u) * v
                + grid[iy + 1, ix + 1] * u * v)

    return ParametricMedium(n_fn, values)


def parametric_profile_medium(values, y0: float, hy: float
                              ) -> ParametricMedium:
    """An x-independent medium whose PROFILE SAMPLES are the traced
    parameters.

    ``values`` is (ny,) n samples on a uniform y grid — the differentiable
    counterpart of ``rt.stratified_medium_from_samples`` for inverse
    problems on measured profiles (e.g. recover a sound-speed-vs-depth
    profile from observed travel times or exit points).  Evaluation is
    linear in y, clamped at the edges; ``jax.grad`` of a trace_diff loss
    w.r.t. ``values`` is the 1-D tomography adjoint.
    """
    values = jnp.asarray(values)
    ny = values.shape[0]
    inv_hy = 1.0 / float(hy)

    def n_fn(prof, x, y):
        fy = jnp.clip((y - y0) * inv_hy, 0.0, ny - 1 - 1e-9)
        iy = jnp.floor(fy).astype(jnp.int32)
        v = fy - iy
        return prof[iy] * (1 - v) + prof[iy + 1] * v

    return ParametricMedium(n_fn, values)


def trace_diff(op_name: str, medium, pos0, theta0, delta_s, *, steps: int,
               box=None, gamma: float = 1.0, remat_segments: int = 1):
    """Differentiable fixed-step trace; returns the final ray state.

    ``pos0`` (r, 2) and ``theta0`` (r,) launch the fan; all ``steps``
    steps run with a fixed trip count, and once a ray leaves ``box``
    (xi, xs, yi, ys) its state freezes via masks — the same semantics as
    the production engine (RT_bench.py:878-879), expressed without
    data-dependent control flow so the whole thing is reverse-mode
    differentiable.  Returns ``(pos, angle, traveltime, active)``.

    Differentiable in: ``medium`` parameters (ParametricMedium leaves),
    ``pos0``, ``theta0``, ``delta_s``, ``gamma`` (pass a traced array to
    fit the anisotropy itself).  Gradient cost is one reverse sweep over
    the scan; reverse-mode stores O(steps) residuals, so for long traces
    set ``remat_segments=k`` to rematerialize: the scan splits into k
    ``jax.checkpoint`` segments, cutting residual memory ~k-fold for one
    extra forward pass (the standard sqrt(steps) trade — HBM is the
    binding resource for million-ray fans on an accelerator).  ``steps`` must then
    divide by k.  Gradients are identical either way (tested).

    Solver caveat: the golden-section ops (op5/op9/op10/op11) are
    piecewise CONSTANT in their cost function — the search's output angle
    depends on the physics only through comparison outcomes — so autodiff
    through them yields zero parameter gradients almost everywhere
    (verified in tests/test_diff.py).  Inside optimization loops use the
    smooth solvers (op1-op4, op6-op8, op12) or the Newton anisotropic
    extensions op10n/op11n, whose fixed smooth iterations carry exact
    gradients (gamma-gradient matches finite differences to ~1e-7).
    """
    op = canonical(op_name)
    dtype = jnp.asarray(pos0).dtype
    step_fn = build_op(op, dtype=dtype)
    # gamma may be a TRACER (fit the anisotropy itself); only a concrete
    # python 1.0 selects the cheaper isotropic coef path
    iso = isinstance(gamma, (int, float)) and gamma == 1.0

    pos0 = jnp.asarray(pos0)
    theta0 = jnp.asarray(theta0, dtype)
    n0, g0 = medium.n_and_grad(pos0[..., 0], pos0[..., 1])
    unitv0 = jnp.stack([jnp.cos(theta0), jnp.sin(theta0)], axis=-1)
    grad0 = jnp.stack([g0[0], g0[1]], axis=-1)
    coef0 = (jnp.ones_like(theta0) if iso
             else _fields.anisotropy(theta0, gamma))
    if step_fn.uses_window:
        window0 = jnp.broadcast_to(pos0[..., None, :],
                                   pos0.shape[:-1] + (4, 2))
    else:
        # don't carry (and store reverse-mode residuals for) op7's
        # rolling window when the solver never reads it
        window0 = None
    pt0 = RayPoint(pos=pos0, angle=theta0, unitv=unitv0, n=n0,
                   grad=grad0, coef=coef0, window=window0)
    active0 = jnp.ones_like(theta0)
    tt0 = jnp.zeros_like(theta0)

    if box is not None:
        xi, xs, yi, ys = [jnp.asarray(v, dtype) for v in box]

    def body(carry, i):
        pt, tt, active = carry
        res = step_fn(pt, i, medium, jnp.asarray(gamma, dtype),
                      jnp.asarray(delta_s, dtype))
        n1, grad1 = res.n, res.grad      # ops return the final-point eval
        dist = jnp.sqrt(jnp.sum((res.pos - pt.pos) ** 2, axis=-1))
        keep = active > 0.5
        pos = jnp.where(keep[..., None], res.pos, pt.pos)
        ang = jnp.where(keep, res.angle, pt.angle)
        unitv = jnp.stack([jnp.cos(ang), jnp.sin(ang)], axis=-1)
        coef = pt.coef if iso else _fields.anisotropy(ang, gamma)
        # optical path: trapezoid of the EFFECTIVE index coef*n along the
        # chord (RT_bench.py:784-790, 874; engine/trace.py n_eff)
        tt1 = tt + active * dist * 0.5 * (pt.coef * pt.n + coef * n1)
        if pt.window is None:
            window = None
        else:
            window = jnp.where(keep[..., None, None],
                               jnp.concatenate([pt.window[..., 1:, :],
                                                pos[..., None, :]],
                                               axis=-2),
                               pt.window)
        npt = RayPoint(pos=pos, angle=ang,
                       unitv=unitv,
                       n=jnp.where(keep, n1, pt.n),
                       grad=jnp.where(keep[..., None], grad1, pt.grad),
                       coef=coef, window=window)
        if box is not None:
            inside = ((pos[..., 0] >= xi) & (pos[..., 0] <= xs)
                      & (pos[..., 1] >= yi) & (pos[..., 1] <= ys))
            active = active * inside.astype(dtype)
        return (npt, tt1, active), None

    # step indices start at 1 (engine/trace.py:162): op7's backward-diff
    # order ramp keys on them (fd1 at step 1, fd2 at 2, fd3 from 3)
    if remat_segments <= 1:
        (ptf, ttf, activef), _ = jax.lax.scan(
            body, (pt0, tt0, active0), jnp.arange(1, steps + 1))
        return DiffTrace(ptf.pos, ptf.angle, ttf, activef)

    if steps % remat_segments:
        raise ValueError(f"steps {steps} must divide by remat_segments "
                         f"{remat_segments}")
    inner = steps // remat_segments

    @jax.checkpoint
    def segment(carry, k0):
        out, _ = jax.lax.scan(body, carry, k0 + jnp.arange(1, inner + 1))
        return out, None

    (ptf, ttf, activef), _ = jax.lax.scan(
        segment, (pt0, tt0, active0),
        jnp.arange(remat_segments) * inner)
    return DiffTrace(ptf.pos, ptf.angle, ttf, activef)
