"""The op matrix: 11 single-step kernels pairing steppers with angle solvers.

Port of the reference's ``op1`` .. ``op11`` (RT_bench.py:467-764).  Each op is
a *pure, branch-free* function of the instantaneous ray point — the curvature
ops' ``if ignore`` branches (RT_bench.py:538-541, 566-569, 594-598, 723-732)
become masked selects, and op7's global ``VECTOR_LIST`` window lives in the
ray state.  Because the functions are shape-polymorphic they run scalar,
vmapped over million-ray batches, or inside Pallas kernels unchanged.

Build a step function with :func:`build_op`; the returned callable has the
uniform signature::

    result = step(pt: RayPoint, step_idx, medium, gamma, delta_s)

mirroring the reference's uniform op signature (RT_bench.py:469, 702).

| op   | stepper            | angle solver                     | ref lines |
|------|--------------------|----------------------------------|-----------|
| op1  | 1st-order Taylor   | analytic momentum-impulse        | 469-491   |
| op2  | 1st-order Taylor   | RK2 d(theta)/ds  (AnDF)          | 493-515   |
| op3  | curvature          | RK2 d(theta)/ds                  | 517-543   |
| op4  | curvature          | analytic momentum-impulse        | 545-571   |
| op5  | curvature          | golden-optimized cost            | 573-600   |
| op6  | 2nd-order Taylor   | RK2 d(theta)/ds  (HySA)          | 602-624   |
| op7  | 2nd-order Taylor   | 4-point backward diff (MxSA)     | 626-650   |
| op8  | 2nd-order Taylor   | analytic momentum-impulse        | 652-674   |
| op9  | 2nd-order Taylor   | golden-optimized cost            | 676-700   |
| op10 | curvature          | golden on anisotropic momentum   | 702-734   |
| op11 | 2nd-order Taylor   | golden on anisotropic momentum   | 736-764   |
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu import config
from raytracing_tpu.media.fields import anisotropy
from raytracing_tpu.ops import angles as A
from raytracing_tpu.ops import steppers as S
from raytracing_tpu.ops.golden import golden_minimize
from raytracing_tpu.ops.momentum import moment


class RayPoint(NamedTuple):
    """Instantaneous ray state entering one integration step."""

    pos: Any      # (..., 2)
    angle: Any    # (...,)
    unitv: Any    # (..., 2) == (cos angle, sin angle)
    n: Any        # (...,) isotropic index at pos
    grad: Any     # (..., 2) gradient of n at pos
    coef: Any     # (...,) anisotropy factor at angle (1 when isotropic)
    window: Any   # (..., 4, 2) rolling position window (op7 only)


class StepResult(NamedTuple):
    """Quantities produced by one step, pre-"store_update"."""

    pos: Any      # (..., 2)
    angle: Any    # (...,)
    n: Any        # (...,)
    grad: Any     # (..., 2)


def _eval_medium(medium, pos):
    n, (gx, gy) = medium.n_and_grad(pos[..., 0], pos[..., 1])
    return n, jnp.stack([gx, gy], axis=-1)


def _iso_cost(theta, final_n, init_n, unitv, i_grad, f_grad, step):
    """Isotropic 2-point momentum-impulse cost (RT_bench.py:595, 697)."""
    jx = A.impulse_t(i_grad[..., 0], f_grad[..., 0], step)
    jy = A.impulse_t(i_grad[..., 1], f_grad[..., 1], step)
    rx = final_n * jnp.cos(theta) - init_n * unitv[..., 0] - jx
    ry = final_n * jnp.sin(theta) - init_n * unitv[..., 1] - jy
    return rx * rx + ry * ry


def _aniso_cost(theta, final_n, mi_x, mi_y, coef_i, i_grad, f_grad, step, gamma):
    """Anisotropic momentum cost of op10/op11 (RT_bench.py:728, 761)."""
    st, ct = jnp.sin(theta), jnp.cos(theta)
    coef_f = anisotropy(theta, gamma)
    mf_x = moment(final_n, theta, gamma, ct, -(st * st))
    mf_y = moment(final_n, theta, gamma, st, ct * ct)
    jx = A.impulse_t(coef_i * i_grad[..., 0], coef_f * f_grad[..., 0], step)
    jy = A.impulse_t(coef_i * i_grad[..., 1], coef_f * f_grad[..., 1], step)
    rx = mf_x - mi_x - jx
    ry = mf_y - mi_y - jy
    return rx * rx + ry * ry


def _golden_iso(pt, final_n, f_grad, step, gold_iters):
    cost = lambda t: _iso_cost(t, final_n, pt.n, pt.unitv, pt.grad, f_grad, step)
    return golden_minimize(cost, pt.angle - config.DELTA_G,
                           pt.angle + config.DELTA_G, gold_iters)


def _golden_aniso(pt, final_n, f_grad, step, gamma, gold_iters):
    ux, uy = pt.unitv[..., 0], pt.unitv[..., 1]
    mi_x = moment(pt.n, pt.angle, gamma, ux, -(uy * uy))
    mi_y = moment(pt.n, pt.angle, gamma, uy, ux * ux)
    cost = lambda t: _aniso_cost(t, final_n, mi_x, mi_y, pt.coef,
                                 pt.grad, f_grad, step, gamma)
    return golden_minimize(cost, pt.angle - config.DELTA_G,
                           pt.angle + config.DELTA_G, gold_iters)


# angle-solver tags: how each op determines the outgoing angle
_SPECS = {
    # name: (stepper, solver)
    "op1": ("taylor1", "cost"),
    "op2": ("taylor1", "rk2"),
    "op3": ("curv", "rk2"),
    "op4": ("curv", "cost"),
    "op5": ("curv", "golden"),
    "op6": ("taylor2", "rk2"),
    "op7": ("taylor2", "fd"),
    "op8": ("taylor2", "cost"),
    "op9": ("taylor2", "golden"),
    "op10": ("curv", "golden_aniso"),
    "op11": ("taylor2", "golden_aniso"),
    # framework extensions (not in the reference): Newton refinement of the
    # anisotropic momentum solve — see ops/newton.py
    "op10n": ("curv", "newton_aniso"),
    "op11n": ("taylor2", "newton_aniso"),
    # classical RK4 on the joint (position, angle) ray ODE: global error
    # O(delta_s^4) vs the reference's best O(delta_s^2) — the route to the
    # 1e-6 RMS north-star accuracy at practical step sizes
    "op12": ("rk4", "joint"),
}

ALIASES = {"AnDF": "op2", "HySA": "op6", "MxSA": "op7"}
#: the reference's 11 step methods
OP_NAMES = tuple(f"op{i}" for i in range(1, 12))
#: extensions beyond the reference
EXTENSION_OPS = tuple(n for n in _SPECS if n not in OP_NAMES)
#: ops valid for anisotropic scenarios (reference menu RT_bench.py:1268-1294)
ANISO_OPS = ("op10", "op11", "op10n", "op11n")
#: ops whose angle comes from a golden-section search (RT_bench.py:175-199):
#: piecewise constant in the cost, so autodiff tangents/gradients vanish
#: a.e. — excluded from the diff and dynamic tiers (engine/diff.py,
#: engine/dynamic.py)
GOLDEN_OPS = ("op5", "op9", "op10", "op11")


def canonical(name: str) -> str:
    name = ALIASES.get(name, name)
    if name not in _SPECS:
        raise ValueError(f"unknown op {name!r}; have {OP_NAMES} + {tuple(ALIASES)}")
    return name


def build_op(name: str, dtype=np.float32):
    """Build the single-step kernel for op ``name`` at working dtype ``dtype``.

    The dtype fixes two statics: the curvature-negligibility threshold (the
    reference reuses GOLD_TOL for it, RT_bench.py:355) and the golden-section
    trip count.
    """
    name = canonical(name)
    stepper, solver = _SPECS[name]
    tol = config.gold_tol(dtype)
    gold_iters = config.golden_iters(dtype)

    def step(pt: RayPoint, step_idx, medium, gamma, delta_s) -> StepResult:
        if stepper == "rk4":
            # Joint RK4 on dr/ds = (cos t, sin t),
            # dt/ds = (cos t * dn/dy - sin t * dn/dx)/n  — the same ODE the
            # reference integrates with RK2 in tfinal_2o (RT_bench.py:374-391),
            # two orders higher.
            def f(pos, th):
                n, (gx, gy) = medium.n_and_grad(pos[..., 0], pos[..., 1])
                c, s = jnp.cos(th), jnp.sin(th)
                dth = (c * gy - s * gx) / n
                return jnp.stack([c, s], axis=-1), dth

            h = delta_s
            k1p, k1t = f(pt.pos, pt.angle)
            k2p, k2t = f(pt.pos + 0.5 * h * k1p, pt.angle + 0.5 * h * k1t)
            k3p, k3t = f(pt.pos + 0.5 * h * k2p, pt.angle + 0.5 * h * k2t)
            k4p, k4t = f(pt.pos + h * k3p, pt.angle + h * k3t)
            f_pos = pt.pos + (h / 6.0) * (k1p + 2 * k2p + 2 * k3p + k4p)
            f_angle = pt.angle + (h / 6.0) * (k1t + 2 * k2t + 2 * k3t + k4t)
            final_n, f_grad = _eval_medium(medium, f_pos)
            return StepResult(pos=f_pos, angle=f_angle, n=final_n, grad=f_grad)

        # --- position advancement -------------------------------------
        if stepper == "taylor1":
            f_pos = S.first_order_taylor(pt.pos, pt.unitv, delta_s)
            significant = None
        elif stepper == "taylor2":
            f_pos = S.second_order_taylor(pt.pos, pt.unitv, delta_s, pt.n, pt.grad)
            significant = None
        else:  # curvature
            f_pos, significant = S.curvature_step(
                pt.angle, pt.grad, pt.unitv, pt.n, pt.pos, delta_s, tol)

        final_n, f_grad = _eval_medium(medium, f_pos)

        # --- angle determination --------------------------------------
        if solver == "cost":
            f_angle = A.theta_cost_t(pt.n, pt.angle, pt.grad, f_grad, delta_s)
        elif solver == "rk2":
            f_angle = A.tfinal_2o(pt.angle, delta_s, pt.n, final_n, pt.grad, f_grad)
        elif solver == "golden":
            f_angle = _golden_iso(pt, final_n, f_grad, delta_s, gold_iters)
        elif solver == "golden_aniso":
            f_angle = _golden_aniso(pt, final_n, f_grad, delta_s, gamma, gold_iters)
        elif solver == "newton_aniso":
            from raytracing_tpu.ops.newton import newton_minimize
            ux, uy = pt.unitv[..., 0], pt.unitv[..., 1]
            mi_x = moment(pt.n, pt.angle, gamma, ux, -(uy * uy))
            mi_y = moment(pt.n, pt.angle, gamma, uy, ux * ux)
            f_angle = newton_minimize(
                lambda t: _aniso_cost(t, final_n, mi_x, mi_y, pt.coef,
                                      pt.grad, f_grad, delta_s, gamma),
                pt.angle)
        else:  # fd: 4-point backward difference with order ramp-up.
            # The reference primes the first two steps manually outside the
            # loop with 1st/2nd-order differences (RT_bench.py:833-864); here
            # the order ramps up in-scan: step 1 -> fd1, step 2 -> fd2,
            # step >= 3 -> fd3.  Identical arithmetic, no special-cased code.
            window = A.push_window(pt.window, f_pos)
            order = jnp.clip(step_idx, 1, 3) - 1
            f_angle = jax.lax.switch(
                order,
                [A.finite_diff_1, A.finite_diff_2, A.finite_diff_3],
                window,
            )

        # Curvature ops keep the old angle when curvature is negligible
        # (RT_bench.py:538-541, 566-569, 594-598, 731-732).
        if significant is not None:
            f_angle = jnp.where(significant, f_angle, pt.angle)

        return StepResult(pos=f_pos, angle=f_angle, n=final_n, grad=f_grad)

    step.op_name = name
    step.uses_window = solver == "fd"
    return step
