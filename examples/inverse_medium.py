"""Inverse problem: recover a medium from observed rays by gradient descent.

The reference program (RT_bench.py) is a forward simulator — given a
medium, trace rays.  Because this framework's integrator is a pure JAX
function, the OPPOSITE question is also one line of ``jax.grad``: given
observed ray exits, which medium produced them?

Here we "measure" where a fan of rays lands after crossing a sharp
sigmoid interface of (unknown) thickness THCK (the reference's interface
profile, RT_bench.py:106-108), then fit the thickness by differentiating
the whole trace — 250 integration steps of the HySA method (op6,
RT_bench.py:602-624) — with respect to the parameter.  On a GPU the same
code fits thousands-of-parameter media (e.g. a full sampled n-grid) with
million-ray batches; see raytracing_tpu/engine/diff.py.

Run:  python examples/inverse_medium.py
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from raytracing_tpu import ParametricMedium, trace_diff

jax.config.update("jax_enable_x64", True)

TRUE_THCK = 0.12


def n_fn(thck, x, y):
    """Interface profile with free thickness (RT_bench.py:106-108)."""
    return jnp.sqrt(2.0) - (jnp.sqrt(2.0) - 1.0) / (1.0 + jnp.exp(-y / thck))


def main():
    r = 9
    theta0 = jnp.asarray(np.linspace(np.pi / 5, np.pi / 2.2, r))
    pos0 = jnp.asarray(np.tile(np.array([[-2.0, -1.0]]), (r, 1)))
    ds, steps = 0.02, 250

    def exits(thck):
        med = ParametricMedium(n_fn, thck)
        pos, *_ = trace_diff("op6", med, pos0, theta0, jnp.float64(ds),
                             steps=steps)
        return pos

    print(f"synthesizing observations at THCK={TRUE_THCK} ...")
    target = exits(jnp.float64(TRUE_THCK))

    def loss(thck):
        return jnp.mean(jnp.sum((exits(thck) - target) ** 2, axis=-1))

    vg = jax.jit(jax.value_and_grad(loss))
    opt = optax.adam(optax.exponential_decay(0.02, 50, 0.3))
    p = jnp.float64(0.2)
    state = opt.init(p)
    t0 = time.time()
    for i in range(150):
        val, g = vg(p)
        up, state = opt.update(g, state)
        p = p + up
        if i % 25 == 0:
            print(f"  iter {i:3d}  thck={float(p):.6f}  "
                  f"loss={float(val):.3e}  dloss/dthck={float(g):+.3f}")
    print(f"recovered THCK = {float(p):.6f} (true {TRUE_THCK}) "
          f"in {time.time() - t0:.1f}s — loss {float(loss(p)):.2e}")


if __name__ == "__main__":
    main()
