"""Travel-time tomography: recover a 2-D index field from crossing rays.

The classic inverse problem of this physics domain (seismics, ocean
acoustics, ultrasound): fire fans of rays through an unknown medium from
all four sides, record exit travel times and positions, and reconstruct
the refractive-index field.  The reference program can only simulate the
FORWARD direction; here the whole reconstruction is `jax.grad` through
`rt.trace_diff` (engine/diff.py) w.r.t. a 12x12 grid of n values (144
parameters) with a smoothness prior — Adam converges in ~600 steps.

Run:  python examples/tomography.py
(≈25 s on CPU; the same program jit-compiles for the GPU, where million-ray
fans and finer grids are the same code.)
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

import raytracing_tpu as rt

jax.config.update("jax_enable_x64", True)

NG = 12                                   # reconstruction grid (NG x NG)
BOX = (-1.0, 1.0, -1.0, 1.0)


def make_fans(m=40):
    """Fans of rays entering from all four sides of the box."""
    t = np.linspace(-0.9, 0.9, m)
    spread = np.linspace(-0.7, 0.7, m)
    srcs = [np.stack([np.full(m, -1.0), t], 1),
            np.stack([t, np.full(m, -1.0)], 1),
            np.stack([np.full(m, 1.0), t], 1),
            np.stack([t, np.full(m, 1.0)], 1)]
    angs = [spread, np.pi / 2 + spread, np.pi + spread, -np.pi / 2 + spread]
    return (jnp.asarray(np.concatenate(srcs)),
            jnp.asarray(np.concatenate(angs)))


def ascii_field(a, lo, hi):
    chars = " .:-=+*#%@"
    q = np.clip((a - lo) / (hi - lo + 1e-12), 0, 0.999)
    return "\n".join("".join(chars[int(v * 10)] for v in row) for row in q)


def main():
    X, Y = np.meshgrid(np.linspace(-1, 1, NG), np.linspace(-1, 1, NG))
    truth = jnp.asarray(
        1.0 + 0.15 * np.exp(-((X - 0.2) ** 2 + (Y + 0.1) ** 2) / 0.08))
    pos0, th0 = make_fans()
    steps, ds = 170, 0.015

    h = 2.0 / (NG - 1)

    def observe(grid):
        med = rt.parametric_grid_medium(grid, -1.0, -1.0, h, h)
        pos, _, tt, _ = rt.trace_diff("op6", med, pos0, th0,
                                      jnp.float64(ds), steps=steps, box=BOX)
        return tt, pos

    print(f"synthesizing observations: {pos0.shape[0]} rays x {steps} "
          f"steps through the hidden medium ...")
    target_tt, target_pos = observe(truth)

    def loss(grid):
        tt, pos = observe(grid)
        data = (jnp.mean((tt - target_tt) ** 2)
                + jnp.mean(jnp.sum((pos - target_pos) ** 2, -1)))
        dgx = grid[:, 1:] - grid[:, :-1]
        dgy = grid[1:, :] - grid[:-1, :]
        return data + 0.02 * (jnp.mean(dgx ** 2) + jnp.mean(dgy ** 2))

    vg = jax.jit(jax.value_and_grad(loss))
    opt = optax.adam(optax.exponential_decay(0.01, 200, 0.3))
    p = jnp.ones((NG, NG), jnp.float64)
    state = opt.init(p)
    t0 = time.time()
    for i in range(600):
        val, g = vg(p)
        up, state = opt.update(g, state)
        p = p + up
        if i % 100 == 0:
            print(f"  iter {i:3d}  loss={float(val):.3e}")
    rec, tr = np.asarray(p), np.asarray(truth)
    corr = np.corrcoef((rec - 1).ravel(), (tr - 1).ravel())[0, 1]
    ci = np.corrcoef((rec - 1)[2:-2, 2:-2].ravel(),
                     (tr - 1)[2:-2, 2:-2].ravel())[0, 1]
    lo, hi = tr.min(), tr.max()
    print(f"\ntruth (n in [{lo:.2f}, {hi:.2f}]):")
    print(ascii_field(tr, lo, hi))
    print("\nreconstruction:")
    print(ascii_field(rec, lo, hi))
    print(f"\ncorrelation {corr:.3f} (interior {ci:.3f}) "
          f"in {time.time() - t0:.1f}s / 600 Adam steps")


if __name__ == "__main__":
    main()
