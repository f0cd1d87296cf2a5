"""Native C++ spline builder vs the scipy/FITPACK oracle."""
import time

import numpy as np
import pytest

from raytracing_tpu import native
from raytracing_tpu.media import grid as gridmod
from raytracing_tpu.media.spline import build_grid_medium

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="g++ toolchain unavailable")


def test_gradient2_matches_numpy():
    rng = np.random.default_rng(0)
    Z = rng.normal(size=(57, 83))
    h = 0.13
    ddx, ddy = native.gradient2(Z, h)
    want_dy, want_dx = np.gradient(Z, h, edge_order=2)
    np.testing.assert_allclose(ddx, want_dx, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ddy, want_dy, rtol=1e-12, atol=1e-12)


def test_bicubic_cells_match_scipy_spline():
    from scipy.interpolate import RectBivariateSpline

    rng = np.random.default_rng(1)
    ny, nx = 40, 55
    hy, hx = 0.21, 0.17
    y = np.arange(ny) * hy
    x = np.arange(nx) * hx
    Z = np.cos(y[:, None]) * np.sin(x[None, :]) + 0.1 * rng.normal(size=(ny, nx))

    C = native.bicubic_cells(Z)
    spl = RectBivariateSpline(y, x, Z, kx=3, ky=3)

    qy = rng.uniform(0, (ny - 1) * hy, 400)
    qx = rng.uniform(0, (nx - 1) * hx, 400)
    iy = np.minimum((qy / hy).astype(int), ny - 2)
    ix = np.minimum((qx / hx).astype(int), nx - 2)
    uy = qy / hy - iy
    ux = qx / hx - ix
    py = np.stack([np.ones_like(uy), uy, uy**2, uy**3], -1)
    px = np.stack([np.ones_like(ux), ux, ux**2, ux**3], -1)
    got = np.einsum("qab,qa,qb->q", C[iy, ix], py, px)
    want = spl(qy, qx, grid=False)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_native_grid_medium_matches_scipy_backend():
    box = (-1.5, 1.5, -1.5, 1.5)
    m_native = build_grid_medium("fisheye", box, dtype=np.float64,
                                 backend="native")
    m_scipy = build_grid_medium("fisheye", box, dtype=np.float64,
                                backend="scipy")
    rng = np.random.default_rng(2)
    qx = rng.uniform(-2, 2, 300)
    qy = rng.uniform(-2, 2, 300)
    n1, (gx1, gy1) = m_native.n_and_grad(qx, qy)
    n2, (gx2, gy2) = m_scipy.n_and_grad(qx, qy)
    np.testing.assert_allclose(np.asarray(n1), np.asarray(n2), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(gx1), np.asarray(gx2),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(np.asarray(gy1), np.asarray(gy2),
                               rtol=1e-7, atol=1e-10)


@pytest.mark.slow  # heavyweight: deselected by -m 'not slow' (CLAUDE.md smoke tier)
def test_native_builder_is_faster_on_reference_grid():
    """The point of going native: the interface-scenario grid (~1M points).

    Best-of-3 per backend: single timings flake when the host is loaded
    (e.g. another benchmark hammering the box in a parallel session)."""
    box = (-2.0, 20.0, -2.0, 4.0)

    def best(backend):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            build_grid_medium("interface", box, dtype=np.float32,
                              backend=backend)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t_native = best("native")
    t_scipy = best("scipy")
    assert t_native < t_scipy, (t_native, t_scipy)
