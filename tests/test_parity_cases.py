"""The parity cases chip_smoke.py checks on the GPU, measured on the CPU.

Each kernel entry runs in interpret mode on the stride subset of the
full-width fan and is compared with the float64 scan tier; the bound the
GPU run is held to (``parity.BOUND``) is four times this deviation.
"""
import numpy as np
import pytest

from raytracing_tpu.bench import parity

NAMES = tuple(parity.BOUND)


def test_every_case_has_a_bound():
    assert set(parity.cases()) == set(parity.BOUND)


@pytest.mark.parametrize("name", NAMES)
def test_cpu_deviation_is_a_quarter_of_the_bound(name):
    case = parity.cases()[name]
    pos0, launch = parity.subset_fan(case)
    assert len(pos0) == parity.FULL_RAYS // parity.STRIDE
    out, engine = case.kernel(pos0, launch)
    dev = parity.deviation(case, out, pos0, launch)
    assert np.isfinite(dev)
    assert 4.0 * dev <= parity.BOUND[name], (engine, dev)


def test_subset_fan_is_the_strided_full_fan():
    case = parity.cases()["fisheye"]
    full_p, full_t = case.fan(parity.FULL_RAYS)
    p, t = parity.subset_fan(case)
    np.testing.assert_array_equal(full_p[::parity.STRIDE], p)
    np.testing.assert_array_equal(full_t[::parity.STRIDE], t)
