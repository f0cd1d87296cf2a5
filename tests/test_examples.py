"""Examples stay runnable: each examples/*.py executes end-to-end on CPU.

The examples are the front door a reference user meets first; this module
keeps them from bit-rotting.  Scripts with benchmark-scale defaults run
in a subprocess with a CPU pin and (where supported) reduced settings.
"""
import pathlib
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PRELUDE = (
    "import sys; sys.path.insert(0, {root!r}); "
    "import jax; jax.config.update('jax_platforms', 'cpu'); "
    "import runpy; ").format(root=str(ROOT))


def _run(script, extra="", timeout=420):
    code = (_PRELUDE + extra
            + f"runpy.run_path({str(ROOT / 'examples' / script)!r}, "
              "run_name='__main__')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=timeout)
    assert r.returncode == 0, f"{script}\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}"
    return r.stdout


def test_inverse_medium_example(tmp_path):
    out = _run("inverse_medium.py")
    assert "recovered THCK" in out


def test_tomography_example():
    out = _run("tomography.py")
    assert "correlation" in out


def test_delta_s_search_example(tmp_path):
    # run from a tmp cwd so the checkpoint file lands there
    code = (_PRELUDE
            + f"import os; os.chdir({str(tmp_path)!r}); "
            + f"runpy.run_path({str(ROOT / 'examples' / 'delta_s_search.py')!r}, "
              "run_name='__main__')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=420)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "selected divisor" in r.stdout


def test_sampled_medium_production_example():
    out = _run("sampled_medium_production.py",
               extra="sys.argv = ['x', '4096']; ")
    assert "fisheye 2-D spline [scan]" in out and "DELTA_S search" in out


def test_ocean_waveguide_example():
    out = _run("ocean_waveguide.py", extra="sys.argv = ['x', '4096', '400']; ")
    assert "trapped in the channel" in out
    import re
    m = re.search(r"max (\d+\.\d+e-\d+) %", out)
    assert m and float(m[1]) < 0.05     # p_x conservation on the kernel fan
    assert "tomography adjoint" in out


def test_measured_medium_example():
    out = _run("measured_medium.py",
               extra="sys.argv = ['x', '4096', '150']; ")
    # both media take the scan tier (2-D grid media run there) and the C1
    # medium must track the smooth truth at least as well as the parity
    # pipeline
    assert out.count("[scan]") == 2, out
    import re
    devs = {m[1]: float(m[2]) for m in
            re.finditer(r"(\w+)\s+max trajectory deviation.*?: ([\d.e+-]+)",
                        out)}
    assert devs["c1"] <= devs["parity"], devs
    assert "df32+c1 deviation" in out


def test_transmission_loss_example():
    out = _run("transmission_loss.py", extra="sys.argv = ['x', '6', '160']; ")
    assert out.strip().endswith("ok")
    assert "free cylindrical would be" in out


def test_eddy_3d_example():
    # enough steps to pass the 20 km eddy with runway for the deflection
    out = _run("eddy_3d.py", extra="sys.argv = ['x', '32', '2300']; ")
    assert out.strip().endswith("ok")
    assert "out-of-plane" in out
    assert "from raw samples" in out     # the tri-Hermite measured-grid leg


def test_tl_field_map_example(tmp_path):
    out = _run("tl_field_map.py",
               extra=f"sys.argv = ['x', '9', '7', '128', "
                     f"{str(tmp_path / 'm.png')!r}]; ", timeout=420)
    assert out.strip().endswith("ok")
    assert "duct trapping" in out
    assert (tmp_path / "m.png").stat().st_size > 0
