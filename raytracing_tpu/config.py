"""Static configuration: physical constants, solver parameters, scenarios.

This module replaces the reference's module-global constant block
(RT_bench.py:53-97) and the per-scenario parameter table ``constants()``
(RT_bench.py:247-295) with explicit, immutable dataclasses.  Nothing here is
mutable global state: the reference's pattern of binding the medium function
``f`` and the anisotropy ``gamma`` as module globals (RT_bench.py:1567-1580,
725-728) is replaced by passing a :class:`ScenarioConfig` explicitly.

All values are computed in float64 on host; device code casts them to the
working dtype when tracing.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

# ---------------------------------------------------------------------------
# Interface-scenario geometry (RT_bench.py:59-61).
# ---------------------------------------------------------------------------
#: Thickness parameter of the sigmoid interface.
THCK_PARAM: float = 0.005
#: Auxiliary number for SIGMA (RT_bench.py:60).
_A_AUX: float = (1.0 + math.sqrt(2.0)) / 2.0 - 99.0 * (math.sqrt(2.0) - 1.0) / 200.0
#: True thickness of the interface — the smallest feature in a simulation.
SIGMA: float = -2.0 * THCK_PARAM * math.log((_A_AUX - 1.0) / (math.sqrt(2.0) - _A_AUX))

# ---------------------------------------------------------------------------
# Golden-section search (RT_bench.py:64-66).
# ---------------------------------------------------------------------------
#: Half interval size for the golden search: the search window is theta +/- DELTA_G.
DELTA_G: float = math.pi / 2.0
#: The golden ratio conjugate used to shrink the bracket.
GOLD_RATIO: float = (math.sqrt(5.0) - 1.0) / 2.0


def gold_tol(dtype=np.float64) -> float:
    """Golden-search tolerance, sqrt of machine epsilon of the working dtype.

    The reference pins this to sqrt(float64 eps) (RT_bench.py:66) because it
    only ever runs float64.  On an accelerator the natural working dtype is float32, for
    which sqrt(eps_f64) is unreachable noise — so the tolerance follows the
    dtype instead.
    """
    return float(np.sqrt(np.finfo(np.dtype(dtype)).eps))


def golden_iters(dtype=np.float64, width: float = 2.0 * DELTA_G) -> int:
    """Fixed golden-section iteration count reaching :func:`gold_tol`.

    The reference's ``golden`` loops ``while |c - d| > GOLD_TOL``
    (RT_bench.py:190); with bracket width ``w`` the gap is ``w * (2r - 1)``
    and ``w`` shrinks by ``r`` per iteration, so the loop runs a fixed,
    data-independent number of times.  A static trip count keeps the search
    branchless under ``jit`` — identical convergence, no dynamic control flow.
    """
    tol = gold_tol(dtype)
    r = GOLD_RATIO
    # Smallest k with width * r**k * (2r - 1) <= tol.
    k = math.ceil(math.log(tol / (width * (2.0 * r - 1.0))) / math.log(r))
    return max(k, 1)


# ---------------------------------------------------------------------------
# Simulation parameters (RT_bench.py:69-97).
# ---------------------------------------------------------------------------
#: Max acceptable mean outbound-angle error (deg) for the interface scenario.
MAX_DEVIATION: float = 0.2
#: Max acceptable *per-ray* outbound-angle error (deg) (RT_bench.py:1329).
MAX_DEVIATION_SINGLE_RAY: float = 0.8
#: Fisheye closure-error acceptance threshold, percent of 2*pi (RT_bench.py:1306).
MAX_CLOSURE_ERROR_PCT: float = 5.0
#: Momentum-conservation CV acceptance threshold, percent (RT_bench.py:1310).
MAX_MOMENTUM_CV_PCT: float = 0.05

#: Grid pitch used to sample a medium (RT_bench.py:77).
DELTA: float = SIGMA / 3.0
#: Default divisor of SIGMA giving the arc-length step (RT_bench.py:79).
DELTA_S_DIVISOR: float = 20.0
#: Default arc-length step (RT_bench.py:81).
DELTA_S: float = SIGMA / DELTA_S_DIVISOR
#: Fisheye: number of turns around the unit circle (RT_bench.py:82).
N_TURNS: int = 10
#: Fisheye: segments the unit-circle perimeter is divided into (RT_bench.py:84).
DELTA_S_DIVISOR_FISHEYE: int = 90

# DELTA_S-search bounds (RT_bench.py:89-97).
DELTA_STEP: float = 0.01
DELTA_S_DIVISOR_UPPER_LIMIT: float = 3.0
DELTA_S_DIVISOR_LOWER_LIMIT: float = 1.0 + DELTA_STEP
DELTA_STEP_FISHEYE: float = 1.0
DELTA_S_DIVISOR_FISHEYE_UPPER_LIMIT: float = 303.0
DELTA_S_DIVISOR_FISHEYE_LOWER_LIMIT: float = 4.0
DELTA_STEP_VERT: float = 0.005
DELTA_S_DIVISOR_VERT_UPPER_LIMIT: float = 2.0
DELTA_S_DIVISOR_VERT_LOWER_LIMIT: float = 1.0 / 40.0


# ---------------------------------------------------------------------------
# Scenarios (RT_bench.py:247-295).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Immutable description of one validation scenario.

    Mirrors the tuple returned by the reference's ``constants()``
    (RT_bench.py:247-295), with the launch fan and start positions
    materialised as arrays and the one-hot ``op_*`` flags replaced by the
    ``name`` discriminator.
    """

    name: str            # "interface" | "fisheye" | "vert" | "aniso"
    key: str             # reference menu number, "1".."4"
    field: str           # isotropic index field: media.fields key
    gamma: float         # anisotropy ratio; 1.0 means isotropic
    ray_count: int
    theta0: np.ndarray   # (ray_count,) launch angles, radians
    pos0: np.ndarray     # (ray_count, 2) launch positions
    s_max: float         # maximum arc length per ray
    box: tuple[float, float, float, float]  # (limx_i, limx_s, limy_i, limy_s)

    @property
    def is_interface(self) -> bool:
        return self.name == "interface"

    @property
    def is_fisheye(self) -> bool:
        return self.name == "fisheye"

    @property
    def is_vert(self) -> bool:
        return self.name in ("vert", "aniso")

    @property
    def is_aniso(self) -> bool:
        return self.name == "aniso"

    def max_size(self, delta_s: float, divisor: int | None = None,
                 n_turns: int = N_TURNS) -> int:
        """Trajectory buffer length for a given step size.

        Fisheye uses ``n_turns * divisor`` rows (RT_bench.py:797); all other
        scenarios use ``ceil(s_max / delta_s) + 1`` (RT_bench.py:799).  Note
        the reference quirk: ``trazar`` is invoked with
        ``DELTA_S_DIVISOR_FISHEYE + 1`` (RT_bench.py:1388,1463), so with
        ``delta_s = 2*pi/div`` the fisheye ray integrates ``n_turns*(div+1)-1``
        steps — exactly one full turn when ``n_turns == 1`` and slightly more
        than ``n_turns`` turns otherwise.  Callers wanting reference parity
        pass ``divisor = div + 1``.
        """
        if self.is_fisheye:
            if divisor is None:
                raise ValueError("fisheye max_size requires a divisor")
            return int(n_turns * divisor)
        return int(np.ceil(self.s_max / delta_s) + 1)


def scenario(name: str, n_turns: int = N_TURNS) -> ScenarioConfig:
    """Build one of the four reference scenarios by name or menu key."""
    aliases = {
        "1": "interface", "2": "fisheye", "3": "vert", "4": "aniso",
        "vert_heterogeneous": "vert", "anisotropy": "aniso",
    }
    name = aliases.get(name, name)
    if name == "interface":
        # RT_bench.py:257-264.  The fan has ray_count+1 angles but only the
        # first ray_count are ever traced (loop at RT_bench.py:807) — the
        # pi/2 endpoint is deliberately dropped here.
        ray_count = 42
        fan = np.linspace(2.0 * (np.pi / 60.0), np.pi / 2.0, ray_count + 1)
        theta0 = fan[:ray_count]
        pos0 = np.stack([np.full(ray_count, -2.0), np.full(ray_count, -2.0)], -1)
        return ScenarioConfig(
            name="interface", key="1", field="interface", gamma=1.0,
            ray_count=ray_count, theta0=theta0, pos0=pos0, s_max=80.0,
            box=(-2.0, 20.0, -2.0, 4.0),
        )
    if name == "fisheye":
        # RT_bench.py:265-272: a single ray launched straight up from (1, 0).
        theta0 = np.array([np.pi / 2.0])
        pos0 = np.array([[1.0, 0.0]])
        return ScenarioConfig(
            name="fisheye", key="2", field="fisheye", gamma=1.0,
            ray_count=1, theta0=theta0, pos0=pos0,
            s_max=n_turns * 2.0 * np.pi, box=(-1.5, 1.5, -1.5, 1.5),
        )
    if name in ("vert", "aniso"):
        # RT_bench.py:273-294.
        ray_count = 31
        theta0 = np.linspace(0.0, np.pi / 2.0, ray_count)
        pos0 = np.stack([np.full(ray_count, -2.0), np.full(ray_count, -2.0)], -1)
        return ScenarioConfig(
            name=name, key="3" if name == "vert" else "4",
            field="vert_heterogeneous", gamma=1.0 if name == "vert" else 3.0,
            ray_count=ray_count, theta0=theta0, pos0=pos0, s_max=80.0,
            box=(-2.0, 5.0, -2.5, 1.0),
        )
    raise ValueError(f"unknown scenario {name!r}")


SCENARIO_NAMES = ("interface", "fisheye", "vert", "aniso")
