"""Model zoo: ready-to-trace (scenario, medium) pairings with calibrated steps.

The framework's "model families" are the four physics scenarios
(RT_bench.py:104-119, 247-295), each available with five medium backends:

* ``analytic``      — closed-form n / grad n (exact; fastest kernels)
* ``stratified``    — the reference's sampled-spline pipeline collapsed to
  1-D tables for the x-independent fields (production medium; kernel
  tier via the table-gather kernels)
* ``grid``          — the full 2-D sampled-spline pipeline (bit-faithful
  to FITPACK; scan tier)
* ``c1``            — consistent-gradient 2-D medium (media/c1.py): one
  spline serves n AND grad n — conservation at the analytic floor,
  16-float kernel cells (PARITY.md #29)
* ``c1-stratified`` — the 1-D consistent form for x-independent fields

A model resolves calibrated step sizes (RT_bench.py:1413-1455, with the
base-op fallback for extension ops) and runs either execution tier in one
call::

    model = raytracing_tpu.models.get("interface", medium="stratified")
    res = model.run("HySA")                # fused kernels, calibrated step
    res = model.trace("HySA")              # reference-parity scan engine
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from raytracing_tpu import config
from raytracing_tpu.media.medium import analytic_medium

MEDIUM_KINDS = ("analytic", "stratified", "grid", "c1", "c1-stratified")


@dataclasses.dataclass(frozen=True)
class Model:
    name: str
    scenario: config.ScenarioConfig
    medium: Any          # AnalyticMedium | StratifiedGridMedium | GridMedium
    medium_kind: str     # one of MEDIUM_KINDS

    def delta_s(self, op_name: str) -> tuple[float, float | None]:
        """Calibrated (delta_s, divisor) for ``op_name`` on this scenario.

        Extension ops borrow their base op's entry (op12 -> op8, opNn ->
        opN); combos absent from the table fall back to op8's
        (RT_bench.py:1408-1460).
        """
        from raytracing_tpu.calibrated import calibrated_with_fallback
        from raytracing_tpu.ops.registry import canonical

        return calibrated_with_fallback(canonical(op_name),
                                        self.scenario.name)

    def trace(self, op_name: str, *, delta_s: float | None = None,
              n_turns: int = config.N_TURNS, **kw):
        """Reference-parity scan-engine trace at the calibrated step."""
        from raytracing_tpu.engine.trace import trace

        ds, divisor = self._resolve(op_name, delta_s)
        return trace(op_name, self.scenario, self.medium, delta_s=ds,
                     divisor=(int(divisor) + 1) if divisor else None,
                     n_turns=n_turns, **kw)

    def run(self, op_name: str, *, delta_s: float | None = None,
            n_turns: int = config.N_TURNS, pos0=None, theta0=None, **kw):
        """Production trace through the fastest kernel tier."""
        from raytracing_tpu.engine.fast import fast_trace

        ds, divisor = self._resolve(op_name, delta_s)
        if pos0 is None:
            pos0 = np.asarray(self.scenario.pos0, np.float32)
        if theta0 is None:
            theta0 = np.asarray(self.scenario.theta0, np.float32)
        return fast_trace(op_name, self.scenario, self.medium, delta_s=ds,
                          divisor=(int(divisor) + 1) if divisor else None,
                          n_turns=n_turns, pos0=pos0, theta0=theta0, **kw)

    def _resolve(self, op_name, delta_s):
        if delta_s is not None:
            div = (round(2 * np.pi / delta_s)
                   if self.scenario.is_fisheye else None)
            return float(delta_s), div
        ds, divisor = self.delta_s(op_name)
        return float(ds), (divisor if self.scenario.is_fisheye else None)


MODEL_NAMES = config.SCENARIO_NAMES

_CACHE: dict = {}


def get(name: str, medium: str = "analytic", dtype=np.float32,
        n_turns: int = config.N_TURNS) -> Model:
    """Build (cached) a scenario + medium pairing.

    ``medium="grid"`` reproduces the reference's 2-D sampled-spline pipeline
    (bit-faithful physics; fast_trace runs it on the scan tier);
    ``"stratified"`` is the same sampled medium in its exact 1-D form for
    x-independent fields (kernel tier); ``"analytic"`` is
    exact and the fastest path.
    """
    key = (name, medium, np.dtype(dtype).name, n_turns)
    if key in _CACHE:
        return _CACHE[key]
    scen = config.scenario(name, n_turns=n_turns)
    if medium == "grid":
        from raytracing_tpu.media.spline import build_grid_medium

        med = build_grid_medium(scen.field, scen.box, dtype=dtype)
    elif medium == "stratified":
        from raytracing_tpu.media.spline import build_stratified_medium

        med = build_stratified_medium(scen.field, scen.box, dtype=dtype)
    elif medium == "c1":
        # consistent-gradient family (media/c1.py): grad n is exactly the
        # gradient of n — conservation at the analytic floor, 16-float
        # kernel cells (PARITY.md #29)
        from raytracing_tpu.media.c1 import build_c1_medium

        med = build_c1_medium(scen.field, scen.box, dtype=dtype)
    elif medium == "c1-stratified":
        from raytracing_tpu.media.c1 import build_c1_stratified

        med = build_c1_stratified(scen.field, scen.box, dtype=dtype)
    elif medium == "analytic":
        med = analytic_medium(scen.field)
    else:
        raise ValueError(f"medium must be one of {MEDIUM_KINDS}, got {medium!r}")
    model = Model(name=scen.name, scenario=scen, medium=med, medium_kind=medium)
    _CACHE[key] = model
    return model
