"""Shared entry point for MEASURED media: one family dispatch.

:func:`medium_from_samples` turns raw (samples, x, y) arrays into a medium
of the requested family plus the default trace box, for every user-facing
surface (CLI ``--medium-file``, serve ``/v1/trace_samples`` +
``/v1/calibrate_samples``).  The reference can only trace fields
hard-coded in its source (RT_bench.py:104-116); measured media are this
framework's extension, so every surface must agree on how a samples
payload becomes a medium.
"""
from __future__ import annotations

import numpy as np


def medium_from_samples(samples, x=None, y=None, *, family: str = "parity",
                        dtype=np.float32):
    """``(medium, default_box, kind)`` from raw measured-index arrays.

    ``samples`` is a (ny,) profile (with coordinate vector ``y``) or a
    (ny, nx) grid (with ``x`` and ``y``); ``family`` picks the
    reference-parity builders (media/spline.py) or the consistent-gradient
    C1 builders (media/c1.py).  ``default_box`` spans the sampled region
    (profiles are x-independent: unbounded in x); ``kind`` is
    ``"profile"`` or ``"grid"``.  ``dtype`` sets the coefficient-table
    precision (kernel tracing keeps the f32 default; eigenray work wants
    f64 tables — engine/eigenray.py dtype note — and needs jax x64 enabled
    at BUILD time or the request silently downcasts).  Axis validation
    (ascending uniform, matching lengths) lives in the builders themselves
    (spline.check_uniform_grid/_check_profile); this function only
    dispatches.  Raises ValueError on a bad family/rank or missing axis.
    """
    if family not in ("parity", "c1"):
        raise ValueError(f"family must be 'parity' or 'c1', got {family!r}")
    samples = np.asarray(samples, np.float64)
    if y is None:
        raise ValueError("samples need the 'y' coordinate vector")
    y = np.asarray(y, np.float64)
    if samples.ndim == 1:
        from raytracing_tpu.media.c1 import c1_stratified_from_samples
        from raytracing_tpu.media.spline import stratified_medium_from_samples

        medium = (c1_stratified_from_samples(samples, y, dtype=dtype)
                  if family == "c1"
                  else stratified_medium_from_samples(samples, y, dtype=dtype))
        return medium, (-1e30, 1e30, float(y[0]), float(y[-1])), "profile"
    if samples.ndim == 2:
        if x is None:
            raise ValueError("2-D samples need the 'x' coordinate vector")
        x = np.asarray(x, np.float64)
        from raytracing_tpu.media.c1 import c1_medium_from_samples
        from raytracing_tpu.media.spline import grid_medium_from_samples

        medium = (c1_medium_from_samples(samples, x, y, dtype=dtype)
                  if family == "c1"
                  else grid_medium_from_samples(samples, x, y, dtype=dtype))
        box = (float(x[0]), float(x[-1]), float(y[0]), float(y[-1]))
        return medium, box, "grid"
    raise ValueError(f"samples must be 1-D or 2-D, got {samples.ndim}-D")
