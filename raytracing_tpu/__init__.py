"""raytracing_tpu — batched geometrical ray tracing on the GPU.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
neyuru/RayTracing (reference: /root/reference/RT_bench.py): Fermat
equations-of-motion integration through heterogeneous and anisotropic 2-D
media with 11 step-method pairings (MxSA/AnDF/HySA and the anisotropic
momentum algorithm), four physics-oracle scenarios, DELTA_S convergence
search, benchmarking, and wavefront visualization — re-architected as a
vmapped ``lax.scan`` integrator and fused Triton kernels over million-ray
batches sharded across a device mesh.
"""

__version__ = "0.4.0"

from raytracing_tpu.config import (  # noqa: F401
    DELTA_S,
    SIGMA,
    ScenarioConfig,
    scenario,
)
from raytracing_tpu.engine.diff import (  # noqa: F401
    DiffTrace,
    ParametricMedium,
    parametric_grid_medium,
    parametric_profile_medium,
    trace_diff,
)
from raytracing_tpu.engine.df_grid import (  # noqa: F401
    df_c1_medium_from_samples,
    df_c1_profile_from_samples,
    df_eval_profile_medium,
    df_grid_medium_from_samples,
    df_grid_trace,
)
from raytracing_tpu.engine.df_grid3 import (  # noqa: F401
    df_c1_medium3_from_samples,
    df_eval_medium3_from_samples,
)
from raytracing_tpu.engine.dynamic import (  # noqa: F401
    DynamicResult,
    spreading_amplitude,
    trace_dynamic,
    transmission_loss_db,
)
from raytracing_tpu.engine.eigenray import (  # noqa: F401
    Eigenrays,
    coherent_tl,
    find_eigenrays,
    incoherent_tl,
)
from raytracing_tpu.engine.eigenray3d import (  # noqa: F401
    Eigenrays3,
    find_eigenrays3,
)
from raytracing_tpu.engine.trace import TraceResult, trace  # noqa: F401
from raytracing_tpu.engine.dynamic3d import (  # noqa: F401
    Dynamic3Result,
    trace_dynamic3,
)
from raytracing_tpu.engine.trace3d import (  # noqa: F401
    Trace3Result,
    bouguer_invariant,
    trace3d,
)
from raytracing_tpu.media.fields3d import (  # noqa: F401
    Analytic3D,
    Custom3D,
    Stratified3D,
    analytic_medium3,
)
from raytracing_tpu.media.c1 import (  # noqa: F401
    c1_medium_from_samples,
    c1_stratified_from_samples,
)
from raytracing_tpu.media.grid3 import (  # noqa: F401
    C1Grid3Medium,
    c1_medium3_from_samples,
)
from raytracing_tpu.media.medium import AnalyticMedium, analytic_medium  # noqa: F401
from raytracing_tpu.media.spline import (  # noqa: F401
    grid_medium_from_samples,
    stratified_medium_from_samples,
)
from raytracing_tpu.ops.registry import (  # noqa: F401
    ALIASES,
    ANISO_OPS,
    EXTENSION_OPS,
    OP_NAMES,
)

__all__ = [
    "DELTA_S", "SIGMA", "ScenarioConfig", "scenario", "TraceResult", "trace",
    "AnalyticMedium", "analytic_medium", "grid_medium_from_samples",
    "c1_medium_from_samples", "stratified_medium_from_samples",
    "c1_stratified_from_samples", "df_grid_medium_from_samples",
    "df_c1_medium_from_samples", "df_c1_profile_from_samples",
    "df_eval_profile_medium",
    "df_c1_medium3_from_samples", "df_eval_medium3_from_samples",
    "df_grid_trace",
    "DiffTrace", "ParametricMedium", "parametric_grid_medium",
    "parametric_profile_medium", "trace_diff",
    "DynamicResult", "trace_dynamic", "spreading_amplitude",
    "transmission_loss_db",
    "Eigenrays", "find_eigenrays", "coherent_tl", "incoherent_tl",
    "Trace3Result", "trace3d", "bouguer_invariant",
    "C1Grid3Medium", "c1_medium3_from_samples",
    "Dynamic3Result", "trace_dynamic3", "Eigenrays3", "find_eigenrays3",
    "Analytic3D", "Custom3D", "Stratified3D", "analytic_medium3",
    "ALIASES", "ANISO_OPS", "EXTENSION_OPS", "OP_NAMES",
]
