"""The one backend -> kernel-route decision.

Every kernel entry point asks :func:`kernel_route` how to run its Pallas
kernels: compiled through Triton on the GPU, through the Pallas interpreter
on the CPU (the tests).  Any other platform is an error: no path quietly
interprets a kernel on an accelerator, and none moves a trace to the CPU
because a compiled kernel failed.
"""
from __future__ import annotations

import jax

#: platform -> kernel route
ROUTES = {"cpu": "interpret", "gpu": "triton"}


def kernel_route(platform: str | None = None) -> str:
    """``"interpret"`` on the CPU, ``"triton"`` on the GPU; raise otherwise.

    ``platform`` defaults to ``jax.default_backend()``.
    """
    platform = jax.default_backend() if platform is None else platform
    try:
        return ROUTES[platform]
    except KeyError:
        raise RuntimeError(
            f"no kernel route for platform {platform!r}: the kernels run "
            f"on {sorted(ROUTES)}") from None


def resolve_interpret(interpret: bool | None) -> bool:
    """An explicit ``interpret`` wins; ``None`` follows :func:`kernel_route`."""
    if interpret is None:
        return kernel_route() == "interpret"
    return bool(interpret)
