"""One Triton launch harness for every per-ray-block kernel family.

All the kernel families share one shape: load a block of ray state, run a
``fori_loop`` over the steps with that state in registers, store the result.
:func:`ray_block_call` is the one ``pallas_call`` behind them:

* a 1-D grid of programs, each owning ``block`` consecutive rays of the
  flat ``(R,)`` state arrays — one ray per thread, its state in registers;
* scalars (step size, limits, offsets, the golden schedule) ride in one
  small float32 array every program reads whole;
* tables (sampled-medium channels) are passed whole; the kernel gathers
  from them per ray (``table_ref[idx]``), straight from global memory;
* an optional per-program liveness table arrives as a ``(1,)`` block
  indexed by program id.

Kernel signature: ``kernel(*table_refs, [flag_ref], *ray_refs, scal_ref,
*out_refs)``.  Callers pad their batches to ``block_rays``; the program
width divides any such batch (:func:`program_rays`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from raytracing_tpu.kernels.route import resolve_interpret

#: rays per program (a power of two).  Each thread carries one ray's state
#: (10-25 floats) in registers, so the program is one ray per thread:
#: RAYS_PER_PROGRAM = 32 * NUM_WARPS.  Chosen by a sweep on the H100
#: (PERF.md, "Triton launch shape").
RAYS_PER_PROGRAM = 128
NUM_WARPS = 4
#: the step loop carries no loads to pipeline
NUM_STAGES = 1


def program_rays(rays: int) -> int:
    """Rays per program for an ``rays``-ray batch: the largest power of two
    that divides ``rays``, capped at ``RAYS_PER_PROGRAM``."""
    return max(1, min(RAYS_PER_PROGRAM, rays & -rays))


def program_flags(active):
    """Per-program liveness: 1.0 where any of the program's rays is active
    (programs of :func:`program_rays` rays each)."""
    block = program_rays(active.shape[0])
    return jnp.max(active.reshape(-1, block), axis=1)


def ray_block_call(kernel, rays, scalars, n_out: int, *, tables=(),
                   flags=None, interpret: bool | None = None,
                   name: str | None = None):
    """Run ``kernel`` over ``rays`` (a sequence of ``(R,)`` float32 arrays).

    Returns ``n_out`` ``(R,)`` float32 arrays.  ``flags`` is the
    per-program table from :func:`program_flags`.
    """
    r = rays[0].shape[0]
    block = program_rays(r)
    interpret = resolve_interpret(interpret)
    blk = pl.BlockSpec((block,), lambda i: (i,))

    def whole(a):
        return pl.BlockSpec(a.shape, lambda i, nd=a.ndim: (0,) * nd)

    scalars = jnp.asarray(scalars, jnp.float32)
    in_specs = [whole(t) for t in tables]
    args = list(tables)
    if flags is not None:
        in_specs.append(pl.BlockSpec((1,), lambda i: (i,)))
        args.append(flags)
    in_specs += [blk] * len(rays) + [whole(scalars)]
    args += list(rays) + [scalars]
    return pl.pallas_call(
        kernel,
        grid=(r // block,),
        in_specs=in_specs,
        out_specs=[blk] * n_out,
        out_shape=[jax.ShapeDtypeStruct((r,), jnp.float32)] * n_out,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name=name,
    )(*args)
