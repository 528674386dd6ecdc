"""Which implementation runs a batched solver phase, and the lane layout the
GPU kernels share.

The batched solve has two phases with a hand-written kernel: the Riccati
backward pass (:mod:`.riccati`) and the line-search ladder rollout
(:mod:`.rollout`). :func:`use_kernel` is the one
rule that picks between such a kernel and the plain XLA composition; every
``custom_vmap`` rule in ``solver/altro.py`` asks it.

Kernel layout: one scenario per GPU thread. Per-lane arrays are stored with
the scenario axis LAST (``[..., B]``) so a load of one matrix entry across a
block of scenarios is one coalesced ``[blk]`` vector, and the batch is
padded up to a multiple of the block by repeating the last scenario (a
padded lane is a valid copy, so no lane divides by zero or takes a square
root of a negative number).
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.pallas import triton as pltriton

# Largest (state, control) dimensions each kernel takes: the largest that
# were timed on the card and won (bench/kernel_timing.py, B=1024, H100).
# One thread runs one scenario, so the backward kernel's time grows as n^3
# while XLA's vmapped scan is launch-bound and nearly flat in n: the kernel
# wins 3.5x at (6, 3), 2.1x at (8, 4), 1.2x at (10, 5) and loses 0.71x at
# (12, 6). The ladder rollout wins at every timed shape: 4.3x at (12, 6),
# 2.6x at (12, 12), 2.5x at (16, 8), 1.7x at (16, 16). Larger dims go to
# XLA until they are timed.
MAX_DIM = {"backward": (10, 5), "rollout": (16, 16)}

# Environment switch: ALTRO_PALLAS=0 forces the XLA path everywhere (the
# A/B baseline for the kernels' timings).
_ENV = "ALTRO_PALLAS"


def use_kernel(phase: str, dtype, n: int, m: int, shared: bool,
               backend: Optional[str] = None) -> bool:
    """True when the batched solver ``phase`` ("backward" or "rollout")
    should run its Triton kernel.

    All must hold: the backend is ``"gpu"``; ``dtype`` is float32 (the
    kernels are written for f32; f64 solves are CPU truth solves); ``n`` and
    ``m`` are at most ``MAX_DIM[phase]``'s; the dynamics are ``shared``
    across the batch, so the kernel reads them as scalars; and
    ``ALTRO_PALLAS`` is not ``"0"``. ``backend`` defaults to
    ``jax.default_backend()``.
    """
    if backend is None:
        backend = jax.default_backend()
    n_max, m_max = MAX_DIM[phase]
    return (os.environ.get(_ENV, "auto") != "0"
            and backend == "gpu"
            and jnp.dtype(dtype) == jnp.float32
            and n <= n_max and m <= m_max
            and shared)


def padded_batch(batch: int, blk: int) -> int:
    """``batch`` rounded up to a multiple of the block size."""
    return -(-batch // blk) * blk


def lanes_last(x, Bp: int):
    """[B, ...] -> [..., Bp]: scenario axis last, padded to ``Bp`` lanes by
    repeating the last scenario."""
    x = jnp.moveaxis(x, 0, -1)
    pad = Bp - x.shape[-1]
    if pad:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)], mode="edge")
    return x


def lanes_first(y, B: int):
    """[..., Bp] -> [B, ...]: drop the padded lanes, scenario axis first."""
    return jnp.moveaxis(y[..., :B], -1, 0)


def compiler_params(blk: int):
    """One warp per 32 scenarios: each thread owns one scenario."""
    return pltriton.CompilerParams(num_warps=max(1, blk // 32),
                                   num_stages=1)


def fori(count: int, body):
    """``for i in range(count): body(i)`` as a loop inside a kernel (a loop,
    not unrolled Python, so the compiled body stays small)."""
    jax.lax.fori_loop(np.int32(0), np.int32(count),
                      lambda i, c: (body(i), c)[1], None)
