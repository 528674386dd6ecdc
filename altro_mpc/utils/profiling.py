"""Profiling / observability utilities.

The reference's tracing story is wall-clock medians (BenchmarkTools) plus
solver stats (SURVEY.md section 5). The equivalents here:

- :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable trace of the device timeline
- :func:`timed` — block_until_ready-fenced wall timing
- solver stats already surface per solve (iterations / viol / status)
"""
from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir: str = "/tmp/altro_mpc_trace"):
    """Capture a device trace: ``with trace(): run()`` then inspect with
    TensorBoard or xprof."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str = "", results: dict = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt
    else:
        print(f"[{label}] {dt * 1e3:.3f} ms")


def fenced(fn, *args, **kwargs):
    """Run fn and block until its outputs are ready; returns (out, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0
