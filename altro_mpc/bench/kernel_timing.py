"""Per-kernel timing on the GPU: each kernel-backed solver phase against its
plain XLA version, at the flagship and rocket shapes.

For each case (ops/parity.py) and phase it prints one JSON line with the
XLA time, and for each block size the kernel's compile seconds and time per
call (median of ``--passes`` pipelined passes of ``--reps`` calls, one
fence per pass). The card's name and power limit go first, on stderr.

    python -m altro_mpc.bench.kernel_timing [--batch 1024] [--blocks 32,64,128]
        [--cases flagship,rocket,random_linear:16:8] [--phases ls_rollout]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp


def _time(fn, args, reps, passes):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    walls = []
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        walls.append((time.perf_counter() - t0) / reps)
    return first, float(np.median(walls))


def _phases(case):
    """(phase, XLA function, kernel function of the block size, args) for
    the two kernel-backed phases, each timed as the solver runs it."""
    from ..ops.parity import LADDER
    from ..ops.riccati import batched_backward
    from ..ops.rollout import batched_ls_rollout
    from ..solver.altro import (_expand_backward_base, backward_pass,
                                expand_lane, rollout_closed_loop)

    pm = case["prob"]
    dyn = pm.dynamics

    def expand_fn(*a):
        return expand_lane(pm.cost, pm.constraints, *a)

    def eb_xla(*a):
        return jax.vmap(lambda *b: _expand_backward_base(
            pm.cost, dyn.A, dyn.B, pm.constraints, *b))(*a)

    eb_args = (case["X"], case["U"], case["lams"], case["rhos"], case["reg"])
    with jax.default_matmul_precision("highest"):
        K, d, _, _ = jax.jit(eb_xla)(*eb_args)
        exp = jax.jit(jax.vmap(expand_fn))(*eb_args[:4])
    ro_args = (case["X"], case["U"], K, d)
    bo_args = (*exp, case["reg"])

    def eb_kernel(blk):
        def fn(X, U, lams, rhos, reg):
            exp = jax.vmap(expand_fn)(X, U, lams, rhos)
            return batched_backward(dyn.A, dyn.B, *exp, reg, block=blk)
        return fn

    def bo_xla(*a):
        return jax.vmap(lambda *b: backward_pass(dyn.A, dyn.B, *b))(*a)

    def bo_kernel(blk):
        return lambda *a: batched_backward(dyn.A, dyn.B, *a, block=blk)

    def ro_xla(*a):
        # the custom_vmap rule's XLA branch, as ALTRO_PALLAS=0 runs it
        return jax.vmap(lambda X, U, K, d: jax.vmap(
            lambda al: rollout_closed_loop(dyn, X, U, K, d, al))(
                jnp.asarray(LADDER, X.dtype)))(*a)

    def ro_kernel(blk):
        return lambda *a: batched_ls_rollout(dyn.A, dyn.B, dyn.d, *a,
                                             LADDER, block=blk)

    return (("expand_backward", eb_xla, eb_kernel, eb_args),
            ("backward_only", bo_xla, bo_kernel, bo_args),
            ("ls_rollout", ro_xla, ro_kernel, ro_args))


def main():
    from ..ops.parity import make_case
    from ..utils.runtime import card_description, enable_compile_cache

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--blocks", default="32,64,128")
    p.add_argument("--cases", default="flagship,rocket")
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--passes", type=int, default=5)
    p.add_argument("--phases",
                   default="expand_backward,backward_only,ls_rollout")
    args = p.parse_args()
    enable_compile_cache()
    print(f"# card: {card_description()}", file=sys.stderr, flush=True)
    dev = jax.devices()[0]
    blocks = [int(b) for b in args.blocks.split(",")]
    for name in args.cases.split(","):
        case = make_case(name, args.batch)
        for phase, xla, kernel, fargs in _phases(case):
            if phase not in args.phases.split(","):
                continue
            with jax.default_matmul_precision("highest"):
                first, t_xla = _time(jax.jit(xla), fargs, args.reps,
                                     args.passes)
                row = dict(case=name, phase=phase, batch=args.batch,
                           device=dev.device_kind, xla_us=t_xla * 1e6,
                           xla_first_s=first, kernel={})
                for blk in blocks:
                    first, t = _time(jax.jit(kernel(blk)), fargs, args.reps,
                                     args.passes)
                    row["kernel"][blk] = dict(us=t * 1e6, first_s=first)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
