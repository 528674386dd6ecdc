"""End-to-end A/B runs on the GPU: the shipped kernel choice against its
alternatives, in one process, in the order given.

    python -m altro_mpc.bench.ab flagship shipped,xla,xla,shipped
    python -m altro_mpc.bench.ab rocket shipped,xla,rollout_only,shipped
    python -m altro_mpc.bench.ab tf32
    python -m altro_mpc.bench.ab tf32_step

``flagship`` runs ``bench.py``'s benchmark once per variant (``BENCH_*``
environment variables apply as usual); ``rocket`` runs the device-compacted
rocket step at B=1024 for 10 steps (``chip_smoke.py``'s configuration) and
prints one ``ROW`` JSON line per variant. Variants:

- ``shipped``: the kernel choice rule as it ships (``ops/dispatch.py``);
- ``xla``: ``ALTRO_PALLAS=0``, no kernel;
- ``backward_on``: the backward kernel also at the flagship's (12, 6);
- ``rollout_only``: the ladder kernel only, the backward pass on XLA.

``tf32`` is the control run for ``chip_smoke.py``'s accuracy limits: its
phases (b) and (c) with the solver's matmuls at TF32 instead of
``highest``. It prints their lines and their failures and exits 0.
``tf32_step`` runs phase (c) alone with only the batched rocket step at
TF32; the cold reference solve that makes its tracking targets stays at
``highest``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

VARIANTS = {
    "shipped": ({}, {}),
    "xla": ({"ALTRO_PALLAS": "0"}, {}),
    "backward_on": ({}, {"backward": (12, 6)}),
    "rollout_only": ({}, {"backward": (0, 0)}),
}


@contextlib.contextmanager
def variant(name):
    """Apply variant ``name``'s environment and kernel limits, and restore
    both afterwards."""
    from ..ops import dispatch

    env, limits = VARIANTS[name]
    saved_env = {k: os.environ.get(k) for k in env}
    saved_limits = dict(dispatch.MAX_DIM)
    os.environ.update(env)
    dispatch.MAX_DIM.update(limits)
    try:
        yield
    finally:
        dispatch.MAX_DIM.clear()
        dispatch.MAX_DIM.update(saved_limits)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_flagship(names):
    import bench

    for name in names:
        print(f"== flagship {name}", flush=True)
        with variant(name):
            bench.main()
        sys.stdout.flush()


def run_rocket(names, B=1024, T=10):
    import jax.numpy as jnp
    import numpy as np

    from ..mpc import make_mpc_step_device_compacted
    from .batched_conic import _throughput, rocket_setup

    su = rocket_setup(jnp.float32)
    noise = jnp.asarray(np.random.default_rng(1).standard_normal(
        (T, B, 6)), jnp.float32)
    for name in names:
        with variant(name):
            bstep, init_carry = make_mpc_step_device_compacted(
                su["prob_mpc"], su["opts"], su["X_track"], su["U_track"],
                noise_model=su["noise_model"], it_cap=16, block=256,
                levels=((16, 128),), warm_start=su["warm_start"])
            res = _throughput(None, init_carry, noise, name,
                              batch_step=bstep)
        print("ROW", json.dumps(res), flush=True)


def run_tf32(step_only=False):
    import jax

    import chip_smoke

    from . import batched_conic

    pin = jax.default_matmul_precision
    setup = batched_conic.rocket_setup
    # every precision pin in the solver goes through this context manager
    tf32 = lambda _precision: pin("tensorfloat32")

    def sound_setup(*args, **kwargs):
        jax.default_matmul_precision = pin
        try:
            return setup(*args, **kwargs)
        finally:
            jax.default_matmul_precision = tf32

    phases = (chip_smoke.phase_flagship, chip_smoke.phase_rocket)
    if step_only:
        phases = (chip_smoke.phase_rocket,)
        batched_conic.rocket_setup = sound_setup
    jax.default_matmul_precision = tf32
    try:
        for phase in phases:
            try:
                phase()
            except AssertionError as e:
                print(f"  {phase.__name__} failed under TF32: "
                      f"{str(e)[:2000]}", flush=True)
    finally:
        jax.default_matmul_precision = pin
        batched_conic.rocket_setup = setup


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("cell", choices=("flagship", "rocket", "tf32", "tf32_step"))
    p.add_argument("variants", nargs="?", default="shipped,xla,xla,shipped")
    args = p.parse_args()
    from ..utils.runtime import card_description, enable_compile_cache

    enable_compile_cache()
    print(f"# card: {card_description()}", file=sys.stderr, flush=True)
    names = args.variants.split(",")
    for name in names:
        if name not in VARIANTS:
            p.error(f"unknown variant {name!r}; one of {sorted(VARIANTS)}")
    if args.cell == "flagship":
        run_flagship(names)
    elif args.cell == "rocket":
        run_rocket(names)
    else:
        run_tf32(step_only=args.cell == "tf32_step")


if __name__ == "__main__":
    main()
