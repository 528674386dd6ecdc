"""Multi-device scaling study: MPC throughput vs scenario-mesh size.

The single-threaded reference has no scaling story (SURVEY.md section 2.8);
this driver measures the framework's scenario-sharded throughput and
efficiency across mesh sizes (the BASELINE.json north-star's >= 80%
multi-host target). On four H100s the collectives ride NVLink; under
``XLA_FLAGS=--xla_force_host_platform_device_count=N JAX_PLATFORMS=cpu`` it
validates the same sharded program on a virtual mesh (communication-free
correctness + plumbing, not bandwidth).

Run: ``python -m altro_mpc.bench.scaling [--batch-per-device 64]``
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

import jax
import jax.numpy as jnp


def measure(batch_per_device: int = 64, steps: int = 10, n: int = 12,
            m: int = 6, N_mpc: int = 30, dtype=jnp.float32):
    import altro_mpc as at
    from altro_mpc.models import random_linear as rl
    from altro_mpc.parallel import make_scenario_mesh, sharded_mpc_step

    rng = np.random.default_rng(1)
    N_track = N_mpc + steps + 2
    prob = rl.gen_random_linear(rng, n, m, N_track, dtype=dtype)
    X_track, U_track = rl.gen_trajectory(rng, prob, N_track)
    prob_mpc = rl.gen_tracking_mpc(prob, X_track, U_track, N_mpc)
    opts = at.SolverOptions(cost_tolerance=1e-4, gradient_tolerance=1e-4,
                            constraint_tolerance=1e-4, penalty_initial=1e3,
                            penalty_scaling=100.0, reset_duals=False)

    n_devices = len(jax.devices())
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_devices]
    rows = []
    for nd in sizes:
        mesh = make_scenario_mesh(nd)
        B = batch_per_device * nd
        step = sharded_mpc_step(prob_mpc, opts, X_track, U_track, mesh)

        x0s = jnp.tile(prob_mpc.x0, (B, 1))
        sol0 = jax.vmap(lambda x0: at.solve(prob_mpc.replace(x0=x0), opts))(x0s)
        state = (x0s, sol0.X, sol0.U, sol0.duals, jnp.asarray(0))
        jstep = jax.jit(step)
        noise = jnp.asarray(rng.standard_normal((steps, B, n)), dtype)

        state, _ = jstep(state, noise[0])
        jax.block_until_ready(state)

        t0 = time.perf_counter()
        for t in range(steps):
            state, metrics = jstep(state, noise[t])
        jax.block_until_ready(state)
        dt = time.perf_counter() - t0
        sps = B * steps / dt
        rows.append(dict(devices=nd, batch=B, solves_per_s=round(sps, 1),
                         n_success=int(metrics[2])))
        print(f"devices={nd} B={B}: {sps:.0f} solves/s "
              f"({int(metrics[2])}/{B} success)", flush=True)

    base = rows[0]["solves_per_s"]
    for r in rows:
        r["efficiency"] = round(r["solves_per_s"] / (base * r["devices"]), 3)
    return rows


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch-per-device", type=int, default=64)
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args()
    rows = measure(args.batch_per_device, args.steps)
    print(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
