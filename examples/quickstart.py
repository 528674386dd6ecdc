"""Quickstart: the five benchmark problems end-to-end on whatever backend
JAX finds (CPU or GPU). Run: python examples/quickstart.py [--fast]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax
import jax.numpy as jnp

import altro_mpc as at
from altro_mpc.mpc import gen_tracking_mpc, make_mpc_step
from altro_mpc.models import flexible_satellite as fs
from altro_mpc.models import grasp, rocket
from altro_mpc.models import random_linear as rl


def banner(s):
    print(f"\n=== {s}", flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--fast", action="store_true")
    args = p.parse_args()
    T = 5 if args.fast else 20

    banner("1. random-linear MPC (benchmark 1)")
    rng = np.random.default_rng(1)
    prob = rl.gen_random_linear(rng, 12, 6, T + 32)
    X_track, U_track = rl.gen_trajectory(rng, prob, T + 32)
    prob_mpc = rl.gen_tracking_mpc(prob, X_track, U_track, 30)
    opts = at.SolverOptions(penalty_initial=1e3, penalty_scaling=100.0,
                            reset_duals=False)
    step, init_carry = make_mpc_step(prob_mpc, opts, X_track, U_track)
    jstep = jax.jit(step)
    carry = jax.jit(init_carry)()
    t0 = time.perf_counter()
    for t in range(T):
        nz = jnp.asarray(rng.standard_normal(12), prob.x0.dtype)
        carry, out = jstep(carry, nz)
    jax.block_until_ready(out.status)
    print(f"{T} warm-started MPC steps, "
          f"{(time.perf_counter()-t0)/T*1e3:.2f} ms/step, "
          f"viol={float(out.viol):.1e}")

    banner("2. rocket soft landing with SOC cones (benchmark 2)")
    N = 301
    rp = rocket.rocket_problem(N=N, tf=(N - 1) * 0.05)
    sol = jax.jit(at.solve)(rp, at.SolverOptions(
        constraint_tolerance=1e-5, penalty_initial=1e-2, penalty_scaling=500.0,
        iterations_outer=40, iterations_inner=100),
        U0=rocket.hover_controls(rp))
    ang = jnp.rad2deg(jnp.arctan2(jnp.linalg.norm(sol.U[:, :2], axis=-1),
                                  sol.U[:, 2]))
    print(f"landed at {np.asarray(sol.X[-1][:3]).round(6)}, max thrust angle "
          f"{float(jnp.max(ang)):.2f} deg (limit 5), "
          f"{int(sol.stats.iterations)} iterations")

    banner("3. grasp with rotating friction cones (benchmark 3)")
    o = grasp.make_grasp_object(61, 6.0)
    gp = grasp.grasp_problem(o, 61, 6.0)
    gsol = jax.jit(at.solve)(gp, at.SolverOptions(
        constraint_tolerance=1e-6, penalty_initial=10.0, penalty_scaling=10.0,
        iterations_outer=30), U0=grasp.hover_controls(o, 61))
    print(f"object delivered to {np.asarray(gsol.X[-1][:3]).round(5)}, "
          f"viol={float(gsol.stats.viol):.1e}")

    banner("4. flexible satellite regulator (benchmark 4)")
    fp = fs.flexsat_problem()
    fsol = jax.jit(at.solve)(fp, at.SolverOptions(
        penalty_initial=100.0, penalty_scaling=100.0))
    print(f"N=80 solve: {int(fsol.stats.iterations)} iterations, "
          f"max|u|={float(jnp.max(jnp.abs(fsol.U))):.4f} (bound 0.01)")

    banner("5. quadruped trot (benchmark 5)")
    from altro_mpc.models.quadruped import config, controller
    cfg = config.MPCConfig()
    res = jax.jit(lambda: controller.simulate(
        cfg, at.SolverOptions(penalty_initial=10.0, penalty_scaling=100.0,
                              reset_duals=False),
        tf=0.5 if args.fast else 1.0, backend="altro"))()
    xs = np.asarray(res["x"])
    print(f"closed-loop trot: height {xs[-1, 2]:.3f} m "
          f"(target {cfg.stance_height}), "
          f"all solves ok: {bool(np.all(np.asarray(res['status']) == 1))}")


if __name__ == "__main__":
    main()
