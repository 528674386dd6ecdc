"""GPU-f32 vs CPU-f64 vs native-C++ agreement artifact for the flagship.

Closes the "matching reference ALTRO controls" claim on hardware
(BASELINE.json north star; reference oracle pattern
random_linear_problem.jl:176-186): run the B=1024 f32 warm-started MPC
batch on the GPU (bench.py methodology/config), then re-solve a sample of the
IDENTICAL instances (same x0, same tracking window, same convex QP — unique
optimum) with

  - the CPU float64 ALTRO solver at tolerance 1e-6, and
  - the native C++ dense ADMM oracle (altro_mpc/native) at 1e-8,

and report max control disagreement. Expected: f32-vs-f64 at the f32
solve tolerance level (~1e-3/1e-4), f64-vs-native at oracle level.

Two phases, so that only one process opens the card: phase1 runs on the
GPU and saves the sampled instances; phase2 re-execs itself with
JAX_PLATFORMS=cpu. ``main`` runs both and writes
results_gpu/agreement.json.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

SEED = 1
N_MPC = 30
N_DIM, M_DIM = 12, 6
SAMPLE = 32


def _flagship(dtype):
    import jax.numpy as jnp
    from altro_mpc.models import random_linear as rl

    rng = np.random.default_rng(SEED)
    T = 10
    N_track = N_MPC + T + 2
    prob = rl.gen_random_linear(rng, N_DIM, M_DIM, N_track, dtype=dtype)
    X_track, U_track = rl.gen_trajectory(rng, prob, N_track)
    prob_mpc = rl.gen_tracking_mpc(prob, X_track, U_track, N_MPC)
    return prob_mpc, X_track, U_track, T


TOLS = (1e-4, 1e-6)
# the flagship bench default (bench.py): skip the redundant dJ-confirmation
# iteration after an exact full Newton step. The agreement artifact measures
# the SAME config the throughput number ships with.
EARLY_TOL = float(os.environ.get("AGREEMENT_EARLY_TOL", "1e-3"))


def phase1_gpu(out_npz: str, B: int = 1024):
    import jax
    import jax.numpy as jnp
    import altro_mpc as at
    from altro_mpc.mpc import make_mpc_step

    dtype = jnp.float32
    prob_mpc, X_track, U_track, T = _flagship(dtype)
    rng = np.random.default_rng(SEED)
    noise = jnp.asarray(rng.standard_normal((T, B, N_DIM)), dtype)
    idx = np.linspace(0, B - 1, SAMPLE).astype(int)

    save = dict(k=int(T))
    for tol in TOLS:
        opts = at.SolverOptions(
            cost_tolerance=tol, gradient_tolerance=tol,
            constraint_tolerance=max(tol, 1e-5), penalty_initial=1e3,
            penalty_scaling=100.0, reset_duals=False,
            # L=2 ladder matches the bench.py flagship default (the LTI QP
            # model is exact along the Newton step; step_overhead.json)
            iterations_linesearch=int(os.environ.get("AGREEMENT_LS", "2")),
            early_exact_tol=EARLY_TOL)
        step, init_carry = make_mpc_step(prob_mpc, opts, X_track, U_track)
        vstep = jax.jit(jax.vmap(step, in_axes=(0, 0)))
        carry = jax.block_until_ready(
            jax.jit(jax.vmap(lambda _: init_carry()))(jnp.arange(B)))
        for t in range(T):
            carry, out = vstep(carry, noise[t])
        jax.block_until_ready(carry)
        key = f"{tol:g}"
        save[f"x0_{key}"] = np.asarray(out.x0)[idx]
        save[f"U_{key}"] = np.asarray(out.U)[idx]
        save[f"status_{key}"] = np.asarray(out.status)
        print(f"phase1 tol={tol:g}: success "
              f"{float(np.mean(np.asarray(out.status))):.4f}", flush=True)
        # full-batch gate: save ALL lanes of this config's
        # final window; phase2 scores every lane against a cold f64 truth
        # solve. Scoring must be f64: on the marginally-stable flagship
        # dynamics an f32 rollout's cost evaluation carries ~1% noise at
        # the J~0.03 window-cost scale (two different near-optimal U
        # sequences accumulate different rollout error), which a GPU-side
        # f32 truth-lite cannot distinguish from real suboptimality — an
        # f64 re-check showed a bench solution that f32 scoring flagged
        # 2% "suboptimal" is optimal to 5e-9.
        save[f"x0full_{key}"] = np.asarray(out.x0)
        save[f"Ufull_{key}"] = np.asarray(out.U)
    np.savez(out_npz, **save)


def phase2_cpu(in_npz: str, out_json: str):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import altro_mpc as at
    from altro_mpc.costs import retarget_tracking
    from altro_mpc.mpc import track_window
    from altro_mpc.native import available, solve_qp
    from altro_mpc.solver import admm_qp
    from altro_mpc.transcribe import to_batch_qp

    data = np.load(in_npz)
    k = int(data["k"])
    prob_mpc, X_track, U_track, _T = _flagship(jnp.float64)
    Xw, Uw = track_window(X_track, U_track, k, N_MPC)
    cost_k = retarget_tracking(prob_mpc.cost, Xw, Uw)

    opts64 = at.SolverOptions(
        cost_tolerance=1e-8, gradient_tolerance=1e-9,
        constraint_tolerance=1e-7, penalty_initial=1e3,
        penalty_scaling=100.0)

    def solve64(x0, U0):
        p = prob_mpc.replace(cost=cost_k, x0=x0)
        return at.solve(p, opts64, U0=U0).U

    jsolve64 = jax.jit(solve64)

    per_tol = {}
    d_f64_nat, statuses = [], []
    for tol in TOLS:
        key = f"{tol:g}"
        x0s, U_gpu = data[f"x0_{key}"], data[f"U_{key}"]
        d_gpu_f64 = []
        for i in range(x0s.shape[0]):
            x0 = jnp.asarray(x0s[i], jnp.float64)
            U0 = jnp.asarray(U_gpu[i], jnp.float64)
            U64 = np.asarray(jsolve64(x0, U0))
            d_gpu_f64.append(np.max(np.abs(U_gpu[i] - U64)))
            if tol == TOLS[0] and available():
                p = prob_mpc.replace(cost=cost_k, x0=x0)
                qp = to_batch_qp(p)
                nat = solve_qp(np.asarray(qp.P), np.asarray(qp.q),
                               np.asarray(qp.A), np.asarray(qp.l),
                               np.asarray(qp.u), eps_abs=1e-8,
                               max_iter=40000)
                statuses.append(nat.status)
                _, U_nat = admm_qp.extract_traj(qp, jnp.asarray(nat.x))
                d_f64_nat.append(np.max(np.abs(U64 - np.asarray(U_nat))))
        per_tol[key] = dict(
            gpu_success_rate=float(np.mean(data[f"status_{key}"])),
            max_dU_gpu_f32_vs_cpu_f64=float(np.max(d_gpu_f64)),
            mean_dU_gpu_f32_vs_cpu_f64=float(np.mean(d_gpu_f64)))

    # full-batch f64 scoring: every lane's final-window solution
    # against a cold f64 truth solve of the identical instance
    fullbatch = {}
    if f"x0full_{TOLS[0]:g}" in data:
        import jax.numpy as _jnp

        Uw64 = _jnp.asarray(Uw, _jnp.float64)

        def cold_truth(x0):
            p = prob_mpc.replace(cost=cost_k, x0=x0)
            return at.solve(p, opts64, U0=Uw64).U

        def cost_of(x0, U):
            X = prob_mpc.dynamics.rollout(x0, U)
            return cost_k.total(X, U)

        jtruth_b = jax.jit(jax.vmap(cold_truth))
        jcost_b = jax.jit(jax.vmap(cost_of))
        for tol in TOLS:
            key = f"{tol:g}"
            x0b = _jnp.asarray(data[f"x0full_{key}"], _jnp.float64)
            Ub = _jnp.asarray(data[f"Ufull_{key}"], _jnp.float64)
            Ut = jtruth_b(x0b)
            Jb, Jt = np.asarray(jcost_b(x0b, Ub)), np.asarray(
                jcost_b(x0b, Ut))
            g = (Jb - Jt) / np.maximum(np.abs(Jt), 1e-12)
            fullbatch[f"tol_{key}"] = dict(
                lanes=int(g.size), gap_max=float(g.max()),
                gap_p99=float(np.percentile(g, 99)),
                gap_mean=float(g.mean()))
            print(f"fullbatch tol={key}: gap max {g.max():.2e} p99 "
                  f"{np.percentile(g, 99):.2e}", flush=True)

    res = dict(
        config=dict(n=N_DIM, m=M_DIM, N_mpc=N_MPC, seed=SEED,
                    sample=int(data[f"x0_{TOLS[0]:g}"].shape[0]), step=k,
                    f64_tol=1e-8, native_tol=1e-8,
                    early_exact_tol=EARLY_TOL),
        per_gpu_tolerance=per_tol,
        max_dU_cpu_f64_vs_native_cpp=(
            float(np.max(d_f64_nat)) if d_f64_nat else None),
        native_success=(int(min(statuses)) if statuses else None),
        fullbatch=fullbatch or None,
        note=("identical instances (x0 recorded on the GPU, window/problem "
              "rebuilt deterministically); the construction-path matmuls "
              "(costs/dynamics) are pinned to full precision, so the device "
              "tracks the same reference as the host"),
    )
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1), flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("phase", nargs="?", default="all",
                   choices=["all", "phase1", "phase2"])
    p.add_argument("--npz", default="results_gpu/agreement.npz")
    p.add_argument("--out", default="results_gpu/agreement.json")
    p.add_argument("--batch", type=int, default=1024)
    args = p.parse_args()
    if args.phase in ("all", "phase1"):
        phase1_gpu(args.npz, args.batch)
    if args.phase == "phase2":
        phase2_cpu(args.npz, args.out)
    elif args.phase == "all":
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        subprocess.run(
            [sys.executable, "-m", "altro_mpc.bench.agreement", "phase2",
             "--npz", args.npz, "--out", args.out],
            check=True, env=env, cwd=os.path.dirname(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


if __name__ == "__main__":
    main()
