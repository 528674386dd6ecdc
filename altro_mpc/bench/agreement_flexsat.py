"""GPU-f32 vs CPU-f64 agreement artifact for the flexsat regulator row.

Completes the per-family quality-gate set (flagship: agreement.json,
conic: agreement_conic.json, quadruped: agreement_quadruped.json): the
batched flexsat regulator loop (bench/batched_families.flexsat_batched
config: early-exact + L=5 + exact re-based X0 + penalty 1e3) runs T warm
steps at B on the GPU; sampled (x0, U) pairs from
early/mid/late steps are re-solved with the f64 CPU solver at 1e-7
(truth). The regulator never advances a window, so an instance is fully
determined by x0 — no window rebuild in phase2.

Run on the GPU: ``python -m altro_mpc.bench.agreement_flexsat``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

SAMPLE = 16
T_STEPS = 20
CHECK_STEPS = (5, 12, 20)
B_DEFAULT = 1024


def _setup(dtype):
    import jax
    import jax.numpy as jnp

    import altro_mpc as at
    from altro_mpc.models import flexible_satellite as fs

    prob = fs.flexsat_problem(dtype=dtype)
    # mirrors bench/batched_families.flexsat_batched's shipped config, so
    # the gated path is the timed path (the f64 truth solves to 1e-7
    # regardless)
    opts = at.SolverOptions(
        cost_tolerance=1e-4, constraint_tolerance=1e-4,
        penalty_initial=1e3, penalty_scaling=100.0,
        early_exact_tol=1e-3, iterations_linesearch=5)
    return prob, opts


def phase1_gpu(out_npz: str, B: int = B_DEFAULT):
    import jax
    import jax.numpy as jnp

    import altro_mpc as at

    dtype = jnp.float32
    prob, opts = _setup(dtype)
    sol0 = jax.jit(at.solve)(prob, opts)
    jax.block_until_ready(sol0.X)

    import numpy as _np
    A0 = _np.asarray(prob.dynamics.A[0], _np.float64)
    Ph = _np.empty((prob.N,) + A0.shape)
    Ph[0] = _np.eye(A0.shape[0])
    for k in range(1, prob.N):
        Ph[k] = A0 @ Ph[k - 1]
    Phis = jnp.asarray(Ph, dtype)

    def astep(carry, noise_i):
        x0, X, U, duals = carry
        x0n = prob.dynamics.step(x0, U[0], 0) + 2e-4 * noise_i
        with jax.default_matmul_precision("highest"):
            X0 = X + jnp.einsum("kij,j->ki", Phis, x0n - X[0])
        sol = at.solve(prob.replace(x0=x0n), opts, U0=U, duals=duals,
                       X0=X0)
        return ((x0n, sol.X, sol.U, sol.duals),
                (sol.stats.status, sol.stats.viol))

    vstep = jax.jit(jax.vmap(astep))
    rng = np.random.default_rng(0)
    noise = jnp.asarray(rng.standard_normal((T_STEPS, B, prob.n)), dtype)
    carry = jax.block_until_ready(jax.jit(jax.vmap(
        lambda _: (prob.x0, sol0.X, sol0.U, sol0.duals)))(jnp.arange(B)))
    idx = np.linspace(0, B - 1, SAMPLE).astype(int)
    save = {}
    sts, vls = [], []
    for t in range(T_STEPS):
        carry, out = vstep(carry, noise[t])
        if (t + 1) in CHECK_STEPS:
            save[f"k{t + 1}_x0"] = np.asarray(carry[0])[idx]
            save[f"k{t + 1}_U"] = np.asarray(carry[2])[idx]
            # full-batch gate: ALL lanes saved; phase2 scores
            # them against cold f64 truth solves. Scoring stays in f64 —
            # f32 cost evaluation on a marginally-stable rollout carries
            # percent-level noise (see bench/agreement.py's fullbatch
            # note), which would swamp these ~1e-3-scale gaps.
            save[f"k{t + 1}_x0full"] = np.asarray(carry[0])
            save[f"k{t + 1}_Ufull"] = np.asarray(carry[2])
        sts.append(np.asarray(out[0]))
        vls.append(np.asarray(out[1]))
    save["status"] = np.concatenate(sts)
    save["viol"] = np.concatenate(vls)
    print(f"phase1: success {float(save['status'].mean()):.4f} "
          f"max_viol {float(save['viol'].max()):.2e}", flush=True)
    np.savez(out_npz, **save)


def phase2_cpu(in_npz: str, out_json: str):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import altro_mpc as at

    data = np.load(in_npz)
    prob, opts = _setup(jnp.float64)
    opts_truth = opts.replace(
        cost_tolerance=1e-7, gradient_tolerance=1e-9,
        constraint_tolerance=1e-7, early_exact_tol=0.0,
        iterations_linesearch=10, iterations_outer=40,
        iterations_inner=100)

    def solve_truth(x0, U0):
        sol = at.solve(prob.replace(x0=x0), opts_truth, U0=U0)
        return sol.U, sol.stats.status

    def traj_cost(x0, U):
        X = prob.dynamics.rollout(x0, U)
        return prob.cost.total(X, U)

    jtruth = jax.jit(solve_truth)
    jcost = jax.jit(traj_cost)
    errs, gaps, stts = [], [], []
    for k in CHECK_STEPS:
        x0s, U_gpu = data[f"k{k}_x0"], data[f"k{k}_U"]
        for i in range(SAMPLE):
            x0 = jnp.asarray(x0s[i], jnp.float64)
            U_t = jnp.asarray(U_gpu[i], jnp.float64)
            U_truth, st = jtruth(x0, U_t)
            stts.append(int(st))
            errs.append(float(np.max(np.abs(U_gpu[i]
                                            - np.asarray(U_truth)))))
            J_gpu = float(jcost(x0, U_t))
            J_tr = float(jcost(x0, U_truth))
            gaps.append((J_gpu - J_tr) / max(abs(J_tr), 1e-12))
    res = dict(
        config=dict(sample=SAMPLE, steps=T_STEPS,
                    window_ks=list(CHECK_STEPS), truth_tol=1e-7),
        gpu_success_rate=float(data["status"].mean()),
        gpu_max_viol=float(data["viol"].max()),
        err_U_max=float(np.max(errs)), err_U_mean=float(np.mean(errs)),
        cost_rel_gap_max=float(np.max(gaps)),
        cost_rel_gap_mean=float(np.mean(gaps)),
        truth_success=int(min(stts)))
    if f"k{CHECK_STEPS[0]}_x0full" in data:
        # full-batch f64 scoring: every lane vs a cold tight f64 re-solve
        # (ct 1e-6; the 16-lane 1e-7 sample above stays the absolute
        # anchor — it cross-checks this scorer's own tolerance)
        opts_tight = opts.replace(
            cost_tolerance=1e-6, gradient_tolerance=1e-8,
            iterations_outer=30, iterations_inner=50, reg_min=1e-8,
            early_exact_tol=0.0)

        def tight_one(x0):
            sol = at.solve(prob.replace(x0=x0), opts_tight)
            return sol.U, sol.stats.status

        jtight = jax.jit(jax.vmap(tight_one))
        jcost_b = jax.jit(jax.vmap(traj_cost))
        gs, stt_all = [], []
        for k in CHECK_STEPS:
            x0b = jnp.asarray(data[f"k{k}_x0full"], jnp.float64)
            Ub = jnp.asarray(data[f"k{k}_Ufull"], jnp.float64)
            Ut, stt = jtight(x0b)
            Jb = np.asarray(jcost_b(x0b, Ub))
            Jt = np.asarray(jcost_b(x0b, Ut))
            gs.append((Jb - Jt) / np.maximum(np.abs(Jt), 1e-12))
            stt_all.append(np.asarray(stt))
        g = np.concatenate(gs)
        res["fullbatch"] = dict(
            lanes_x_windows=int(g.size), gap_max=float(g.max()),
            gap_p99=float(np.percentile(g, 99)), gap_mean=float(g.mean()),
            tight_success=float(np.concatenate(stt_all).mean()))
        print(f"fullbatch: gap max {g.max():.2e} p99 "
              f"{np.percentile(g, 99):.2e}", flush=True)
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1), flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("phase", nargs="?", default="all",
                   choices=["all", "phase1", "phase2"])
    p.add_argument("--npz", default="results_gpu/agreement_flexsat.npz")
    p.add_argument("--out", default="results_gpu/agreement_flexsat.json")
    p.add_argument("--batch", type=int, default=B_DEFAULT)
    args = p.parse_args()
    if args.phase in ("all", "phase1"):
        phase1_gpu(args.npz, args.batch)
    if args.phase == "phase2":
        phase2_cpu(args.npz, args.out)
    elif args.phase == "all":
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        subprocess.run(
            [sys.executable, "-m", "altro_mpc.bench.agreement_flexsat",
             "phase2", "--npz", args.npz, "--out", args.out],
            check=True, env=env, cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))


if __name__ == "__main__":
    main()
