"""GPU-f32 vs CPU-f64 agreement artifact for the batched QUADRUPED rows.

The conic families carry a quality gate (bench/agreement_conic.py); this
closes the same loop for the quadruped GPU throughput rows
(bench/batched_families.quadruped_batched): B trot-MPC instances (8
contact schedules x x0 perturbations) solved f32 on GPU at the bench
config are sampled and re-solved with the f64 CPU solver at 1e-7 (truth);
reported per friction mode:

  - err_U: max |U_gpu - U_truth| (force scale ~10-130 N);
  - cost_rel_gap: relative cost excess of the GPU solution under an f64
    rollout of its controls (the tolerance-robust metric);
  - first-force error |u0_gpu - u0_truth| (the control actually applied —
    the closed-loop-relevant number, mujoco_test.jl's is_same check).

Two phases, so that only one process opens the card: phase1 on the GPU,
phase2 re-exec'd with JAX_PLATFORMS=cpu. Writes
results_gpu/agreement_quadruped.json.

Run on the GPU: ``python -m altro_mpc.bench.agreement_quadruped``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

SAMPLE = 16
B_DEFAULT = 512


def _instances(dtype, linearized_friction: bool, B: int):
    """The quadruped_batched instance construction (kept in ONE place so
    f32-GPU and f64-CPU build the identical problems)."""
    import jax
    import jax.numpy as jnp

    import altro_mpc as at
    from altro_mpc.models.quadruped import config, controller, planner
    from altro_mpc.models.quadruped.config import woofer as _w
    from altro_mpc.models.quadruped.controller import (_linearized_problem,
                                                       SPRUNG_MASS)
    from altro_mpc.models.quadruped.gait import GAITS

    cfg = config.MPCConfig(linearized_friction=linearized_friction)
    gait = GAITS[cfg.gait_type](cfg.stance_time, cfg.swing_time)
    prob, x_des = controller.build_mpc_problem(cfg, dtype)
    opts = at.SolverOptions(
        cost_tolerance=1e-4, constraint_tolerance=1e-4,
        penalty_initial=10.0, penalty_scaling=100.0)

    n_sched = 8
    cycle = cfg.stance_time + cfg.swing_time
    feet0 = (x_des[0:3][None, :] + planner.nominal_foot_locations()
             ).at[:, 2].set(_w.geometry.foot_radius).astype(dtype)
    with jax.default_matmul_precision("highest"):
        probs = []
        for i in range(n_sched):
            # MID-phase sampling (i+0.5): t = i*cycle/8 lands exactly on
            # gait phase boundaries (t=0.2 for the trot), where f32-vs-f64
            # rounding flips the contact schedule between the GPU phase and
            # the f64 truth phase — the instances then mismatch entirely
            # (first artifact run: err_U 30.5 / cost gap 60x, IDENTICAL
            # across friction modes — the tell that it was instance
            # pairing, not solver quality)
            t = jnp.asarray((i + 0.5) * cycle / n_sched, dtype)
            x_ref = jnp.tile(x_des, (cfg.N, 1))
            contacts, foot_locs, _ = planner.foot_history(
                t, x_ref, feet0, feet0, gait, x_des, cfg.N,
                cfg.dynamics_discretization)
            probs.append(_linearized_problem(
                prob, x_des, x_ref, contacts, foot_locs,
                cfg.dynamics_discretization))
        prob_stack = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *probs)
        prob_b = jax.tree_util.tree_map(
            lambda a: jnp.repeat(a, B // n_sched, axis=0), prob_stack)

    fz = SPRUNG_MASS * 9.81 / 4.0
    u0 = jnp.zeros((cfg.N - 1, 12), dtype).at[:, 2::3].set(fz)
    rng = np.random.default_rng(3)
    scale = jnp.asarray(
        [.02, .02, .02, .05, .05, .05, .02, .02, .02, .05, .05, .05], dtype)
    x0s = (x_des[None, :]
           + jnp.asarray(rng.standard_normal((B, 12)), dtype) * scale)
    return prob_b, x0s, u0, opts


def phase1_gpu(out_npz: str, B: int = B_DEFAULT):
    """f32 solves on the GPU. The GROUPED nested-vmap layout (the
    shipped quadruped_batched row) is the gated path — its solutions
    feed the f64 truth sample — and ALL lanes of both layouts are scored
    against a TIGHT f32 re-solve (cost_tolerance 1e-6, classical inner
    loop) under the true cost, the conic families' full-batch truth-lite
    pattern (agreement_conic.py)."""
    import jax
    import jax.numpy as jnp

    import altro_mpc as at

    save = {}
    n_sched = 8
    reps = B // n_sched
    for lin in (True, False):
        prob_b, x0s, u0, opts = _instances(jnp.float32, lin, B)
        opts_tight = opts.replace(
            cost_tolerance=1e-6, gradient_tolerance=1e-8,
            constraint_tolerance=1e-4, iterations_outer=30,
            iterations_inner=50)

        def solve_one(prob_k, x0, o=opts):
            sol = at.solve(prob_k.replace(x0=x0), o, U0=u0)
            return sol.U, sol.stats.status, sol.stats.viol

        def traj_cost(prob_k, x0, U):
            X = prob_k.dynamics.rollout(x0, U)
            return prob_k.cost.total(X, U)

        prob_s = jax.tree_util.tree_map(lambda a: a[::reps], prob_b)
        jflat = jax.jit(jax.vmap(solve_one))
        jgrouped = jax.jit(jax.vmap(jax.vmap(solve_one, in_axes=(None, 0)),
                                    in_axes=(0, 0)))
        jtightg = jax.jit(jax.vmap(jax.vmap(
            lambda pk, x0: solve_one(pk, x0, opts_tight),
            in_axes=(None, 0)), in_axes=(0, 0)))
        jcosts = jax.jit(jax.vmap(jax.vmap(traj_cost, in_axes=(None, 0, 0)),
                                  in_axes=(0, 0, 0)))

        x0_g = x0s.reshape(n_sched, reps, -1)
        Uf, stf, vlf = jflat(prob_b, x0s)
        Ug, stg, vlg = jgrouped(prob_s, x0_g)
        Ut, stt, _ = jtightg(prob_s, x0_g)
        Jf = jcosts(prob_s, x0_g, np.reshape(np.asarray(Uf),
                                             Ug.shape))
        Jg = jcosts(prob_s, x0_g, Ug)
        Jt = jcosts(prob_s, x0_g, Ut)
        jax.block_until_ready(Jt)
        den = jnp.maximum(jnp.abs(Jt), 1e-12)
        key = "qp" if lin else "socp"
        save[f"{key}_gap_flat"] = np.asarray((Jf - Jt) / den).ravel()
        save[f"{key}_gap_grouped"] = np.asarray((Jg - Jt) / den).ravel()
        save[f"{key}_tight_status"] = np.asarray(stt).ravel()

        # the f64 truth sample anchors the GROUPED solutions (shipped path)
        U = np.asarray(Ug).reshape(B, *np.asarray(Ug).shape[2:])
        st = np.asarray(stg).ravel()
        vl = np.asarray(vlg).ravel()
        idx = np.linspace(0, B - 1, SAMPLE).astype(int)
        save[f"{key}_idx"] = idx
        save[f"{key}_U"] = U[idx]
        save[f"{key}_status"] = st
        save[f"{key}_viol"] = vl
        save[f"{key}_status_flat"] = np.asarray(stf)
        gg = save[f"{key}_gap_grouped"]
        print(f"phase1 {key}: success grouped {float(st.mean()):.4f} / "
              f"flat {float(np.asarray(stf).mean()):.4f} max_viol "
              f"{float(vl.max()):.2e} | fullbatch gap vs tight-f32: "
              f"max {gg.max():.2e} p99 {np.percentile(gg, 99):.2e}",
              flush=True)
    np.savez(out_npz, **save)


def phase2_cpu(in_npz: str, out_json: str, B: int = B_DEFAULT):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import altro_mpc as at

    data = np.load(in_npz)
    res = dict(config=dict(sample=SAMPLE, batch=B, truth_tol=1e-7), modes={})
    for lin in (True, False):
        key = "qp" if lin else "socp"
        prob_b, x0s, u0, opts = _instances(jnp.float64, lin, B)
        opts_truth = opts.replace(
            cost_tolerance=1e-7, gradient_tolerance=1e-9,
            constraint_tolerance=1e-7, iterations_outer=40,
            iterations_inner=100)
        idx = data[f"{key}_idx"]
        U_gpu = data[f"{key}_U"]

        def pick(i):
            return jax.tree_util.tree_map(lambda a: a[int(i)], prob_b)

        def solve_truth(prob_k, x0, U0):
            sol = at.solve(prob_k, opts_truth, U0=U0)
            return sol.U, sol.stats.status

        def traj_cost(prob_k, x0, U):
            X = prob_k.dynamics.rollout(x0, U)
            return prob_k.cost.total(X, U)

        jtruth = jax.jit(solve_truth)
        jcost = jax.jit(traj_cost)
        errs, gaps, u0errs, stts = [], [], [], []
        for j, i in enumerate(idx):
            pk = pick(i).replace(x0=jnp.asarray(x0s[int(i)], jnp.float64))
            U_t = jnp.asarray(U_gpu[j], jnp.float64)
            U_truth, st = jtruth(pk, pk.x0, U_t)
            stts.append(int(st))
            errs.append(float(np.max(np.abs(U_gpu[j] - np.asarray(U_truth)))))
            u0errs.append(float(np.max(np.abs(U_gpu[j][0]
                                              - np.asarray(U_truth)[0]))))
            J_gpu = float(jcost(pk, pk.x0, U_t))
            J_tr = float(jcost(pk, pk.x0, U_truth))
            gaps.append((J_gpu - J_tr) / max(abs(J_tr), 1e-12))
        row = dict(
            gpu_success_rate=float(np.mean(data[f"{key}_status"])),
            gpu_max_viol=float(np.max(data[f"{key}_viol"])),
            err_U_max=float(np.max(errs)), err_U_mean=float(np.mean(errs)),
            err_u0_max=float(np.max(u0errs)),
            cost_rel_gap_max=float(np.max(gaps)),
            cost_rel_gap_mean=float(np.mean(gaps)),
            truth_success=int(min(stts)))
        for variant in ("grouped", "flat"):
            gkey = f"{key}_gap_{variant}"
            if gkey in data:
                g = data[gkey]
                row[f"fullbatch_{variant}"] = dict(
                    lanes=int(g.size), gap_max=float(g.max()),
                    gap_p99=float(np.percentile(g, 99)),
                    gap_mean=float(g.mean()))
        res["modes"][key] = row
        print(f"phase2 {key}: err_U {row['err_U_max']:.2e} u0 "
              f"{row['err_u0_max']:.2e} cost_gap "
              f"{row['cost_rel_gap_max']:.2e}", flush=True)

    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1), flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("phase", nargs="?", default="all",
                   choices=["all", "phase1", "phase2"])
    p.add_argument("--npz", default="results_gpu/agreement_quadruped.npz")
    p.add_argument("--out", default="results_gpu/agreement_quadruped.json")
    p.add_argument("--batch", type=int, default=B_DEFAULT)
    args = p.parse_args()
    if args.phase in ("all", "phase1"):
        phase1_gpu(args.npz, args.batch)
    if args.phase == "phase2":
        phase2_cpu(args.npz, args.out, args.batch)
    elif args.phase == "all":
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        subprocess.run(
            [sys.executable, "-m", "altro_mpc.bench.agreement_quadruped",
             "phase2", "--npz", args.npz, "--out", args.out, "--batch",
             str(args.batch)],
            check=True, env=env, cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))


if __name__ == "__main__":
    main()
