"""GPU-f32 vs CPU-f64 vs native-C++ agreement artifact for the CONIC benches.

The flagship agreement artifact (bench/agreement.py) closes the "matching
controls on hardware" question for the random-linear QP config; this one
does the same for the SOC benchmarks — the paper's actual subject (rocket
cones rocket_landing_problem.jl:119-167; grasp friction cones
grasp_problem.jl:60-95) and exactly where f32 agreement is least obvious
(penalties to 1e8, projection kinks, the inexact-inner tail fix).

Methodology = the reference's own oracle pattern (simple_rocket.jl:184-203:
3-way COST + error cross-check), because raw control agreement at the
benchmark's reference-matched tol=1e-4 is ill-posed: the reference's own
tolerance figure shows err_U ~1 at tol 1e-4 falling to ~1e-4 at 1e-8 (and
our f64 study reproduces it, results_cpu/rocket_multibaseline.json) — at
loose tolerance any stopping point in a flat cost valley is "converged",
so two equally-valid solves can differ by O(1) in late controls while
matching in cost to 1e-6. A same-algorithm f32-vs-f64 replay of one MPC
step confirmed this: identical carry/noise/options diverge to O(0.1) dU
at matched cost, purely from rounding flipping line-search decisions.

So per family this runs the T-step B-lane GPU MPC at TWO configs — the
SHIPPED bench opts (tol 1e-4, early-exact stop, inexact inner) and a
TIGHT config (tol 1e-6, classical inner loop) — and reports for each,
against an independent f64 truth solve at 1e-7:

  - ``err_U``: max control error vs truth (the tolerance-study metric);
    expected O(1) at the bench config (matches the reference's own
    figure), ~1e-3 (the f32 floor) at the tight config;
  - ``cost_rel_gap``: relative cost excess of the GPU trajectory
    (f64 rollout of the GPU controls) over the truth cost — the metric
    that is meaningful at BOTH tolerances;
  - ``max_dU_cpu_f64_vs_native_cpp``: the truth solve cross-checked
    against the native C++ conic ADMM at 1e-9 (foreign-codebase oracle).

Two phases, so that only one process opens the card: ``main`` runs phase1
on the GPU and re-execs phase2 with JAX_PLATFORMS=cpu. Writes
results_gpu/agreement_conic.json.

Run on the GPU: ``python -m altro_mpc.bench.agreement_conic``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

SAMPLE = 16
T_STEPS = 10
# window indices where lanes are sampled against the f64 truth: a
# warm-lock failure mode can hide in unsampled steps, so the gate spans
# early/mid/late windows.
CHECK_STEPS = (4, 7, 10)
# windows where ALL lanes are gated: the failure modes this
# artifact exists to catch (warm-lock, knife-edge lanes) live on the tail
# of the batch, which a 16-lane sample misses. At each of these windows
# every lane's shipped-config solution is scored against a COLD TIGHT f32
# re-solve of the identical instance (U0 = the window's tracking controls,
# fresh duals — no warm-chain inheritance), both evaluated under the f64
# true cost; the per-lane relative gap histogram (max/p99/mean) is the
# gate. The 16-lane f64-truth sample stays as the absolute anchor, and
# phase2 cross-scores the cold-tight solutions against that truth so the
# truth-lite itself is validated.
FULL_STEPS = (2, 4, 6, 8, 10)
B_DEFAULT = 1024

FAMILIES = ("rocket", "grasp")
# the tight config: classical inner loop, no early-exact stop — the
# f32-floor measurement point
TIGHT = dict(cost_tolerance=1e-6, gradient_tolerance=1e-8,
             constraint_tolerance=1e-5, iterations_outer=30,
             iterations_inner=50, reg_min=1e-8, early_exact_tol=0.0)
CONFIGS = (("bench", None), ("tight", TIGHT))

# diagnostics hooks (env, read at import in BOTH phases — the phase2
# subprocess inherits them): ALTRO_AGREEMENT_FAMILIES="rocket" restricts
# the family set; ALTRO_AGREEMENT_EXTRA="L11" adds a bench-with-L=11
# config (separates ladder-width effects from window effects when the
# multi-window gate moves)
for _tok in (s for s in os.environ.get("ALTRO_AGREEMENT_EXTRA",
                                       "").split(",") if s):
    # token: L<k>[d<pct>] — ladder of k rungs, optional ls_decrease pct/100
    # (e.g. L3d25 = 3 rungs at decrease 0.25: alphas 1, .25, .0625)
    assert _tok.startswith("L"), _tok
    if "d" in _tok:
        _l, _d = _tok[1:].split("d")
        _ov = dict(iterations_linesearch=int(_l),
                   ls_decrease=int(_d) / 100.0)
    else:
        _ov = dict(iterations_linesearch=int(_tok[1:]))
    CONFIGS = CONFIGS + ((f"bench{_tok}", _ov),)
if os.environ.get("ALTRO_AGREEMENT_FAMILIES"):
    FAMILIES = tuple(os.environ["ALTRO_AGREEMENT_FAMILIES"].split(","))


def _setup(family, dtype, opts_override=None, track=None):
    from altro_mpc.bench import batched_conic
    fn = dict(rocket=batched_conic.rocket_setup,
              grasp=batched_conic.grasp_setup)[family]
    return fn(dtype, opts_override=opts_override, track=track)


def _make_step(su):
    from altro_mpc.mpc import make_mpc_step
    kw = {}
    if su["noise_model"] is not None:
        kw["noise_model"] = su["noise_model"]
    if su["constraints_fn"] is not None:
        kw["constraints_fn"] = su["constraints_fn"]
    return make_mpc_step(su["prob_mpc"], su["opts"], su["X_track"],
                         su["U_track"], shared_k=True,
                         warm_start=su.get("warm_start", "shift"), **kw)


def _tight_batch_solver(su_tight):
    """Jitted batched COLD tight re-solver: (k, x0s[B,n]) -> (U, status,
    viol) with U0 = the window's tracking controls and fresh duals — the
    full-batch truth-lite (see FULL_STEPS)."""
    import jax

    import altro_mpc as at
    from altro_mpc.costs import retarget_tracking
    from altro_mpc.mpc import track_window

    prob_mpc = su_tight["prob_mpc"]
    opts = su_tight["opts"]
    X_track, U_track = su_tight["X_track"], su_tight["U_track"]
    cfn = su_tight["constraints_fn"]

    def solve_batch(k, x0s):
        Xw, Uw = track_window(X_track, U_track, k, prob_mpc.N)
        prob_k = prob_mpc.replace(
            cost=retarget_tracking(prob_mpc.cost, Xw, Uw))
        if cfn is not None:
            prob_k = prob_k.replace(constraints=cfn(k))

        def one(x0):
            sol = at.solve(prob_k.replace(x0=x0), opts, U0=Uw)
            return sol.U, sol.stats.status, sol.stats.viol

        return jax.vmap(one)(x0s)

    return jax.jit(solve_batch)


def phase1_gpu(out_npz: str, B: int = B_DEFAULT):
    import jax
    import jax.numpy as jnp

    save = dict(k=int(T_STEPS))
    for family in FAMILIES:
        track = None
        tight_solver = None
        for cname, ov in CONFIGS:
            su = _setup(family, jnp.float32, opts_override=ov, track=track)
            track = (su["X_track"], su["U_track"])  # cold solve reused
            if tight_solver is None:
                su_t = _setup(family, jnp.float32, opts_override=TIGHT,
                              track=track)
                tight_solver = _tight_batch_solver(su_t)
            step, init_carry = _make_step(su)
            vstep = jax.jit(jax.vmap(step, in_axes=(0, 0, None)))
            rng = np.random.default_rng(1 if family == "rocket" else 0)
            noise = jnp.asarray(
                rng.standard_normal((T_STEPS, B, su["noise_dim"])),
                jnp.float32)
            carry = jax.block_until_ready(
                jax.jit(jax.vmap(lambda _: init_carry()))(jnp.arange(B)))
            idx = np.linspace(0, B - 1, SAMPLE).astype(int)
            key = f"{family}_{cname}"
            for t in range(T_STEPS):
                carry, out = vstep(carry, noise[t],
                                   jnp.asarray(t, jnp.int32))
                if (t + 1) in CHECK_STEPS:  # solve used window k = t+1
                    save[f"{key}_k{t + 1}_x0"] = np.asarray(out.x0)[idx]
                    save[f"{key}_k{t + 1}_U"] = np.asarray(out.U)[idx]
                if (t + 1) in FULL_STEPS:
                    # full-batch gate: every lane's solution + a cold tight
                    # re-solve of the identical instances
                    Uc, stc, vic = tight_solver(
                        jnp.asarray(t + 1, jnp.int32), out.x0)
                    save[f"{key}_f{t + 1}_x0"] = np.asarray(out.x0)
                    save[f"{key}_f{t + 1}_U"] = np.asarray(out.U)
                    save[f"{key}_f{t + 1}_Uc"] = np.asarray(Uc)
                    save[f"{key}_f{t + 1}_stc"] = np.asarray(stc)
                    save[f"{key}_f{t + 1}_vic"] = np.asarray(vic)
            jax.block_until_ready(carry)
            save[f"{key}_status"] = np.asarray(out.status)
            save[f"{key}_viol"] = np.asarray(out.viol)
            print(f"phase1 {key}: success "
                  f"{float(np.mean(np.asarray(out.status))):.4f} "
                  f"max_viol {float(np.max(np.asarray(out.viol))):.2e}",
                  flush=True)
        save[f"{family}_Xtrack"] = np.asarray(track[0])
        save[f"{family}_Utrack"] = np.asarray(track[1])
    np.savez(out_npz, **save)


def phase2_cpu(in_npz: str, out_json: str):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import altro_mpc as at
    from altro_mpc import native
    from altro_mpc.costs import retarget_tracking
    from altro_mpc.mpc import track_window
    from altro_mpc.solver import admm_conic
    from altro_mpc.transcribe import to_batch_conic

    data = np.load(in_npz)
    res = dict(config=dict(sample=SAMPLE, steps=T_STEPS,
                           window_ks=list(CHECK_STEPS),
                           truth_tol=1e-7, native_tol=1e-9,
                           tight_config=TIGHT),
               families={})
    for family in FAMILIES:
        track = (jnp.asarray(data[f"{family}_Xtrack"], jnp.float64),
                 jnp.asarray(data[f"{family}_Utrack"], jnp.float64))
        su = _setup(family, jnp.float64, track=track)
        prob_mpc = su["prob_mpc"]
        N_mpc = prob_mpc.N
        opts_truth = at.SolverOptions(
            cost_tolerance=1e-7, gradient_tolerance=1e-9,
            constraint_tolerance=1e-7, penalty_initial=1e3,
            penalty_scaling=10.0, iterations_outer=40,
            iterations_inner=100)

        def prob_at(k):
            Xw, Uw = track_window(track[0], track[1], k, N_mpc)
            pb = prob_mpc.replace(
                cost=retarget_tracking(prob_mpc.cost, Xw, Uw))
            if su["constraints_fn"] is not None:
                pb = pb.replace(constraints=su["constraints_fn"](k))
            return pb

        def solve_truth(pb, x0, U0, opts=opts_truth):
            sol = at.solve(pb.replace(x0=x0), opts, U0=U0)
            return sol.U, sol.stats.status

        def traj_cost(pb, x0, U):
            X = pb.dynamics.rollout(x0, U)
            return pb.cost.total(X, U)

        jtruth = jax.jit(solve_truth)
        jcost = jax.jit(traj_cost)
        jcosts = jax.jit(jax.vmap(traj_cost, in_axes=(None, 0, 0)))

        fam_row = {}
        for cname, _ov in CONFIGS:
            key = f"{family}_{cname}"
            errs, gaps, stts, stns, d_nat = [], [], [], [], []
            gaps_cold = []  # cold-tight truth-lite scored vs the f64 truth
            Bfull = (data[f"{key}_f{FULL_STEPS[0]}_x0"].shape[0]
                     if f"{key}_f{FULL_STEPS[0]}_x0" in data else 0)
            sidx = np.linspace(0, max(Bfull - 1, 0), SAMPLE).astype(int)
            for k in CHECK_STEPS:
                prob_base = prob_at(k)
                x0s = data[f"{key}_k{k}_x0"]
                U_gpu = data[f"{key}_k{k}_U"]
                for i in range(SAMPLE):
                    x0 = jnp.asarray(x0s[i], jnp.float64)
                    U_t = jnp.asarray(U_gpu[i], jnp.float64)
                    U_truth, st = jtruth(prob_base, x0, U_t)
                    stts.append(int(st))
                    errs.append(float(np.max(np.abs(
                        U_gpu[i] - np.asarray(U_truth)))))
                    J_gpu = float(jcost(prob_base, x0, U_t))
                    J_tr = float(jcost(prob_base, x0, U_truth))
                    gaps.append((J_gpu - J_tr) / max(abs(J_tr), 1e-12))
                    if k in FULL_STEPS and Bfull:
                        U_c = jnp.asarray(
                            data[f"{key}_f{k}_Uc"][sidx[i]], jnp.float64)
                        J_c = float(jcost(prob_base, x0, U_c))
                        gaps_cold.append(
                            (J_c - J_tr) / max(abs(J_tr), 1e-12))
                    if cname == "tight" and k == CHECK_STEPS[-1]:
                        cdata = to_batch_conic(prob_base.replace(x0=x0))
                        nat = native.solve_conic(
                            np.asarray(cdata.P), np.asarray(cdata.q),
                            np.asarray(cdata.A), np.asarray(cdata.b),
                            cdata.segments, eps_abs=1e-9, max_iter=300000)
                        stns.append(int(nat.status))
                        _, U_nat = admm_conic.extract_traj(
                            cdata, jnp.asarray(nat.x))
                        d_nat.append(float(np.max(np.abs(
                            np.asarray(U_truth) - np.asarray(U_nat)))))
            row = dict(
                gpu_success_rate=float(np.mean(data[f"{key}_status"])),
                gpu_max_viol=float(np.max(data[f"{key}_viol"])),
                err_U_max=float(np.max(errs)),
                err_U_mean=float(np.mean(errs)),
                cost_rel_gap_max=float(np.max(gaps)),
                cost_rel_gap_mean=float(np.mean(gaps)),
                truth_success=int(min(stts)))
            if d_nat:
                row["max_dU_cpu_f64_vs_native_cpp"] = float(np.max(d_nat))
                row["native_success"] = int(min(stns))
            if Bfull:
                # full-batch gate: every lane at FULL_STEPS windows vs the
                # cold-tight f32 re-solve, f64 true-cost scoring
                fbg = []
                for k in FULL_STEPS:
                    prob_base = prob_at(k)
                    x0b = jnp.asarray(data[f"{key}_f{k}_x0"], jnp.float64)
                    Jb = np.asarray(jcosts(
                        prob_base, x0b,
                        jnp.asarray(data[f"{key}_f{k}_U"], jnp.float64)))
                    Jc = np.asarray(jcosts(
                        prob_base, x0b,
                        jnp.asarray(data[f"{key}_f{k}_Uc"], jnp.float64)))
                    fbg.append((Jb - Jc) / np.maximum(np.abs(Jc), 1e-12))
                g = np.concatenate(fbg)
                row["fullbatch"] = dict(
                    lanes=int(Bfull), windows=list(FULL_STEPS),
                    cold_tight_success=float(np.mean(
                        [data[f"{key}_f{k}_stc"] for k in FULL_STEPS])),
                    cold_tight_max_viol=float(np.max(
                        [data[f"{key}_f{k}_vic"] for k in FULL_STEPS])),
                    gap_max=float(g.max()), gap_min=float(g.min()),
                    gap_p99=float(np.percentile(g, 99)),
                    gap_mean=float(g.mean()),
                    frac_above_5pct=float(np.mean(g > 0.05)),
                    cold_tight_vs_truth_gap_max=(
                        float(np.max(gaps_cold)) if gaps_cold else None),
                )
            fam_row[cname] = row
            print(f"phase2 {key}: err_U {row['err_U_max']:.2e} "
                  f"cost_gap {row['cost_rel_gap_max']:.2e} "
                  f"(over k={list(CHECK_STEPS)})"
                  + (f" | fullbatch gap max {row['fullbatch']['gap_max']:.2e}"
                     f" p99 {row['fullbatch']['gap_p99']:.2e}"
                     if Bfull else ""), flush=True)
        res["families"][family] = fam_row

    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1), flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("phase", nargs="?", default="all",
                   choices=["all", "phase1", "phase2"])
    p.add_argument("--npz", default="results_gpu/agreement_conic.npz")
    p.add_argument("--out", default="results_gpu/agreement_conic.json")
    p.add_argument("--batch", type=int, default=B_DEFAULT)
    args = p.parse_args()
    if args.phase in ("all", "phase1"):
        phase1_gpu(args.npz, args.batch)
    if args.phase == "phase2":
        phase2_cpu(args.npz, args.out)
    elif args.phase == "all":
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        subprocess.run(
            [sys.executable, "-m", "altro_mpc.bench.agreement_conic",
             "phase2", "--npz", args.npz, "--out", args.out],
            check=True, env=env, cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))


if __name__ == "__main__":
    main()
