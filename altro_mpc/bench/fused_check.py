"""Kernel-vs-XLA SOC COST-PARITY gate (all lanes, rocket + grasp).

What is checked (a dU bound cannot catch a kernel bug that moves solutions
to *different feasible* points): at every MPC step of a T-step warm chain,
the kernel path (ALTRO_PALLAS default) and the XLA path
(ALTRO_PALLAS=0) are run from the IDENTICAL warm-start carry on the
identical instances, and each lane's two solutions are scored under the
TRUE (unpenalized) objective of that instance in f64:

    gap_i = (J_kernel_i - J_xla_i) / max(|J_xla_i|, 1e-12)

Raw dU between the two is ill-posed at the bench tolerance (f32 arithmetic
reordering flips line-search decisions on knife-edge lanes and two
equally-valid stopping points in a flat cost valley differ by O(1) in late
controls — the agreement_conic methodology note). The per-lane cost-gap
MAX is likewise an extreme-value statistic: ANY two bit-different
compilations of the same solver move the worst knife-edge lane's stopping
point by O(0.1) in relative cost on these SOC problems (the same
config's worst lane swings 0.07 <-> 0.29 between two otherwise-identical
chains). What a real kernel DEFECT would produce, and what the gate
therefore checks over all B lanes x T steps per family:

  - success/violation parity (a broken kernel fails solves);
  - |gap_signed_mean| <= GATE_BIAS: a defect biases solutions one way;
  - gap_abs_p99 <= GATE_P99: a defect moves MANY lanes, not the
    knife-edge tail.

The chain advances with the kernel path's solution (the shipped path), so
every step's comparison is a controlled A/B on one instance set;
cross-check per the reference's own 3-way cost oracle
(benchmarks/rocket_landing/simple_rocket.jl:184-203).

Two phases: the solves on the GPU, then f64 scoring in a child process with
JAX_PLATFORMS=cpu, so that only one process opens the card. Run on the GPU:
``python -m altro_mpc.bench.fused_check``. Writes
results_gpu/fused_soc_check.json.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

B_DEFAULT = 1024
T_STEPS = 6
FAMILIES = ("rocket", "grasp")
# Gate thresholds (see module docstring for the defect model):
GATE_BIAS = 1e-3   # |mean signed gap| — catches systematic degradation
GATE_P99 = 2e-2    # |gap| 99th percentile — catches broad divergence


def _setup(family, dtype, track=None):
    from altro_mpc.bench import batched_conic
    fn = dict(rocket=batched_conic.rocket_setup,
              grasp=batched_conic.grasp_setup)[family]
    return fn(dtype, track=track)


def phase1_gpu(out_npz: str, B: int = B_DEFAULT):
    import jax
    import jax.numpy as jnp

    from altro_mpc.mpc import make_mpc_step

    save = dict(T=int(T_STEPS))
    for family in FAMILIES:
        su = _setup(family, jnp.float32)
        kw = {}
        if su["noise_model"] is not None:
            kw["noise_model"] = su["noise_model"]
        if su["constraints_fn"] is not None:
            kw["constraints_fn"] = su["constraints_fn"]

        # ALTRO_PALLAS is read at TRACE time inside the solver body, so
        # each variant is traced (first called) under its own env value;
        # after both are compiled the env var is irrelevant.
        vsteps = {}
        step, init_carry = make_mpc_step(
            su["prob_mpc"], su["opts"], su["X_track"], su["U_track"],
            shared_k=True, warm_start=su.get("warm_start", "shift"), **kw)
        rng = np.random.default_rng(1 if family == "rocket" else 0)
        noise = jnp.asarray(
            rng.standard_normal((T_STEPS, B, su["noise_dim"])), jnp.float32)
        carry0 = jax.block_until_ready(
            jax.jit(jax.vmap(lambda _: init_carry()))(jnp.arange(B)))
        for envval, label in (("auto", "kernel"), ("0", "xla")):
            os.environ["ALTRO_PALLAS"] = envval
            vstep = jax.jit(jax.vmap(step, in_axes=(0, 0, None)))
            t0 = time.perf_counter()
            c, _ = vstep(carry0, noise[0], jnp.asarray(0, jnp.int32))
            jax.block_until_ready(c)
            save[f"{family}_{label}_compile_s"] = time.perf_counter() - t0
            vsteps[label] = vstep
        os.environ.pop("ALTRO_PALLAS", None)

        carry = carry0
        for t in range(T_STEPS):
            k = jnp.asarray(t, jnp.int32)
            # XLA step from the SAME carry (same instances), then the
            # chain advances with the kernel path's solution
            _, out_u = vsteps["xla"](carry, noise[t], k)
            carry, out_f = vsteps["kernel"](carry, noise[t], k)
            save[f"{family}_k{t + 1}_x0"] = np.asarray(out_f.x0)
            save[f"{family}_k{t + 1}_Uf"] = np.asarray(out_f.U)
            save[f"{family}_k{t + 1}_Uu"] = np.asarray(out_u.U)
            save[f"{family}_k{t + 1}_status"] = np.stack(
                [np.asarray(out_f.status), np.asarray(out_u.status)])
            save[f"{family}_k{t + 1}_viol"] = np.stack(
                [np.asarray(out_f.viol), np.asarray(out_u.viol)])
        save[f"{family}_Xtrack"] = np.asarray(su["X_track"])
        save[f"{family}_Utrack"] = np.asarray(su["U_track"])
        print(f"phase1 {family}: success kernel "
              f"{float(save[f'{family}_k{T_STEPS}_status'][0].mean()):.4f} "
              f"xla "
              f"{float(save[f'{family}_k{T_STEPS}_status'][1].mean()):.4f}",
              flush=True)
    np.savez(out_npz, **save)


def phase2_cpu(in_npz: str, out_json: str):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    data = np.load(in_npz)
    res = dict(config=dict(steps=T_STEPS, gate_bias=GATE_BIAS,
                           gate_p99=GATE_P99,
                           metric="per-lane relative TRUE-cost gap, kernel "
                                  "vs XLA path from identical warm carry"))
    ok = True
    for family in FAMILIES:
        track = (jnp.asarray(data[f"{family}_Xtrack"], jnp.float64),
                 jnp.asarray(data[f"{family}_Utrack"], jnp.float64))
        su = _setup(family, jnp.float64, track=track)
        prob_mpc = su["prob_mpc"]
        from altro_mpc.costs import retarget_tracking
        from altro_mpc.mpc import track_window

        def prob_at(k):
            Xw, Uw = track_window(track[0], track[1], k, prob_mpc.N)
            pb = prob_mpc.replace(
                cost=retarget_tracking(prob_mpc.cost, Xw, Uw))
            if su["constraints_fn"] is not None:
                pb = pb.replace(constraints=su["constraints_fn"](k))
            return pb

        def costs(pb, x0, U):
            X = pb.dynamics.rollout(x0, U)
            return pb.cost.total(X, U)

        jcosts = jax.jit(jax.vmap(costs, in_axes=(None, 0, 0)))

        gaps = []
        for t in range(T_STEPS):
            pb = prob_at(t + 1)
            x0 = jnp.asarray(data[f"{family}_k{t + 1}_x0"], jnp.float64)
            Uf = jnp.asarray(data[f"{family}_k{t + 1}_Uf"], jnp.float64)
            Uu = jnp.asarray(data[f"{family}_k{t + 1}_Uu"], jnp.float64)
            Jf = np.asarray(jcosts(pb, x0, Uf))
            Ju = np.asarray(jcosts(pb, x0, Uu))
            gaps.append((Jf - Ju) / np.maximum(np.abs(Ju), 1e-12))
        g = np.concatenate(gaps)
        ag = np.abs(g)
        row = dict(
            lanes=int(g.shape[0] // T_STEPS),
            success_kernel=float(np.mean([data[f"{family}_k{t+1}_status"][0]
                                         for t in range(T_STEPS)])),
            success_xla=float(np.mean([data[f"{family}_k{t+1}_status"][1]
                                           for t in range(T_STEPS)])),
            max_viol_kernel=float(np.max([data[f"{family}_k{t+1}_viol"][0]
                                         for t in range(T_STEPS)])),
            gap_abs_max=float(ag.max()),
            gap_abs_p99=float(np.percentile(ag, 99)),
            gap_abs_mean=float(ag.mean()),
            gap_signed_mean=float(g.mean()),
            compile_s_kernel=float(data[f"{family}_kernel_compile_s"]),
            compile_s_xla=float(data[f"{family}_xla_compile_s"]),
        )
        row["gate_pass"] = bool(
            row["success_kernel"] >= row["success_xla"]
            and abs(row["gap_signed_mean"]) <= GATE_BIAS
            and row["gap_abs_p99"] <= GATE_P99)
        ok = ok and row["gate_pass"]
        res[family] = row
        print(f"phase2 {family}: cost-gap max {row['gap_abs_max']:.2e} "
              f"p99 {row['gap_abs_p99']:.2e} signed-mean "
              f"{row['gap_signed_mean']:.2e} "
              f"({'PASS' if row['gate_pass'] else 'FAIL'} at "
              f"p99<={GATE_P99:g}, |bias|<={GATE_BIAS:g})", flush=True)
    res["gate_pass"] = ok
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(res, f, indent=1)
    if not ok:
        raise SystemExit("kernel-vs-XLA SOC cost-parity gate FAILED")


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("phase", nargs="?", default="all",
                   choices=["all", "phase1", "phase2"])
    p.add_argument("--npz", default="results_gpu/fused_check.npz")
    p.add_argument("--out", default="results_gpu/fused_soc_check.json")
    p.add_argument("--batch", type=int, default=B_DEFAULT)
    args = p.parse_args()
    if args.phase in ("all", "phase1"):
        os.makedirs(os.path.dirname(args.npz) or ".", exist_ok=True)
        phase1_gpu(args.npz, args.batch)
    if args.phase == "phase2":
        phase2_cpu(args.npz, args.out)
    elif args.phase == "all":
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        subprocess.run(
            [sys.executable, "-m", "altro_mpc.bench.fused_check",
             "phase2", "--npz", args.npz, "--out", args.out],
            check=True, env=env, cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))


if __name__ == "__main__":
    main()
