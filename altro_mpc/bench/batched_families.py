"""Batched GPU throughput for the remaining benchmark families.

bench.py covers the random-linear flagship and bench/batched_conic.py the
two conic benches; this driver covers the last two families so every
reference benchmark has a batched solves/s driver:

- **flexsat**: the N=80 flexible-satellite regulator MPC
  (flexible_sat_mpc.jl:242-308 — no window shifting; propagate + re-solve
  with warm primals/duals) batched over process-noise scenarios.
- **quadruped**: per-SOLVE throughput for the trot MPC at N=15, both
  friction modes (linearized QP / SOC cones), batched over instances
  sampled across the gait cycle (8 contact schedules x B/8 initial-state
  perturbations) — the batched counterpart of the reference's per-solve
  table (quadruped/plots/table.tex).

Methodology matches bench.py: jitted vmapped step, host-driven pipelined
pass for throughput, f32, matmul precision pinned inside the solver (and
in the quadruped's device-side problem construction here).

Run on the GPU:
``python -m altro_mpc.bench.batched_families [--out results_gpu]``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

import jax
import jax.numpy as jnp


def flexsat_batched(B: int = 1024, T: int = 45, compact_cap: int = 0,
                    compact_block: int = 128, compact_levels: tuple = ()):
    """Batched flexsat regulator loop (flexible_sat_mpc.jl:242-308).

    Warm-solve config (its levers were tuned on an earlier accelerator and
    are to be re-measured on the GPU):
      - early-exact stop with an L=5 ladder;
      - exact re-based X0 — the regulator analog of the flagship's
        shifted-X warm start: the window never advances, so the exact
        init rollout of the carried controls is
        X_prev + A^k (x0_new - x0_prev) with build-time A^k (no shift, no
        seam). Without it, some lanes fail at violation ~2;
      - penalty_initial=1e3 (the flagship schedule; the reference
        flexsat's 1e2 needs one extra AL round per solve)."""
    import altro_mpc as at
    from altro_mpc.models import flexible_satellite as fs

    dtype = jnp.float32
    prob = fs.flexsat_problem(dtype=dtype)
    opts = at.SolverOptions(
        cost_tolerance=1e-4, constraint_tolerance=1e-4,
        penalty_initial=1e3, penalty_scaling=100.0,
        early_exact_tol=1e-3, iterations_linesearch=5)
    print("  cold solve (N=80, f32)...", flush=True)
    sol0 = jax.jit(at.solve)(prob, opts)
    jax.block_until_ready(sol0.X)
    print(f"  cold: status={int(sol0.stats.status)}", flush=True)

    # exact re-based warm-start states (see docstring): Phis[k] = A^k
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
                (sol.stats.status, sol.stats.viol, sol.stats.iterations))

    if compact_cap:
        # Device-side straggler compaction, regulator form: the flexsat
        # tail is rocket-shaped (iteration p99 ~7x the mean) and the
        # batched while-loop runs to the slowest lane. Same three-phase schedule as
        # mpc.make_mpc_step_device_compacted — run all lanes to the cap,
        # gather a block of unconverged-first lanes, finish them, scatter,
        # full-batch catch-all — but with the fixed regulator problem (no
        # window shift; prob.x0 is not read on resume). Results are
        # bit-identical to the plain step (lanes freeze on their own
        # convergence).
        from altro_mpc.solver import altro as _alt

        def partial_step(carry, noise_i):
            x0, X, U, duals = carry
            x0n = prob.dynamics.step(x0, U[0], 0) + 2e-4 * noise_i
            with jax.default_matmul_precision("highest"):
                X0 = X + jnp.einsum("kij,j->ki", Phis, x0n - X[0])
            state = _alt.solve_partial(prob.replace(x0=x0n), opts, U0=U,
                                       duals=duals, X0=X0,
                                       it_cap=compact_cap)
            return state, x0n

        def resume(state, it_cap=None):
            with jax.default_matmul_precision("highest"):
                return _alt._flat_while(prob, opts, state, it_cap)

        def extract(state, x0n):
            sol = _alt._finalize(prob, state)
            return ((x0n, sol.X, sol.U, sol.duals),
                    (sol.stats.status, sol.stats.viol,
                     sol.stats.iterations))

        sched = ((compact_cap, compact_block),) + tuple(compact_levels)

        def compact(states, lvl, cum):
            blk = sched[lvl][1]
            done = states[10]
            take = jnp.argsort(done.astype(jnp.int32), stable=True)[:blk]
            sub = jax.tree_util.tree_map(lambda a: a[take], states)
            if lvl + 1 < len(sched):
                extra = sched[lvl + 1][0]
                sub = jax.vmap(
                    lambda s: resume(s, it_cap=cum + extra))(sub)
                sub = compact(sub, lvl + 1, cum + extra)
            else:
                sub = jax.vmap(resume)(sub)
            states = jax.tree_util.tree_map(
                lambda a, b: a.at[take].set(b), states, sub)
            return jax.vmap(resume)(states)  # catch-all; free when empty

        def step_batch(carry, noise_i):
            states, x0n = jax.vmap(partial_step)(carry, noise_i)
            states = compact(states, 0, compact_cap)
            return jax.vmap(extract)(states, x0n)

        vstep = jax.jit(step_batch)
    else:
        vstep = jax.jit(jax.vmap(astep))
    rng = np.random.default_rng(0)
    noise = jnp.asarray(rng.standard_normal((T, B, prob.n)), dtype)

    def init_carry(_):
        return (prob.x0, sol0.X, sol0.U, sol0.duals)

    carry0 = jax.block_until_ready(
        jax.jit(jax.vmap(init_carry))(jnp.arange(B)))
    t0 = time.perf_counter()
    carry, _ = vstep(carry0, noise[0])
    jax.block_until_ready(carry[0])
    compile_s = time.perf_counter() - t0

    carry = carry0
    stats = []
    t0 = time.perf_counter()
    for t in range(T):
        carry, out = vstep(carry, noise[t])
        stats.append(out)
    jax.block_until_ready(carry[0])
    dt = time.perf_counter() - t0
    st = np.concatenate([np.asarray(s[0]) for s in stats])
    vl = np.concatenate([np.asarray(s[1]) for s in stats])
    it = np.concatenate([np.asarray(s[2]) for s in stats])
    res = dict(label="flexsat_regulator_N80", batch=B, steps=T,
               solves_per_s=round(B * T / dt, 1),
               success_rate=float(st.mean()),
               max_viol=float(np.nanmax(vl)),
               mean_iters=float(it.mean()),
               iters_p99=float(np.percentile(it, 99)),
               wall_s=round(dt, 4),
               compile_s=round(compile_s, 1))
    if compact_cap:
        res["compact_it_cap"] = compact_cap
        res["compact_block"] = compact_block
        res["compact_levels"] = list(map(list, compact_levels))
    print(f"  flexsat: {res['solves_per_s']:.0f} solves/s (B={B}, "
          f"success {res['success_rate']:.4f}, iters {res['mean_iters']:.2f})",
          flush=True)
    return res


def quadruped_setup(B: int, linearized_friction: bool = True):
    """Shared quadruped batched-bench construction: the per-lane problem
    stack (8 contact schedules x B/8 lanes), warm-start controls, options,
    and the x0 sampler — used by :func:`quadruped_batched` and the
    quadruped agreement gate so they measure the identical config."""
    import altro_mpc as at
    from altro_mpc.models.quadruped import config, controller, planner
    from altro_mpc.models.quadruped.config import woofer as _w
    from altro_mpc.models.quadruped.controller import (_linearized_problem,
                                                       SPRUNG_MASS)
    from altro_mpc.models.quadruped.gait import GAITS

    dtype = jnp.float32
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
            t = jnp.asarray(i * cycle / n_sched, dtype)
            x_ref = jnp.tile(x_des, (cfg.N, 1))
            contacts, foot_locs, _ = planner.foot_history(
                t, x_ref, feet0, feet0, gait, x_des, cfg.N,
                cfg.dynamics_discretization)
            probs.append(_linearized_problem(
                prob, x_des, x_ref, contacts, foot_locs,
                cfg.dynamics_discretization))
        prob_stack = jax.tree_util.tree_map(
            lambda *ls: jnp.stack(ls), *probs)
        # broadcast each schedule to B/n_sched lanes
        reps = B // n_sched
        prob_b = jax.tree_util.tree_map(
            lambda a: jnp.repeat(a, reps, axis=0), prob_stack)

    fz = SPRUNG_MASS * 9.81 / 4.0
    u0 = jnp.zeros((cfg.N - 1, 12), dtype).at[:, 2::3].set(fz)

    rng = np.random.default_rng(3)
    scale = jnp.asarray(
        [.02, .02, .02, .05, .05, .05, .02, .02, .02, .05, .05, .05], dtype)

    def x0s():
        return (x_des[None, :]
                + jnp.asarray(rng.standard_normal((B, 12)), dtype) * scale)

    return dict(prob_b=prob_b, u0=u0, opts=opts, x0s=x0s, cfg=cfg,
                x_des=x_des)


def quadruped_batched(B: int = 1024, rounds: int = 10,
                      linearized_friction: bool = True,
                      compact_cap: int = 0, compact_block: int = 128,
                      grouped: bool = False):
    """Batched quadruped trot-MPC per-solve throughput (table.tex role).

    Instances: 8 contact schedules sampled across one trot cycle x B/8
    initial states (x_des + 2 cm / 0.05 rad-scale noise), solved from the
    reference's warm start (gravity-distributing stance forces, zero
    duals). Each timing round re-perturbs x0.

    ``compact_cap`` > 0 enables device-side straggler compaction: run
    every lane to the cap, gather ``compact_block`` unconverged lanes,
    finish them, scatter, catch-all — identical results, batch wall no
    longer follows the straggler tail.

    ``grouped`` restructures the flat per-lane vmap as vmap(8 schedules)
    over vmap(B/8 lanes): the inner vmap then sees SHARED dynamics, so the
    shared-data kernels engage (per schedule; the outer vmap batches the
    pallas_call by prepending a grid axis) instead of the per-lane-data
    XLA path. The kernels take any batch size, so B only needs to divide
    by the 8 schedules. Its gain on the GPU is not measured yet.
    """
    import altro_mpc as at

    su = quadruped_setup(B, linearized_friction)
    prob_b, u0, opts, x0s = su["prob_b"], su["u0"], su["opts"], su["x0s"]

    if grouped and compact_cap:
        raise ValueError("grouped nested-vmap and straggler compaction "
                         "are mutually exclusive (the compaction gather "
                         "would re-mix schedules into per-lane data)")
    if grouped:
        n_sched = 8
        reps = B // n_sched
        prob_s = jax.tree_util.tree_map(lambda a: a[::reps], prob_b)

        def solve_one_g(prob_k, x0):
            sol = at.solve(prob_k.replace(x0=x0), opts, U0=u0)
            return sol.stats.status, sol.stats.viol, sol.stats.iterations

        jgrouped = jax.jit(jax.vmap(jax.vmap(solve_one_g, in_axes=(None, 0)),
                                    in_axes=(0, 0)))

        def vsolve(pb, x0):
            out = jgrouped(prob_s, x0.reshape(n_sched, reps, -1))
            return jax.tree_util.tree_map(
                lambda a: a.reshape(B, *a.shape[2:]), out)
    elif compact_cap:
        from altro_mpc.solver import altro as _alt

        def partial_one(prob_k, x0):
            p = prob_k.replace(x0=x0)
            return _alt.solve_partial(p, opts, U0=u0, it_cap=compact_cap)

        def resume_one(prob_k, state):
            with jax.default_matmul_precision("highest"):
                return _alt._flat_while(prob_k, opts, state, None)

        def extract_one(prob_k, state):
            sol = _alt._finalize(prob_k, state)
            return sol.stats.status, sol.stats.viol, sol.stats.iterations

        def solve_batch(prob_bb, x0_b):
            states = jax.vmap(partial_one)(prob_bb, x0_b)
            done = states[10]
            take = jnp.argsort(done.astype(jnp.int32),
                               stable=True)[:compact_block]
            subp = jax.tree_util.tree_map(lambda a: a[take], prob_bb)
            sub = jax.tree_util.tree_map(lambda a: a[take], states)
            sub = jax.vmap(resume_one)(subp, sub)
            states = jax.tree_util.tree_map(
                lambda a, b: a.at[take].set(b), states, sub)
            states = jax.vmap(resume_one)(prob_bb, states)  # catch-all
            return jax.vmap(extract_one)(prob_bb, states)

        vsolve = jax.jit(solve_batch)
    else:
        def solve_one(prob_k, x0):
            p = prob_k.replace(x0=x0)
            sol = at.solve(p, opts, U0=u0)
            return sol.stats.status, sol.stats.viol, sol.stats.iterations

        vsolve = jax.jit(jax.vmap(solve_one))

    out = vsolve(prob_b, x0s())
    jax.block_until_ready(out[0])  # compile

    stats = []
    t0 = time.perf_counter()
    for _ in range(rounds):
        out = vsolve(prob_b, x0s())
        stats.append(out)
    jax.block_until_ready(out[0])
    dt = time.perf_counter() - t0
    st = np.concatenate([np.asarray(s[0]) for s in stats])
    vl = np.concatenate([np.asarray(s[1]) for s in stats])
    it = np.concatenate([np.asarray(s[2]) for s in stats])
    mode = "qp" if linearized_friction else "socp"
    res = dict(label=f"quadruped_trot_mpc_N15_{mode}", batch=B,
               rounds=rounds, solves_per_s=round(B * rounds / dt, 1),
               success_rate=float(st.mean()), max_viol=float(np.nanmax(vl)),
               mean_iters=float(it.mean()),
               iters_max=int(it.max()),
               iters_p99=float(np.percentile(it, 99)),
               wall_s=round(dt, 4))
    if compact_cap:
        res["compact_it_cap"] = compact_cap
        res["compact_block"] = compact_block
    if grouped:
        res["grouped"] = True
    print(f"  quadruped[{mode}]: {res['solves_per_s']:.0f} solves/s "
          f"(B={B}, success {res['success_rate']:.4f}, "
          f"viol {res['max_viol']:.1e}, iters {res['mean_iters']:.2f})",
          flush=True)
    return res


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="results_gpu")
    p.add_argument("--batch", type=int,
                   default=int(os.environ.get("BENCH_BATCH", 1024)))
    p.add_argument("--which", default="all",
                   choices=["all", "flexsat", "quadruped"])
    # flexsat straggler compaction: -1 = default (cap 8, block 256, one
    # (8,128) level), 0 = plain vmapped step
    p.add_argument("--flexsat-compact-cap", type=int,
                   default=int(os.environ.get("BENCH_FLEXSAT_CAP", -1)))
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    meta = dict(device=str(jax.devices()[0]), dtype="float32")
    if args.which in ("all", "flexsat"):
        print("== flexsat_batched", flush=True)
        cap = args.flexsat_compact_cap
        kw = (dict(compact_cap=8, compact_block=256,
                   compact_levels=((8, 128),)) if cap == -1
              else dict(compact_cap=cap))
        res = dict(flexsat_batched(B=args.batch, **kw), **meta)
        with open(os.path.join(args.out, "flexsat_batched.json"), "w") as f:
            json.dump(res, f, indent=1)
    if args.which in ("all", "quadruped"):
        print("== quadruped_batched", flush=True)
        rows = {}
        # grouped nested-vmap: the inner vmap sees shared dynamics, so
        # the kernels engage per schedule (the inner batch is B/8
        # lanes/schedule)
        for lin in (True, False):
            r = quadruped_batched(B=args.batch, linearized_friction=lin,
                                  grouped=True)
            rows[r["label"]] = r
        with open(os.path.join(args.out, "quadruped_batched.json"),
                  "w") as f:
            json.dump(dict(rows, **meta), f, indent=1)


if __name__ == "__main__":
    main()
