"""Benchmark sweep drivers — parity with the reference's L5 experiment
scripts (SURVEY.md section 1):

- random-linear horizon / state-dim / control-dim sweeps
  (run_random_linear.jl:109-173)
- rocket tolerance sweep (run_simple_rocket.jl:118-206)
- grasp horizon sweep (grasp_benchmark.jl:16-172)
- flexible-satellite per-step timing (flexible_sat_mpc.jl:242-308)
- quadruped 4-config timing (quadruped_benchmark.jl:1-55)

Each driver runs the warm-started ALTRO MPC loop host-driven (one jitted
step per config — scan-wrapped loops are CPU-only; see CLAUDE.md), times
every step like the reference times every solve, solves the same instances
with the in-framework ADMM baseline in lockstep, and records inf-norm
agreement. Results persist to json + comparison figures.

Run: ``python -m altro_mpc.bench.drivers <benchmark> [--out results/]``
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .harness import benchmark_fn, boxplot_stats, comparison_plot, save_results


def _opts(**kw):
    import altro_mpc as at
    return at.SolverOptions(**kw)


def _zero_x(prob_mpc, conic):
    from altro_mpc.transcribe import to_batch_conic, to_batch_qp
    t = to_batch_conic(prob_mpc) if conic else to_batch_qp(prob_mpc)
    return jnp.zeros(t.num_vars, t.P.dtype)


def _zero_y(prob_mpc, conic):
    from altro_mpc.transcribe import to_batch_conic, to_batch_qp
    t = to_batch_conic(prob_mpc) if conic else to_batch_qp(prob_mpc)
    return jnp.zeros(t.A.shape[0], t.P.dtype)


def host_lockstep(prob_mpc, opts, X_track, U_track, noise, *, conic=False,
                  baseline_eps=1e-6, baseline_eps_rel=None, noise_model=None,
                  constraints_fn=None, time_baseline=True):
    """Host-driven warm-started MPC loop with per-step timing and a lockstep
    ADMM baseline on the identical instances.

    Returns dict with altro_ms [T], baseline_ms [T], err_X/err_U [T],
    iters [T, 2], status [T, 2].
    """
    import altro_mpc as at
    from altro_mpc.costs import retarget_tracking
    from altro_mpc.mpc import (default_noise_model, make_mpc_step,
                               track_window)
    from altro_mpc.solver import admm_conic, admm_qp
    from altro_mpc.transcribe import to_batch_conic, to_batch_qp

    noise_model = noise_model or default_noise_model
    N = prob_mpc.N
    step, init_carry = make_mpc_step(prob_mpc, opts, X_track, U_track,
                                     noise_model, constraints_fn)
    verbose = os.environ.get("ALTRO_BENCH_DEBUG") == "1"
    if verbose:
        print("    [lockstep] compiling step...", flush=True)
    jstep = jax.jit(step)
    carry0 = jax.block_until_ready(jax.jit(init_carry)())
    _ = jax.block_until_ready(jstep(carry0, noise[0]))  # compile
    if verbose:
        print("    [lockstep] step compiled", flush=True)

    # jitted baseline solve on problem data, warm-started from the previous
    # step's primal/dual like the reference warm-starts OSQP/COSMO. With
    # fixed constraints the KKT factor/scalings are set up once and reused
    # (the reference's OSQP setup-once + update! pattern); time-varying
    # constraints refactor per step.
    fixed = constraints_fn is None
    if not fixed:
        # time-varying constraints (grasp/quadruped pattern): per-step A
        # changes, so run the MPC-structured knot ADMM with setup-once
        # scalings + cheap banded refactor (knot_admm.py) instead of a full
        # dense re-setup per step — the reference's OSQP/ECOS baselines are
        # timing-grade, the oracle must be too
        from altro_mpc.solver import knot_admm
        kwork0 = knot_admm.setup(knot_admm.to_knot_qp(prob_mpc))

        def baseline(prob_k, xw, yw):
            kqp = knot_admm.to_knot_qp(prob_k)
            sol = knot_admm.solve(knot_admm.refactor(kwork0, kqp),
                                  eps_abs=baseline_eps,
                                  eps_rel=baseline_eps_rel,
                                  max_iter=20000)
            return sol.X, sol.U, xw, yw, sol.iterations, sol.status
    elif conic:
        work0 = admm_conic.setup(to_batch_conic(prob_mpc))

        def baseline(prob_k, xw, yw):
            data = to_batch_conic(prob_k)
            work = work0.replace(prob=data)
            sol = admm_conic.solve(work, x0=xw, y0=yw, eps_abs=baseline_eps,
                                   eps_rel=baseline_eps_rel)
            X, U = admm_conic.extract_traj(data, sol.x)
            return X, U, sol.x, sol.y, sol.iterations, sol.status
    else:
        work0 = admm_qp.setup(to_batch_qp(prob_mpc))

        def baseline(prob_k, xw, yw):
            data = to_batch_qp(prob_k)
            work = work0.replace(qp=data)
            sol = admm_qp.solve(work, x0=xw, y0=yw, eps_abs=baseline_eps,
                                eps_rel=baseline_eps_rel)
            X, U = admm_qp.extract_traj(data, sol.x)
            return X, U, sol.x, sol.y, sol.iterations, sol.status

    jbaseline = jax.jit(baseline)

    def prob_at(k, x0):
        Xw, Uw = track_window(X_track, U_track, k, N)
        p = prob_mpc.replace(cost=retarget_tracking(prob_mpc.cost, Xw, Uw),
                             x0=x0)
        if constraints_fn is not None:
            p = p.replace(constraints=constraints_fn(k))
        return p

    # compile the baseline once (also produces the initial warm start)
    p0 = prob_at(jnp.asarray(1), carry0[0])
    _, _, xw, yw, _, _ = jax.block_until_ready(jbaseline(
        p0, jnp.zeros_like(_zero_x(prob_mpc, conic)),
        jnp.zeros_like(_zero_y(prob_mpc, conic))))
    if verbose:
        print("    [lockstep] baseline compiled", flush=True)

    jcost = jax.jit(lambda p, X, U: p.cost.total(X, U))

    # inf-norm dynamics violation of the baseline's trajectory
    # (dynamics_violation, simple_rocket.jl:208-216)
    def _dyn_viol(p, X, U):
        X_next = jax.vmap(p.dynamics.step)(X[:-1], U,
                                           jnp.arange(U.shape[0]))
        return jnp.max(jnp.abs(X_next - X[1:]))

    jdyn = jax.jit(_dyn_viol)
    carry = carry0
    rows = dict(altro_ms=[], baseline_ms=[], err_X=[], err_U=[], iters=[],
                status=[], cost_altro=[], cost_baseline=[],
                baseline_dyn_viol=[])
    T = noise.shape[0]
    for t in range(T):
        t0 = time.perf_counter()
        carry, out = jstep(carry, noise[t])
        jax.block_until_ready(out.status)
        rows["altro_ms"].append((time.perf_counter() - t0) * 1e3)

        p_k = prob_at(jnp.asarray(t + 1), out.x0)
        t0 = time.perf_counter()
        Xb, Ub, xw, yw, bit, bstat = jbaseline(p_k, xw, yw)
        jax.block_until_ready(Ub)
        rows["baseline_ms"].append((time.perf_counter() - t0) * 1e3)

        rows["err_X"].append(float(jnp.max(jnp.abs(out.X - Xb))))
        rows["err_U"].append(float(jnp.max(jnp.abs(out.U - Ub))))
        rows["iters"].append([int(out.iters), int(bit)])
        rows["status"].append([int(out.status), int(bstat)])
        # cost-parity oracle: both solutions re-evaluated under one cost
        # (sanity_check_cost / the 3-way cost comparison,
        # rocket_landing_problem.jl:193-209, simple_rocket.jl:194-203)
        rows["cost_altro"].append(float(jcost(p_k, out.X, out.U)))
        rows["cost_baseline"].append(float(jcost(p_k, Xb, Ub)))
        rows["baseline_dyn_viol"].append(float(jdyn(p_k, Xb, Ub)))
    return rows


# ---------------------------------------------------------------------------
# Random linear sweeps
# ---------------------------------------------------------------------------

def _default_dtype():
    return jnp.float64 if jax.default_backend() == "cpu" else jnp.float32


def random_linear_sweep(kind: str = "horizon", T: int = 50,
                        dtype=None, xs=None):
    """kind in {horizon, state_dim, control_dim}
    (run_random_linear.jl:109-156)."""
    from altro_mpc.models import random_linear as rl

    dtype = dtype or _default_dtype()
    sweeps = {
        "horizon": dict(xs=[11, 31, 51, 71, 101],
                        cfg=lambda x: (12, 6, x), seed=1,
                        xlabel="MPC horizon N"),
        "state_dim": dict(xs=[2, 15, 25, 35, 45, 55],
                          cfg=lambda x: (x, 2, 21), seed=10,
                          xlabel="state dimension n"),
        "control_dim": dict(xs=[2, 6, 10, 15, 20, 25],
                            cfg=lambda x: (30, x, 21), seed=15,
                            xlabel="control dimension m"),
    }[kind]
    opts = _opts(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                 gradient_tolerance=1e-4, penalty_initial=1e3,
                 penalty_scaling=100.0, reset_duals=False)

    times: Dict[str, Dict[float, List[float]]] = {"ALTRO": {}, "ADMM-QP": {}}
    errs = {}
    for x in (xs if xs is not None else sweeps["xs"]):
        n, m, N_mpc = sweeps["cfg"](x)
        rng = np.random.default_rng(sweeps["seed"])
        N_track = N_mpc + T + 2
        prob = rl.gen_random_linear(rng, n, m, N_track, dtype=dtype)
        X_track, U_track = rl.gen_trajectory(rng, prob, N_track)
        prob_mpc = rl.gen_tracking_mpc(prob, X_track, U_track, N_mpc)
        noise = jnp.asarray(rng.standard_normal((T, n)), dtype)

        # f32 (accelerator) cannot reach 1e-6 absolute residuals; use the
        # reference's own OSQP tolerance there (eps_abs = eps_rel = 1e-4)
        tight = dtype == jnp.float64
        rows = host_lockstep(prob_mpc, opts, X_track, U_track, noise,
                             baseline_eps=1e-6 if tight else 1e-4,
                             baseline_eps_rel=1e-9 if tight else 1e-4)
        times["ALTRO"][x] = rows["altro_ms"]
        times["ADMM-QP"][x] = rows["baseline_ms"]
        errs[x] = dict(err_X=max(rows["err_X"]), err_U=max(rows["err_U"]),
                       success=float(np.mean([s[0] for s in rows["status"]])))
        print(f"  {sweeps['xlabel']}={x}: ALTRO "
              f"{np.mean(rows['altro_ms']):.3f} ms/step, ADMM-QP "
              f"{np.mean(rows['baseline_ms']):.3f} ms, "
              f"err_U={errs[x]['err_U']:.2e}", flush=True)
    return dict(kind=kind, xlabel=sweeps["xlabel"], times=times, errs=errs)


# ---------------------------------------------------------------------------
# Rocket tolerance sweep
# ---------------------------------------------------------------------------

def rocket_tol_sweep(tols=(1e-2, 1e-4, 1e-6, 1e-8), T: int = 20,
                     N_mpc: int = 21, dtype=jnp.float64):
    """Trajectory error + timing vs solver tolerance
    (run_simple_rocket.jl:146-206 / figures/rocket_solver_tol.tikz)."""
    import altro_mpc as at
    from altro_mpc.models import rocket
    from altro_mpc.mpc import gen_tracking_mpc

    N = 301
    prob = rocket.rocket_problem(N=N, tf=(N - 1) * 0.05, dtype=dtype)
    cold = jax.jit(at.solve)(prob, _opts(
        cost_tolerance=1e-6, gradient_tolerance=1e-8,
        constraint_tolerance=1e-5, penalty_initial=1e-2, penalty_scaling=500.0,
        iterations_outer=40, iterations_inner=100),
        U0=rocket.hover_controls(prob))
    prob_mpc = gen_tracking_mpc(prob, cold.X, cold.U, N_mpc, dt=0.05)
    rng = np.random.default_rng(1)
    noise = jnp.asarray(rng.standard_normal((T, 6)), dtype)

    out = []
    for tol in tols:
        opts = _opts(cost_tolerance=tol, gradient_tolerance=tol * 1e-2,
                     constraint_tolerance=tol, penalty_initial=1e3,
                     penalty_scaling=10.0, reset_duals=False,
                     iterations_outer=40)
        rows = host_lockstep(prob_mpc, opts, cold.X, cold.U, noise,
                             conic=True, baseline_eps=1e-9,
                             noise_model=rocket.rocket_noise_model())
        out.append(dict(tol=tol, err_X=max(rows["err_X"]),
                        err_U=max(rows["err_U"]),
                        altro_ms=float(np.mean(rows["altro_ms"])),
                        baseline_ms=float(np.mean(rows["baseline_ms"])),
                        iters=float(np.mean([i[0] for i in rows["iters"]]))))
        print(f"  tol={tol:g}: err_U={out[-1]['err_U']:.2e} altro "
              f"{out[-1]['altro_ms']:.3f} ms/step conic "
              f"{out[-1]['baseline_ms']:.3f} ms", flush=True)
    return dict(rows=out, cold_iterations=int(cold.stats.iterations))


def rocket_multibaseline_tol(tols=(1e-2, 1e-4, 1e-6, 1e-8), T: int = 10,
                             N_mpc: int = 21, dtype=jnp.float64):
    """Four-solver tolerance study (the reference's headline rocket figure:
    ALTRO vs ECOS vs COSMO vs Mosek at matched tolerances,
    run_simple_rocket.jl:146-201 / figures/rocket_solver_tol.tikz).

    Solver roles here: conic AL-iLQR (ALTRO), dense conic ADMM
    (SCS/COSMO-form splitting), MPC-structured knot ADMM, and the native
    C++ conic oracle (the one non-JAX implementation). For each tolerance
    the ALTRO closed loop defines the instance sequence; every baseline
    solves the identical instances at the same eps, and every solver's
    control error is measured against an independent tight solve (native
    C++ at 1e-9) of the same instance."""
    import altro_mpc as at
    from altro_mpc import native
    from altro_mpc.costs import retarget_tracking
    from altro_mpc.models import rocket
    from altro_mpc.mpc import (gen_tracking_mpc, make_mpc_step,
                               track_window)
    from altro_mpc.solver import admm_conic, knot_admm
    from altro_mpc.transcribe import to_batch_conic

    N = 301
    prob = rocket.rocket_problem(N=N, tf=(N - 1) * 0.05, dtype=dtype)
    cold = jax.jit(at.solve)(prob, _opts(
        cost_tolerance=1e-6, gradient_tolerance=1e-8,
        constraint_tolerance=1e-5, penalty_initial=1e-2, penalty_scaling=500.0,
        iterations_outer=40, iterations_inner=100),
        U0=rocket.hover_controls(prob))
    prob_mpc = gen_tracking_mpc(prob, cold.X, cold.U, N_mpc, dt=0.05)
    rng = np.random.default_rng(1)
    noise = jnp.asarray(rng.standard_normal((T, 6)), dtype)
    nm = rocket.rocket_noise_model()

    conic0 = to_batch_conic(prob_mpc)
    cwork0 = admm_conic.setup(conic0)
    kwork0 = knot_admm.setup(knot_admm.to_knot_qp(prob_mpc))

    def prob_at(k, x0):
        Xw, Uw = track_window(cold.X, cold.U, k, N_mpc)
        return prob_mpc.replace(
            cost=retarget_tracking(prob_mpc.cost, Xw, Uw), x0=x0)

    def dense_solve(prob_k, eps):
        data = to_batch_conic(prob_k)
        sol = admm_conic.solve(cwork0.replace(prob=data), eps_abs=eps,
                               max_iter=100000)
        X, U = admm_conic.extract_traj(data, sol.x)
        return U, sol.status

    def knot_solve(prob_k, eps):
        kqp = knot_admm.to_knot_qp(prob_k)
        sol = knot_admm.solve(knot_admm.refactor(kwork0, kqp), eps_abs=eps,
                              max_iter=20000)
        return sol.U, sol.status

    jdense = jax.jit(dense_solve, static_argnums=1)
    jknot = jax.jit(knot_solve, static_argnums=1)

    def native_solve(prob_k, eps):
        data = to_batch_conic(prob_k)
        sol = native.solve_conic(
            np.asarray(data.P), np.asarray(data.q), np.asarray(data.A),
            np.asarray(data.b), data.segments, eps_abs=eps, max_iter=300000)
        X, U = admm_conic.extract_traj(data, jnp.asarray(sol.x))
        return np.asarray(U), sol.status

    out = []
    for tol in tols:
        opts = _opts(cost_tolerance=tol, gradient_tolerance=tol * 1e-2,
                     constraint_tolerance=tol, penalty_initial=1e3,
                     penalty_scaling=10.0, reset_duals=False,
                     iterations_outer=40)
        step, init_carry = make_mpc_step(prob_mpc, opts, cold.X, cold.U, nm)
        jstep = jax.jit(step)
        carry = jax.block_until_ready(jax.jit(init_carry)())
        jax.block_until_ready(jstep(carry, noise[0]))  # compile

        errs = {"altro": [], "dense_admm": [], "knot_admm": [],
                "native_cpp": []}
        ms = {k: [] for k in errs}
        sts = {k: [] for k in errs}
        for t in range(T):
            t0 = time.perf_counter()
            carry, res = jstep(carry, noise[t])
            jax.block_until_ready(res.U)
            ms["altro"].append((time.perf_counter() - t0) * 1e3)
            sts["altro"].append(int(res.status))
            prob_k = prob_at(int(carry[4]), res.x0)

            U_truth, st_truth = native_solve(prob_k, 1e-9)
            assert st_truth == 1, "truth solve did not converge"

            errs["altro"].append(
                float(jnp.max(jnp.abs(res.U - U_truth))))
            for name, fn in (("dense_admm", jdense), ("knot_admm", jknot)):
                t0 = time.perf_counter()
                U_b, st = fn(prob_k, tol)
                jax.block_until_ready(U_b)
                ms[name].append((time.perf_counter() - t0) * 1e3)
                errs[name].append(float(jnp.max(jnp.abs(U_b - U_truth))))
                sts[name].append(int(st))
            t0 = time.perf_counter()
            U_n, st = native_solve(prob_k, tol)
            ms["native_cpp"].append((time.perf_counter() - t0) * 1e3)
            errs["native_cpp"].append(float(np.max(np.abs(U_n - U_truth))))
            sts["native_cpp"].append(int(st))

        row = dict(tol=tol)
        for k in errs:
            row[f"err_{k}"] = max(errs[k])
            row[f"ms_{k}"] = float(np.mean(ms[k]))
            row[f"success_{k}"] = float(np.mean(sts[k]))
        out.append(row)
        print(f"  tol={tol:g}: " + " ".join(
            f"{k}={row[f'err_{k}']:.2e}/{row[f'ms_{k}']:.1f}ms"
            for k in errs), flush=True)
    return dict(rows=out, cold_iterations=int(cold.stats.iterations))


# ---------------------------------------------------------------------------
# Grasp horizon sweep
# ---------------------------------------------------------------------------

def grasp_horizon_sweep(Ns=(11, 21, 31, 41, 51), T: int = 15,
                        dtype=jnp.float64):
    """(grasp_benchmark.jl:16-172)"""
    import altro_mpc as at
    from altro_mpc.models import grasp
    from altro_mpc.mpc import gen_tracking_mpc

    # reference cold solve: N=251 knots over the same 6 s
    # (grasp_benchmark.jl:72 "GraspProblem(o,251)" with the tf=6.0 default)
    N, tf = 251, 6.0
    o = grasp.make_grasp_object(N, tf, dtype=dtype)
    prob = grasp.grasp_problem(o, N, tf, dtype=dtype)
    cold = jax.jit(at.solve)(prob, _opts(
        cost_tolerance=1e-6, gradient_tolerance=1e-8,
        constraint_tolerance=1e-6, penalty_initial=10.0, penalty_scaling=10.0,
        iterations_outer=30, iterations_inner=50),
        U0=grasp.hover_controls(o, N, dtype=dtype))
    opts = _opts(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                 penalty_initial=1e4, penalty_scaling=100.0, reset_duals=False)

    times = {"ALTRO": {}, "ADMM-Conic": {}}
    errs = {}
    rng = np.random.default_rng(0)
    for N_mpc in Ns:
        prob_mpc = gen_tracking_mpc(prob, cold.X, cold.U, N_mpc, Qk=1e3,
                                    Rk=1.0, Qfk=10.0, dt=tf / (N - 1))
        prob_mpc = prob_mpc.replace(
            constraints=grasp.grasp_constraints(o, N_mpc, 0, dtype=dtype))
        fn = lambda k, N_mpc=N_mpc: grasp.grasp_constraints(o, N_mpc, k,
                                                            dtype=dtype)
        noise = jnp.asarray(rng.standard_normal((T, 6)), dtype)
        rows = host_lockstep(prob_mpc, opts, cold.X, cold.U, noise,
                             conic=True, baseline_eps=1e-7,
                             constraints_fn=fn)
        times["ALTRO"][N_mpc] = rows["altro_ms"]
        times["ADMM-Conic"][N_mpc] = rows["baseline_ms"]
        # cost-parity gap contextualizes err_U: at tolerance 1e-4 with the
        # N=251 reference's fine dt the control curvature R*dt is small, so
        # a dJ-level-optimal pair can disagree by ~sqrt(2 dJ / (R dt)) in
        # forces while both are optimal to ~1e-3 in cost (the reference's
        # own convergence-study caveat, run_simple_rocket.jl:146-206)
        cost_gap = max(abs(a - b) / max(abs(a), 1.0)
                       for a, b in zip(rows["cost_altro"],
                                       rows["cost_baseline"]))
        errs[N_mpc] = dict(err_U=max(rows["err_U"]),
                           cost_parity_gap=cost_gap,
                           success=float(np.mean([s[0] for s in rows["status"]])))
        print(f"  N={N_mpc}: ALTRO {np.mean(rows['altro_ms']):.3f} ms/step, "
              f"conic {np.mean(rows['baseline_ms']):.3f} ms, "
              f"err_U={errs[N_mpc]['err_U']:.2e}, "
              f"cost_gap={cost_gap:.2e}", flush=True)
    return dict(times=times, errs=errs, xlabel="MPC horizon N")


def grasp_multibaseline_tol(tols=(1e-2, 1e-4, 1e-6, 1e-8), T: int = 10,
                            N_mpc: int = 21, dtype=jnp.float64):
    """Grasp counterpart of :func:`rocket_multibaseline_tol`: the same
    four-solver error-vs-tolerance study on one grasp MPC horizon (the
    reference drives ECOS/COSMO/Mosek on the grasp sweep,
    grasp_benchmark.jl:36-62; this is the multi-baseline treatment at
    N_mpc=21 with the reference's tracking weights).

    The grasp instances carry TIME-VARYING constraint stacks (the contact
    frames rotate each MPC step, grasp_mpc_helpers.jl:46-55), so every
    baseline re-ingests the rotated constraint data per step: the dense
    conic ADMM refactors its KKT, the knot ADMM refreshes through its
    banded refactor, and the native C++ oracle re-reads the batch data.
    Error reference: an independent native C++ solve at 1e-9 per instance."""
    import altro_mpc as at
    from altro_mpc import native
    from altro_mpc.costs import retarget_tracking
    from altro_mpc.models import grasp
    from altro_mpc.mpc import (gen_tracking_mpc, make_mpc_step,
                               track_window)
    from altro_mpc.solver import admm_conic, knot_admm
    from altro_mpc.transcribe import to_batch_conic

    N, tf = 251, 6.0
    o = grasp.make_grasp_object(N, tf, dtype=dtype)
    prob = grasp.grasp_problem(o, N, tf, dtype=dtype)
    cold = jax.jit(at.solve)(prob, _opts(
        cost_tolerance=1e-6, gradient_tolerance=1e-8,
        constraint_tolerance=1e-6, penalty_initial=10.0, penalty_scaling=10.0,
        iterations_outer=30, iterations_inner=50),
        U0=grasp.hover_controls(o, N, dtype=dtype))
    prob_mpc = gen_tracking_mpc(prob, cold.X, cold.U, N_mpc, Qk=1e3,
                                Rk=1.0, Qfk=10.0, dt=tf / (N - 1))
    prob_mpc = prob_mpc.replace(
        constraints=grasp.grasp_constraints(o, N_mpc, 0, dtype=dtype))
    cons_fn = lambda k: grasp.grasp_constraints(o, N_mpc, k, dtype=dtype)
    rng = np.random.default_rng(1)
    noise = jnp.asarray(rng.standard_normal((T, 6)), dtype)

    cwork0 = admm_conic.setup(to_batch_conic(prob_mpc))
    kwork0 = knot_admm.setup(knot_admm.to_knot_qp(prob_mpc))

    def prob_at(k, x0):
        Xw, Uw = track_window(cold.X, cold.U, k, N_mpc)
        return prob_mpc.replace(
            cost=retarget_tracking(prob_mpc.cost, Xw, Uw), x0=x0,
            constraints=cons_fn(k))

    def dense_solve(prob_k, eps):
        data = to_batch_conic(prob_k)
        sol = admm_conic.solve(admm_conic.refactor(cwork0, data),
                               eps_abs=eps, max_iter=100000)
        X, U = admm_conic.extract_traj(data, sol.x)
        return U, sol.status

    def knot_solve(prob_k, eps):
        kqp = knot_admm.to_knot_qp(prob_k)
        sol = knot_admm.solve(knot_admm.refactor(kwork0, kqp), eps_abs=eps,
                              max_iter=20000)
        return sol.U, sol.status

    jdense = jax.jit(dense_solve, static_argnums=1)
    jknot = jax.jit(knot_solve, static_argnums=1)

    def native_solve(prob_k, eps):
        data = to_batch_conic(prob_k)
        sol = native.solve_conic(
            np.asarray(data.P), np.asarray(data.q), np.asarray(data.A),
            np.asarray(data.b), data.segments, eps_abs=eps, max_iter=300000)
        X, U = admm_conic.extract_traj(data, jnp.asarray(sol.x))
        return np.asarray(U), sol.status

    out = []
    for tol in tols:
        opts = _opts(cost_tolerance=tol, gradient_tolerance=tol * 1e-2,
                     constraint_tolerance=tol, penalty_initial=1e4,
                     penalty_scaling=100.0, reset_duals=False,
                     iterations_outer=40)
        step, init_carry = make_mpc_step(prob_mpc, opts, cold.X, cold.U,
                                         constraints_fn=cons_fn)
        jstep = jax.jit(step)
        carry = jax.block_until_ready(jax.jit(init_carry)())
        jax.block_until_ready(jstep(carry, noise[0]))  # compile

        errs = {"altro": [], "dense_admm": [], "knot_admm": [],
                "native_cpp": []}
        ms = {k: [] for k in errs}
        sts = {k: [] for k in errs}
        for t in range(T):
            t0 = time.perf_counter()
            carry, res = jstep(carry, noise[t])
            jax.block_until_ready(res.U)
            ms["altro"].append((time.perf_counter() - t0) * 1e3)
            sts["altro"].append(int(res.status))
            prob_k = prob_at(int(carry[4]), res.x0)

            U_truth, st_truth = native_solve(prob_k, 1e-9)
            assert st_truth == 1, "truth solve did not converge"

            errs["altro"].append(
                float(jnp.max(jnp.abs(res.U - U_truth))))
            for name, fn in (("dense_admm", jdense), ("knot_admm", jknot)):
                t0 = time.perf_counter()
                U_b, st = fn(prob_k, tol)
                jax.block_until_ready(U_b)
                ms[name].append((time.perf_counter() - t0) * 1e3)
                errs[name].append(float(jnp.max(jnp.abs(U_b - U_truth))))
                sts[name].append(int(st))
            t0 = time.perf_counter()
            U_n, st = native_solve(prob_k, tol)
            ms["native_cpp"].append((time.perf_counter() - t0) * 1e3)
            errs["native_cpp"].append(float(np.max(np.abs(U_n - U_truth))))
            sts["native_cpp"].append(int(st))

        row = dict(tol=tol)
        for k in errs:
            row[f"err_{k}"] = max(errs[k])
            row[f"ms_{k}"] = float(np.mean(ms[k]))
            row[f"success_{k}"] = float(np.mean(sts[k]))
        out.append(row)
        print(f"  tol={tol:g}: " + " ".join(
            f"{k}={row[f'err_{k}']:.2e}/{row[f'ms_{k}']:.1f}ms"
            for k in errs), flush=True)
    return dict(rows=out, cold_iterations=int(cold.stats.iterations))


# ---------------------------------------------------------------------------
# Flexible satellite
# ---------------------------------------------------------------------------

def flexsat_benchmark(T: int = 45, trials: int = 10, dtype=jnp.float64):
    """(flexible_sat_mpc.jl:242-308): per-MPC-step solve times, regulator
    loop (no shifting), both solvers."""
    import altro_mpc as at
    from altro_mpc.models import flexible_satellite as fs
    from altro_mpc.solver import admm_qp
    from altro_mpc.transcribe import to_batch_qp

    prob = fs.flexsat_problem(dtype=dtype)
    opts = _opts(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                 penalty_initial=100.0, penalty_scaling=100.0)

    # jitted single regulator step (propagate + resolve, warm primals)
    def astep(x0, U, duals, noise_i):
        x0n = prob.dynamics.step(x0, U[0], 0) + 2e-4 * noise_i
        sol = at.solve(prob.replace(x0=x0n), opts, U0=U, duals=duals)
        return x0n, sol.U, sol.duals, sol.stats.iterations, sol.stats.status

    jastep = jax.jit(astep)

    work0 = admm_qp.setup(to_batch_qp(prob))

    def qstep(x0):
        from altro_mpc.transcribe import qp_set_x0
        work = admm_qp.update(work0)
        qp = qp_set_x0(work.qp, x0)
        sol = admm_qp.solve(work.replace(qp=qp), eps_abs=1e-4)
        return sol.iterations, sol.status

    jqstep = jax.jit(qstep)

    altro_mat = np.zeros((T, trials))
    osqp_mat = np.zeros((T, trials))
    for trial in range(trials):
        rng = np.random.default_rng(trial)
        sol0 = jax.jit(at.solve)(prob, opts)
        x0, U, duals = prob.x0, sol0.U, sol0.duals
        for t in range(T):
            nz = jnp.asarray(rng.standard_normal(prob.n), dtype)
            t0 = time.perf_counter()
            x0, U, duals, it, st = jastep(x0, U, duals, nz)
            jax.block_until_ready(st)
            altro_mat[t, trial] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            qi, qs = jqstep(x0)
            jax.block_until_ready(qs)
            osqp_mat[t, trial] = (time.perf_counter() - t0) * 1e3
        print(f"  trial {trial}: altro median "
              f"{np.median(altro_mat[:, trial]):.3f} ms, qp "
              f"{np.median(osqp_mat[:, trial]):.3f} ms", flush=True)
    return dict(altro_ms=altro_mat.tolist(), qp_ms=osqp_mat.tolist(),
                altro_median_per_step=np.median(altro_mat, axis=1).tolist(),
                qp_median_per_step=np.median(osqp_mat, axis=1).tolist())


# ---------------------------------------------------------------------------
# Quadruped
# ---------------------------------------------------------------------------

def quadruped_benchmark(tf: float = 2.0, dtype=jnp.float64):
    """Four configs: ALTRO-QP, ADMM-QP (OSQP role), ALTRO-SOCP,
    ADMM-Conic (ECOS role) (quadruped_benchmark.jl:1-55). Host-driven
    closed loop on the SRB plant timing the MPC SOLVE separately from the
    1 kHz sim ticks — apples-to-apples with the reference's solver-only
    table (plots/table.tex; it records stats.tsolve / info.solve_time).
    The ADMM baselines run the reference's setup-once + refactor +
    shifted-warm-start pattern (OSQPParams.jl:127-162)."""
    import altro_mpc as at
    from altro_mpc.models.quadruped import config, controller

    opts = _opts(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                 penalty_initial=10.0, penalty_scaling=100.0,
                 reset_duals=False)
    rows = {}
    for name, lin, backend in (
            ("ALTRO-QP", True, "altro"),
            ("OSQP-role", True, "admm_qp"),
            ("ALTRO-SOCP", False, "altro"),
            ("ECOS-role", False, "admm_conic")):
        cfg = config.MPCConfig(linearized_friction=lin)
        res = controller.simulate_host(cfg, opts, tf=tf, backend=backend,
                                       dtype=dtype)
        status = np.asarray(res["status"])
        mpc_ms = np.asarray(res["mpc_ms"])
        prep_ms = np.asarray(res["prep_ms"])
        rows[name] = dict(
            # solver-internal wall — the reference table's accounting
            # (stats.tsolve / info.solve_time; see simulate_host docstring)
            ms_per_solve=float(np.mean(mpc_ms)),
            ms_per_solve_std=float(np.std(mpc_ms)),
            # everything else in the MPC period (relinearize, transcribe,
            # workspace update+refactor) — untimed by the reference
            ms_prep=float(np.mean(prep_ms)),
            ms_per_solve_total=float(np.mean(mpc_ms) + np.mean(prep_ms)),
            ms_per_period_sim=float(np.mean(res["tick_ms"])),
            mean_iters=float(np.mean(np.asarray(res["iters"]))),
            success=float(status.mean()),
            mpc_ms=mpc_ms.tolist(),
            prep_ms=prep_ms.tolist())
        print(f"  {name}: {rows[name]['ms_per_solve']:.3f} ± "
              f"{rows[name]['ms_per_solve_std']:.3f} ms/solve "
              f"(+{rows[name]['ms_prep']:.3f} prep), "
              f"{rows[name]['mean_iters']:.1f} iters "
              f"(success {rows[name]['success']:.2f})", flush=True)

    # results table (plots/create_figures.jl + table.tex analog)
    lines = ["| configuration | ms/solve | σ | +prep | success |",
             "|---|---|---|---|---|"]
    for k, v in rows.items():
        lines.append(f"| {k} | {v['ms_per_solve']:.3f} | "
                     f"{v['ms_per_solve_std']:.3f} | {v['ms_prep']:.3f} | "
                     f"{v['success']:.2f} |")
    rows["table_md"] = "\n".join(lines)
    print("\n".join(lines), flush=True)
    return rows


BENCHMARKS = {
    "random_linear_horizon": lambda: random_linear_sweep("horizon"),
    "random_linear_state_dim": lambda: random_linear_sweep("state_dim"),
    "random_linear_control_dim": lambda: random_linear_sweep("control_dim"),
    "rocket": rocket_tol_sweep,
    "rocket_multibaseline": rocket_multibaseline_tol,
    "grasp": grasp_horizon_sweep,
    "grasp_multibaseline": grasp_multibaseline_tol,
    "flexsat": flexsat_benchmark,
    "quadruped": quadruped_benchmark,
}


# ---------------------------------------------------------------------------
# Figures (the committed-figure parity set: figures/*.tikz analogs)
# ---------------------------------------------------------------------------

def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _fig_rocket(res, path):
    """Trajectory error + solve time vs solver tolerance
    (figures/rocket_solver_tol.tikz + rocket_tol_comp.tikz analog)."""
    plt = _mpl()
    rows = res["rows"]
    tols = [r["tol"] for r in rows]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 3.6))
    ax1.loglog(tols, [r["err_U"] for r in rows], "o-", color="tab:red",
               label="ALTRO vs conic-ADMM (1e-9)")
    ax1.set_xlabel("ALTRO optimality tolerance")
    ax1.set_ylabel("inf-norm control error")
    ax1.invert_xaxis()
    ax1.grid(True, alpha=0.3)
    ax1.legend(fontsize=8)
    ax2.semilogx(tols, [r["altro_ms"] for r in rows], "o-", color="tab:red",
                 label="ALTRO")
    ax2.semilogx(tols, [r["baseline_ms"] for r in rows], "s-",
                 color="tab:cyan", label="conic ADMM (ECOS role)")
    ax2.set_xlabel("ALTRO optimality tolerance")
    ax2.set_ylabel("time per MPC step (ms)")
    ax2.invert_xaxis()
    ax2.grid(True, alpha=0.3)
    ax2.legend(fontsize=8)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def _fig_flexsat(res, path):
    """Per-MPC-step solve-time medians, step 1..45
    (figures/flexible_sat_comp.tikz analog: red=ALTRO, blue=OSQP role)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 4))
    a = res["altro_median_per_step"]
    q = res["qp_median_per_step"]
    steps = np.arange(1, len(a) + 1)
    am = np.asarray(res["altro_ms"])      # [T, trials]
    qm = np.asarray(res["qp_ms"])
    for t in range(am.shape[1]):
        ax.plot(steps, am[:, t], color="tab:red", alpha=0.15, lw=0.6)
        ax.plot(steps, qm[:, t], color="tab:blue", alpha=0.15, lw=0.6)
    ax.plot(steps, a, color="tab:red", lw=2, label="ALTRO (median)")
    ax.plot(steps, q, color="tab:blue", lw=2, label="ADMM-QP (median)")
    ax.set_xlabel("MPC step")
    ax.set_ylabel("solve time (ms)")
    ax.set_yscale("log")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def _fig_quadruped(res, path):
    """Per-config solve-time bars with std whiskers
    (figures/quadruped_times.tikz + plots/table.tex analog)."""
    plt = _mpl()
    names = [k for k in res if isinstance(res[k], dict)
             and "ms_per_solve" in res[k]]
    means = [res[k]["ms_per_solve"] for k in names]
    stds = [res[k].get("ms_per_solve_std", 0.0) for k in names]
    colors = ["tab:red", "tab:blue", "tab:red", "tab:cyan"]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(range(len(names)), means, yerr=stds, capsize=4,
           color=colors[:len(names)], alpha=0.8)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=15)
    ax.set_ylabel("MPC solve time (ms)")
    ax.grid(True, axis="y", alpha=0.3)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def _fig_rocket_multibaseline(res, path):
    """Four-solver error + time vs tolerance — the reference's headline
    contrast (figures/rocket_solver_tol.tikz: ALTRO vs ECOS/COSMO/Mosek)."""
    plt = _mpl()
    rows = res["rows"]
    tols = [r["tol"] for r in rows]
    solvers = [("altro", "tab:red", "o", "conic AL-iLQR (ALTRO)"),
               ("dense_admm", "tab:cyan", "s", "dense conic ADMM"),
               ("knot_admm", "tab:blue", "^", "knot ADMM (MPC-structured)"),
               ("native_cpp", "tab:green", "d", "native C++ conic")]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9.5, 3.6))
    for key, color, mk, label in solvers:
        ax1.loglog(tols, [max(r[f"err_{key}"], 1e-12) for r in rows],
                   mk + "-", color=color, label=label)
        ax2.semilogx(tols, [r[f"ms_{key}"] for r in rows], mk + "-",
                     color=color, label=label)
    ax1.set_xlabel("solver tolerance")
    ax1.set_ylabel("inf-norm control error vs tight oracle")
    ax1.invert_xaxis()
    ax1.grid(True, alpha=0.3)
    ax1.legend(fontsize=7)
    ax2.set_xlabel("solver tolerance")
    ax2.set_ylabel("time per solve (ms)")
    ax2.set_yscale("log")
    ax2.invert_xaxis()
    ax2.grid(True, alpha=0.3)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


FIGURES = {
    "rocket": _fig_rocket,
    "rocket_multibaseline": _fig_rocket_multibaseline,
    "grasp_multibaseline": _fig_rocket_multibaseline,
    "flexsat": _fig_flexsat,
    "quadruped": _fig_quadruped,
}


def main():
    from ..utils.runtime import enable_compile_cache

    enable_compile_cache()
    if jax.default_backend() == "cpu":
        # the CPU sweeps are f64 oracles; without this the f64 requests are
        # silently truncated to f32 (and warn on every constraint build)
        jax.config.update("jax_enable_x64", True)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("benchmark", choices=list(BENCHMARKS) + ["all"])
    p.add_argument("--out", default="results")
    p.add_argument("--plot-only", action="store_true",
                   help="re-emit figures from saved json without re-running "
                        "(the reference's JLD2-replay plotting workflow)")
    args = p.parse_args()
    names = list(BENCHMARKS) if args.benchmark == "all" else [args.benchmark]
    for name in names:
        path = os.path.join(args.out, f"{name}.json")
        if args.plot_only:
            from .harness import load_results
            res = load_results(path)
        else:
            print(f"== {name}", flush=True)
            res = BENCHMARKS[name]()
            save_results(path, res)
        try:
            if isinstance(res, dict) and "times" in res:
                times = {s: {float(x): v for x, v in series.items()}
                         for s, series in res["times"].items()}
                comparison_plot(times, res.get("xlabel", "sweep"),
                                os.path.join("figures", f"{name}.png"))
            if name in FIGURES:
                FIGURES[name](res, os.path.join("figures", f"{name}.png"))
        except Exception as e:  # plotting is best-effort
            print(f"  (plot skipped: {e})", flush=True)


if __name__ == "__main__":
    main()
