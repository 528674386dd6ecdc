"""Batched GPU throughput for the CONIC (SOC) benchmarks.

The flagship bench.py measures the random-linear QP config; ALTRO-C's
subject is SOC-constrained MPC (rocket thrust/angle/glideslope cones,
rocket_landing_problem.jl:119-167; grasp time-varying friction cones,
grasp_problem.jl:60-95). This driver applies the same methodology — a
jitted vmapped warm-started MPC step, host-driven with pipelined dispatch —
to those two conic configs at B scenarios in f32 and reports solves/s,
success and max violation.

Run on the GPU: ``python -m altro_mpc.bench.batched_conic [--out results_gpu]``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

import jax
import jax.numpy as jnp


def _throughput(step, init_carry, noise, label, batch_step=None):
    """bench.py methodology: compile, pipelined throughput pass, fenced
    latency pass. Pass ``batch_step`` (a whole-batch step function, e.g.
    from mpc.make_mpc_step_device_compacted) to run it INSTEAD of the
    vmapped per-lane ``step`` — the throughput/latency passes then measure
    the device-side straggler-compacted program."""
    B = noise.shape[1]
    T = noise.shape[0]
    if batch_step is not None:
        vstep = jax.jit(batch_step)
    else:
        vstep = jax.jit(jax.vmap(step, in_axes=(0, 0, None)))
    ks = [jnp.asarray(t, jnp.int32) for t in range(T)]
    carry0 = jax.block_until_ready(
        jax.jit(jax.vmap(lambda _: init_carry()))(jnp.arange(B)))
    t0 = time.perf_counter()
    carry, out = vstep(carry0, noise[0], ks[0])
    jax.block_until_ready(carry)
    compile_s = time.perf_counter() - t0

    carry = carry0
    statuses, viols, iters = [], [], []
    t0 = time.perf_counter()
    for t in range(T):
        carry, out = vstep(carry, noise[t], ks[t])
        statuses.append(out.status)
        viols.append(out.viol)
        iters.append(out.iters)
    jax.block_until_ready(carry)
    dt = time.perf_counter() - t0

    step_ms = []
    carry_l = carry0
    for t in range(min(T, 10)):
        ts = time.perf_counter()
        carry_l, out_l = vstep(carry_l, noise[t], ks[t])
        jax.block_until_ready(out_l.status)
        step_ms.append((time.perf_counter() - ts) * 1e3)

    solves = B * T
    res = dict(
        label=label,
        batch=B, steps=T,
        solves_per_s=round(solves / dt, 1),
        success_rate=float(jnp.mean(jnp.stack(statuses).astype(jnp.float32))),
        max_viol=float(jnp.max(jnp.stack(viols))),
        mean_iters=float(jnp.mean(jnp.stack(iters).astype(jnp.float32))),
        # the batched while-loop runs to the SLOWEST lane: the per-step
        # lane-max (and its mean over steps) is the number wall time
        # actually follows, not the lane mean
        iters_max=int(jnp.max(jnp.stack(iters))),
        iters_max_per_step_mean=float(jnp.mean(jnp.stack(
            [jnp.max(i) for i in iters]).astype(jnp.float32))),
        iters_p50=float(np.percentile(np.asarray(jnp.stack(iters)), 50)),
        iters_p90=float(np.percentile(np.asarray(jnp.stack(iters)), 90)),
        iters_p95=float(np.percentile(np.asarray(jnp.stack(iters)), 95)),
        iters_p99=float(np.percentile(
            np.asarray(jnp.stack(iters)), 99)),
        wall_s=round(dt, 4),
        compile_s=round(compile_s, 1),
        step_ms_p50=float(np.percentile(step_ms, 50)),
        step_ms_p99=float(np.percentile(step_ms, 99)),
    )
    print(f"  {label}: {res['solves_per_s']:.0f} solves/s "
          f"(B={B}, success {res['success_rate']:.4f}, "
          f"max_viol {res['max_viol']:.2e}, iters {res['mean_iters']:.2f} "
          f"mean / {res['iters_max_per_step_mean']:.1f} lane-max "
          f"/ {res['iters_max']} max)",
          flush=True)
    return res


def rocket_setup(dtype=None, N_mpc: int = 21, opts_override: dict = None,
                 track=None, warm_start: str = "track"):
    """Shared rocket MPC-bench construction (problem, warm-solve options,
    tracking reference) used by both :func:`rocket_batched` and the conic
    agreement artifact (bench/agreement_conic.py) so the two always measure
    the IDENTICAL configuration. ``track=(X, U)`` skips the cold solve and
    tracks the given trajectory (agreement phase2 re-uses phase1's f32 cold
    reference so f32-GPU and f64-CPU solve the same window targets)."""
    import altro_mpc as at
    from altro_mpc.models import rocket
    from altro_mpc.mpc import gen_tracking_mpc

    dtype = dtype or jnp.float32
    N = 301
    prob = rocket.rocket_problem(N=N, tf=(N - 1) * 0.05, dtype=dtype)
    cold_status = None
    if track is None:
        cold_opts = at.SolverOptions(
            cost_tolerance=1e-5, gradient_tolerance=1e-6,
            constraint_tolerance=1e-4, penalty_initial=1e-2,
            penalty_scaling=500.0, iterations_outer=40,
            iterations_inner=100)
        print(f"  cold solve (N=301, {jnp.dtype(dtype).name})...",
              flush=True)
        cold = jax.jit(at.solve)(prob, cold_opts,
                                 U0=rocket.hover_controls(prob))
        jax.block_until_ready(cold.X)
        cold_status = int(cold.stats.status)
        print(f"  cold: status={cold_status} "
              f"viol={float(cold.stats.viol):.2e}", flush=True)
        track = (cold.X, cold.U)
    X_track, U_track = track

    prob_mpc = gen_tracking_mpc(prob, X_track, U_track, N_mpc, dt=0.05)
    # Warm-solve config (tuned on an earlier accelerator at B=1024; the
    # throughput side is to be re-measured on the GPU, the quality side is
    # algorithmic):
    # - warm_start="track": every solve is seeded from the tracking
    #   window's controls with fresh duals. Under the SHIFTED-control warm
    #   start, 1-3 knife-edge lanes per 1024 stall at feasible points up to
    #   2.5x the optimal cost at any tolerance; fresh duals alone do not fix
    #   it, seeding from the tracking controls does.
    # - penalties RESET each solve at 1e2 (the reference's own pattern —
    #   ALTRO.jl resets; run_simple_rocket.jl:121-129 uses reset @ 1e3).
    #   Carrying converged penalties is faster but LOCKS the solution to
    #   the warm start: with stale rho up to 1e8 the warm start is
    #   feasible, one exact Newton step "converges", and the controls sit
    #   far from the true optimum.
    # - cost_tolerance=1e-6 with the classical inner loop (inner 50,
    #   reg_min 1e-8, no early-exact stop): at 1e-4 a few lanes in a
    #   thousand wander through a high-rho transient to a REMOTE feasible
    #   point and declare cost-convergence there.
    # - iterations_outer=15: at 10, about 1 lane in 10k ends mid-recovery
    #   from a high-rho f32 transient with a NaN violation.
    # - iterations_linesearch=5: solution quality degrades as the ladder
    #   shortens (high-penalty rounds occasionally need alpha ~ 0.06);
    #   L=5 is the measured sweet spot between rung cost and quality.
    # The residual worst-lane tail is an extreme-value statistic of f32
    # knife-edge lanes: at window 10, B=1024, three bit-different compiles
    # on an H100 put 1-2% of lanes above 1e-2 relative cost excess over
    # the f64 optimum and the worst at 0.16-0.46, with medians <= 3e-7.
    okw = dict(
        cost_tolerance=1e-6, gradient_tolerance=1e-6,
        constraint_tolerance=1e-4, penalty_initial=1e2,
        penalty_scaling=10.0, reset_duals=True, reset_penalties=True,
        iterations_outer=15, iterations_inner=50, reg_min=1e-8,
        early_exact_tol=0.0, iterations_linesearch=5)
    okw.update(opts_override or {})
    opts = at.SolverOptions(**okw)
    from altro_mpc.models import rocket as _rocket
    return dict(prob_mpc=prob_mpc, opts=opts, X_track=X_track,
                U_track=U_track, constraints_fn=None,
                noise_model=_rocket.rocket_noise_model(), noise_dim=6,
                cold_status=cold_status, warm_start=warm_start)


def rocket_batched(B: int = 1024, T: int = 30, N_mpc: int = 21,
                   opts_override: dict = None, compact_cap: int = 0,
                   compact_block: int = 128, compact_levels: tuple = (),
                   warm_start: str = "track"):
    """Rocket soft-landing SOC MPC (max-thrust + thrust-angle + glideslope
    cones; reference MPC config run_simple_rocket.jl:118-132), batched over
    scenarios differing in process noise (wp=1e-3, wv=1e-2)."""
    from altro_mpc.mpc import make_mpc_step

    dtype = jnp.float32
    su = rocket_setup(dtype, N_mpc=N_mpc, opts_override=opts_override,
                      warm_start=warm_start)
    prob_mpc, opts = su["prob_mpc"], su["opts"]

    rng = np.random.default_rng(1)
    noise = jnp.asarray(rng.standard_normal((T, B, 6)), dtype)
    ws = su.get("warm_start", "shift")
    step, init_carry = make_mpc_step(
        prob_mpc, opts, su["X_track"], su["U_track"],
        noise_model=su["noise_model"], shared_k=True, warm_start=ws)
    batch_step = None
    if compact_cap:
        from altro_mpc.mpc import make_mpc_step_device_compacted
        batch_step, init_carry = make_mpc_step_device_compacted(
            prob_mpc, opts, su["X_track"], su["U_track"],
            noise_model=su["noise_model"], it_cap=compact_cap,
            block=compact_block, levels=compact_levels, warm_start=ws)
    res = _throughput(step, init_carry, noise, "rocket_soc_mpc_N21",
                      batch_step=batch_step)
    res["warm_start"] = ws
    res["cold_status"] = su["cold_status"]
    if compact_cap:
        res["compact_it_cap"] = compact_cap
        res["compact_levels"] = list(map(list, compact_levels))
    return res


def grasp_setup(dtype=None, N_mpc: int = 21, opts_override: dict = None,
                track=None):
    """Shared grasp MPC-bench construction; see :func:`rocket_setup` for
    the contract (used by grasp_batched + bench/agreement_conic.py)."""
    import altro_mpc as at
    from altro_mpc.models import grasp
    from altro_mpc.mpc import gen_tracking_mpc

    dtype = dtype or jnp.float32
    N, tf = 61, 6.0
    o = grasp.make_grasp_object(N, tf, dtype=dtype)
    prob = grasp.grasp_problem(o, N, tf, dtype=dtype)
    cold_status = None
    if track is None:
        cold_opts = at.SolverOptions(
            cost_tolerance=1e-5, gradient_tolerance=1e-6,
            constraint_tolerance=1e-5, penalty_initial=10.0,
            penalty_scaling=10.0, iterations_outer=30,
            iterations_inner=50)
        print(f"  cold solve (N=61, {jnp.dtype(dtype).name})...",
              flush=True)
        cold = jax.jit(at.solve)(prob, cold_opts,
                                 U0=grasp.hover_controls(o, N, dtype=dtype))
        jax.block_until_ready(cold.X)
        cold_status = int(cold.stats.status)
        print(f"  cold: status={cold_status} "
              f"viol={float(cold.stats.viol):.2e}", flush=True)
        track = (cold.X, cold.U)
    X_track, U_track = track

    prob_mpc = gen_tracking_mpc(prob, X_track, U_track, N_mpc, Qk=1e3,
                                Rk=1.0, Qfk=10.0, dt=tf / (N - 1))
    prob_mpc = prob_mpc.replace(
        constraints=grasp.grasp_constraints(o, N_mpc, 0, dtype=dtype))
    # penalty_initial=1e3 / scaling=10 beats 1e4/100 on both speed and
    # quality: the tall grasp straggler tail was mostly the penalty
    # schedule, and against the 1e-7 f64 truth the controls error drops
    # from ~0.9 to ~5e-3. iterations_linesearch=2: unlike the rocket, the
    # grasp quality gate is unchanged at L=2 (its torque-balance/friction
    # geometry accepts the full Newton step), and the short ladder is
    # cheaper. (Tuned on an earlier accelerator; re-measure on the GPU.)
    okw = dict(
        cost_tolerance=1e-4, constraint_tolerance=1e-4,
        penalty_initial=1e3, penalty_scaling=10.0, reset_duals=False,
        iterations_inner=8, reg_min=1.0, early_exact_tol=1e-3,
        iterations_linesearch=2)
    okw.update(opts_override or {})
    opts = at.SolverOptions(**okw)
    fn = lambda k: grasp.grasp_constraints(o, N_mpc, k, dtype=dtype)
    return dict(prob_mpc=prob_mpc, opts=opts, X_track=X_track,
                U_track=U_track, constraints_fn=fn, noise_model=None,
                noise_dim=6, cold_status=cold_status, warm_start="shift")


def grasp_batched(B: int = 1024, T: int = 15, N_mpc: int = 21,
                  opts_override: dict = None, compact_cap: int = 0,
                  compact_block: int = 128, compact_levels: tuple = ()):
    """Grasp time-varying-SOC MPC (rotating contact frames: torque-balance
    equality + max-force + 2 friction cones per knot, refreshed per step
    without re-jit; grasp_benchmark.jl config), batched over noise."""
    from altro_mpc.mpc import make_mpc_step

    dtype = jnp.float32
    su = grasp_setup(dtype, N_mpc=N_mpc, opts_override=opts_override)
    prob_mpc, opts, fn = su["prob_mpc"], su["opts"], su["constraints_fn"]

    rng = np.random.default_rng(0)
    noise = jnp.asarray(rng.standard_normal((T, B, 6)), dtype)
    ws = su.get("warm_start", "shift")
    step, init_carry = make_mpc_step(prob_mpc, opts, su["X_track"],
                                     su["U_track"], constraints_fn=fn,
                                     shared_k=True, warm_start=ws)
    batch_step = None
    if compact_cap:
        from altro_mpc.mpc import make_mpc_step_device_compacted
        batch_step, init_carry = make_mpc_step_device_compacted(
            prob_mpc, opts, su["X_track"], su["U_track"], constraints_fn=fn,
            it_cap=compact_cap, block=compact_block, levels=compact_levels,
            warm_start=ws)
    res = _throughput(step, init_carry, noise, "grasp_tv_soc_mpc_N21",
                      batch_step=batch_step)
    if compact_cap:
        res["compact_it_cap"] = compact_cap
        res["compact_levels"] = list(map(list, compact_levels))
    return res


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="results_gpu")
    p.add_argument("--batch", type=int,
                   default=int(os.environ.get("BENCH_BATCH", 1024)))
    p.add_argument("--which", default="all",
                   choices=["all", "rocket", "grasp"])
    # default ON (-1 = per-family setting, tuned on an earlier
    # accelerator and to be re-tuned on the GPU): rocket cap=16/block=256 +
    # a (16,128) level, grasp cap=8/block=256 + an (8,128) level. 0
    # restores the plain vmapped step.
    p.add_argument("--compact-cap", type=int,
                   default=int(os.environ.get("BENCH_COMPACT_CAP", -1)),
                   help="it_cap for device-side straggler compaction "
                        "(-1 = per-family default, 0 = plain vmapped step)")
    p.add_argument("--compact-block", type=int,
                   default=int(os.environ.get("BENCH_COMPACT_BLOCK", -1)),
                   help="compaction block size "
                        "(-1 = per-family default)")
    p.add_argument("--compact-levels",
                   default=os.environ.get("BENCH_COMPACT_LEVELS", ""),
                   help="extra nested compaction stages as "
                        "'cap:block,cap:block' (e.g. '24:128'); each stage "
                        "runs the current block cap more iterations, then "
                        "gathers block stragglers for the next")
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    meta = dict(device=str(jax.devices()[0]), dtype="float32")
    levels = []
    for part in (s for s in args.compact_levels.split(",") if s):
        fields = part.split(":")
        if len(fields) != 2:
            p.error(f"--compact-levels entry {part!r} must be 'cap:block'")
        levels.append((int(fields[0]), int(fields[1])))
    levels = tuple(levels)
    if levels and args.compact_cap == 0:
        p.error("--compact-levels requires --compact-cap > 0 "
                "(levels are ignored by the plain vmapped step)")
    if args.which in ("all", "rocket"):
        print("== rocket_batched", flush=True)
        cap = 16 if args.compact_cap == -1 else args.compact_cap
        blk = 256 if args.compact_block == -1 else args.compact_block
        lv = (((16, 128),) if (args.compact_cap == -1 and not levels)
              else levels)
        res = dict(rocket_batched(B=args.batch, compact_cap=cap,
                                  compact_block=blk,
                                  compact_levels=lv), **meta)
        with open(os.path.join(args.out, "rocket_batched.json"), "w") as f:
            json.dump(res, f, indent=1)
    if args.which in ("all", "grasp"):
        print("== grasp_batched", flush=True)
        cap = 8 if args.compact_cap == -1 else args.compact_cap
        blk = 256 if args.compact_block == -1 else args.compact_block
        lv = (((8, 128),) if (args.compact_cap == -1 and not levels)
              else levels)
        res = dict(grasp_batched(B=args.batch, compact_cap=cap,
                                 compact_block=blk,
                                 compact_levels=lv), **meta)
        with open(os.path.join(args.out, "grasp_batched.json"), "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
