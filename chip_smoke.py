"""GPU smoke test: the batched AL-iLQR MPC path, compiled for the card.

    python chip_smoke.py           # phases (a)-(c) on one card
    python chip_smoke.py --four    # phase (d) only, on four cards

It refuses to run without a GPU: on a CPU-only host it exits non-zero and
prints no result. Before any phase it prints the card's name and power
limit. Each phase prints one line with the path it took (Triton kernel or
XLA), its compile seconds and its result, and raises on failure.

(a) Kernel parity. Each kernel (Riccati backward pass, line-search ladder
    rollout) compiled for the card against its plain XLA
    reference at precision ``highest``, f32, B=1024, on the flagship window
    (n=12, m=6, N=30, one bound block) and the rocket window (three SOC
    blocks). Tolerances and their reasons: ``altro_mpc/ops/parity.py``.
(b) Flagship MPC. ``make_mpc_step(shared_k=True)`` vmapped and jitted at
    B=1024 for 10 warm steps: success rate 1.0, max violation <= 2e-4, and
    the last step's controls of 8 sampled lanes against a cold f64 truth
    solve of the same instance.
(c) Rocket. The rocket SOC window at B=1024 with device-side straggler
    compaction, 10 steps: success 1.0, max violation <= 2e-4, a converged
    cold reference, and the cost of every lane's last controls against a
    cold f64 truth solve (median and tail share of the relative excess).
(d) Four cards (``--four``): ``sharded_mpc_step`` on the flagship at
    B=4096 over four cards against the same batch on one card, lane for
    lane, with the scaling efficiency.

The truth solves run in a child process with ``JAX_PLATFORMS=cpu``, so that
only this process opens the card. The last line of standard output is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

B = 1024
STEPS = 10
SAMPLE = 8
MAX_VIOL = 2e-4
# Accuracy limits, from readings on an H100 80GB HBM3 at 700 W.
# - Flagship, max |dU| of the 8 lanes' f32 controls against the f64 truth:
#   6.74e-06 sound, 6.36e-04 with the solver's matmuls at TF32 (python -m
#   altro_mpc.bench.ab tf32). The limit sits between them.
# - Rocket, relative cost excess of each lane's f32 controls (rolled out in
#   f64) over the truth cost. The shipped rocket options stop some lanes
#   early at feasible points above the optimum, so the excess has a heavy
#   tail under sound f32 that moves from one compile to the next (XLA's
#   autotuned choices change the rounding): over all 1024 lanes of the last
#   step, four compiles read medians 6.10e-10 to 2.54e-07, shares above
#   1e-2 of 0.98% to 2.34%, and maxima 0.16-0.46 (the CPU gives the same
#   picture; so did the code before the port). So the gate is the median
#   and the tail share, never the max of a sample. A fifth compile ran the
#   batched step at TF32 (median 9.20e-08, share 2.15%) and cannot be told
#   from the sound ones; TF32 shows up instead in the flagship's |dU| and
#   in the cold N=301 reference solve, which then fails (status 0, viol
#   8.61e-02), and phase (c) checks that the reference converged.
FLAGSHIP_DU = 1e-4
ROCKET_GAP_MEDIAN = 1e-5
ROCKET_TAIL_GAP = 1e-2
ROCKET_TAIL_SHARE = 0.1


def _line(phase, name, path, compile_s, result):
    print(f"[{phase}] {name}: path={path} compile_s={compile_s:.1f} "
          f"{result}", flush=True)


def _kernel_names(lowered_text):
    names = [k for k in ("altro_riccati_backward", "altro_ls_rollout")
             if k in lowered_text]
    return "+".join(names) if names else "XLA"


# ---------------------------------------------------------------------------
# (a) kernel parity
# ---------------------------------------------------------------------------

def phase_kernels():
    import jax.numpy as jnp

    from altro_mpc.ops import parity, use_kernel

    for name in ("flagship", "rocket"):
        case = parity.make_case(name, B)
        pm = case["prob"]
        for kname, phase, fn in (
                ("riccati_backward", "backward", parity.backward_parity),
                ("ls_rollout", "rollout", parity.rollout_parity)):
            if not use_kernel(phase, jnp.float32, pm.n, pm.m, True):
                _line("a", f"{kname}/{name}", "XLA", 0.0,
                      "kernel not used at these dims (ops/dispatch.py)")
                continue
            t0 = time.perf_counter()
            errs = fn(case)
            dt = time.perf_counter() - t0
            worst = max(r for _, r in errs.values())
            res = " ".join(f"{k}={e:.2e}" for k, (e, _) in errs.items())
            _line("a", f"{kname}/{name}", "kernel", dt,
                  f"max_abs_err {res} tol_ratio={worst:.3f}")
            if not worst <= 1.0:
                raise AssertionError(f"{kname}/{name} outside tolerance: "
                                     f"{errs}")


# ---------------------------------------------------------------------------
# truth solves (CPU child)
# ---------------------------------------------------------------------------

def _truth(payload):
    """Child-process side: cold f64 truth solves of the sampled lanes."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import altro_mpc as at
    from altro_mpc.costs import retarget_tracking
    from altro_mpc.mpc import track_window

    k = payload["k"]
    if payload["family"] == "flagship":
        from bench import flagship_setup

        prob_mpc, _, X_track, U_track, _ = flagship_setup(1, STEPS)
        prob_mpc, X_track, U_track = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(
                a.dtype, jnp.floating) else a, (prob_mpc, X_track, U_track))
        opts = at.SolverOptions(
            cost_tolerance=1e-8, gradient_tolerance=1e-9,
            constraint_tolerance=1e-7, penalty_initial=1e3,
            penalty_scaling=100.0)
    else:
        from altro_mpc.bench.batched_conic import rocket_setup

        track = tuple(jnp.asarray(np.asarray(a), jnp.float64)
                      for a in payload["track"])
        su = rocket_setup(jnp.float64, track=track)
        prob_mpc, (X_track, U_track) = su["prob_mpc"], track
        opts = at.SolverOptions(
            cost_tolerance=1e-7, gradient_tolerance=1e-9,
            constraint_tolerance=1e-7, penalty_initial=1e3,
            penalty_scaling=10.0, iterations_outer=40,
            iterations_inner=100)
    Xw, Uw = track_window(X_track, U_track, k, prob_mpc.N)
    pb = prob_mpc.replace(cost=retarget_tracking(prob_mpc.cost, Xw, Uw))

    def one(x0, U):
        sol = at.solve(pb.replace(x0=x0), opts, U0=Uw)
        cost = lambda u: pb.cost.total(pb.dynamics.rollout(x0, u), u)
        Jt, J = cost(sol.U), cost(U)
        return dict(status=sol.stats.status,
                    dU=jnp.max(jnp.abs(U - sol.U)),
                    gap=(J - Jt) / jnp.maximum(jnp.abs(Jt), 1e-12))

    out = jax.jit(jax.vmap(one))(jnp.asarray(payload["x0"], jnp.float64),
                                 jnp.asarray(payload["U"], jnp.float64))
    return {k: np.asarray(v).tolist() for k, v in out.items()}


def _truth_in_child(payload):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_PYTHON_CLIENT_MEM_FRACTION", None)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--truth"],
        input=json.dumps(payload), capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)), check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"truth child failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _run_steps(vstep, carry, noise, ks):
    statuses, viols, iters = [], [], []
    for t in range(len(ks)):
        carry, out = vstep(carry, noise[t], ks[t])
        statuses.append(out.status)
        viols.append(out.viol)
        iters.append(out.iters)
    return carry, out, statuses, viols, iters


def _batch_stats(statuses, viols):
    import jax.numpy as jnp

    success = float(jnp.mean(jnp.stack(statuses).astype(jnp.float32)))
    max_viol = float(jnp.max(jnp.stack(viols)))
    return success, max_viol


def _require(checks, detail):
    """Raise naming every failed check ({name: passed}) after the phase has
    printed its line."""
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"failed {failed}: {detail}")


# ---------------------------------------------------------------------------
# (b) flagship MPC
# ---------------------------------------------------------------------------

def phase_flagship():
    import jax
    import jax.numpy as jnp

    from altro_mpc.mpc import make_mpc_step
    from bench import flagship_setup

    prob_mpc, opts, X_track, U_track, noise = flagship_setup(B, STEPS)
    step, init_carry = make_mpc_step(prob_mpc, opts, X_track, U_track,
                                     shared_k=True)
    vstep = jax.jit(jax.vmap(step, in_axes=(0, 0, None)))
    carry0 = jax.jit(jax.vmap(lambda _: init_carry()))(jnp.arange(B))
    ks = [jnp.asarray(t, jnp.int32) for t in range(STEPS)]
    t0 = time.perf_counter()
    lowered = vstep.lower(carry0, noise[0], ks[0])
    path = _kernel_names(lowered.as_text())
    jax.block_until_ready(vstep(carry0, noise[0], ks[0]))
    compile_s = time.perf_counter() - t0

    _, out, statuses, viols, iters = _run_steps(vstep, carry0, noise, ks)
    success, max_viol = _batch_stats(statuses, viols)
    idx = np.linspace(0, B - 1, SAMPLE).astype(int)
    truth = _truth_in_child(dict(
        family="flagship", k=STEPS,
        x0=np.asarray(out.x0)[idx].tolist(),
        U=np.asarray(out.U)[idx].tolist()))
    dU = max(truth["dU"])
    _line("b", f"flagship_mpc_B{B}", path, compile_s,
          f"success={success:.4f} max_viol={max_viol:.2e} "
          f"mean_iters={float(jnp.mean(jnp.stack(iters))):.2f} "
          f"max_dU_vs_f64={dU:.2e} (tol {FLAGSHIP_DU:g})")
    _require({"success": success == 1.0, "max_viol": max_viol <= MAX_VIOL,
              "truth_status": all(st == 1 for st in truth["status"]),
              "dU": dU <= FLAGSHIP_DU}, truth)


# ---------------------------------------------------------------------------
# (c) rocket
# ---------------------------------------------------------------------------

def phase_rocket():
    import jax
    import jax.numpy as jnp

    from altro_mpc.bench.batched_conic import rocket_setup
    from altro_mpc.mpc import make_mpc_step_device_compacted

    su = rocket_setup(jnp.float32)
    rng = np.random.default_rng(1)
    noise = jnp.asarray(rng.standard_normal((STEPS, B, 6)), jnp.float32)
    bstep, init_carry = make_mpc_step_device_compacted(
        su["prob_mpc"], su["opts"], su["X_track"], su["U_track"],
        noise_model=su["noise_model"], it_cap=16, block=256,
        levels=((16, 128),), warm_start=su["warm_start"])
    vstep = jax.jit(bstep)
    carry0 = jax.jit(jax.vmap(lambda _: init_carry()))(jnp.arange(B))
    ks = [jnp.asarray(t, jnp.int32) for t in range(STEPS)]
    t0 = time.perf_counter()
    path = _kernel_names(vstep.lower(carry0, noise[0], ks[0]).as_text())
    jax.block_until_ready(vstep(carry0, noise[0], ks[0]))
    compile_s = time.perf_counter() - t0

    _, out, statuses, viols, iters = _run_steps(vstep, carry0, noise, ks)
    success, max_viol = _batch_stats(statuses, viols)
    truth = _truth_in_child(dict(
        family="rocket", k=STEPS,
        track=[np.asarray(su["X_track"]).tolist(),
               np.asarray(su["U_track"]).tolist()],
        x0=np.asarray(out.x0).tolist(), U=np.asarray(out.U).tolist()))
    gap = np.asarray(truth["gap"])
    gap_median = float(np.median(gap))
    tail = float(np.mean(gap > ROCKET_TAIL_GAP))
    _line("c", f"rocket_soc_compacted_B{B}", path, compile_s,
          f"success={success:.4f} max_viol={max_viol:.2e} "
          f"mean_iters={float(jnp.mean(jnp.stack(iters))):.2f} "
          f"cost_gap_vs_f64: median={gap_median:.2e} "
          f"(tol {ROCKET_GAP_MEDIAN:g}) "
          f"share>{ROCKET_TAIL_GAP:g}={tail:.4f} "
          f"(tol {ROCKET_TAIL_SHARE:g}) max={gap.max():.2e} "
          f"median_dU={float(np.median(truth['dU'])):.2e} "
          f"max_dU={max(truth['dU']):.2e} (not gated)")
    _require({"cold_reference": su["cold_status"] == 1,
              "success": success == 1.0, "max_viol": max_viol <= MAX_VIOL,
              "truth_status": all(st == 1 for st in truth["status"]),
              "cost_gap_median": gap_median <= ROCKET_GAP_MEDIAN,
              "cost_gap_tail": tail <= ROCKET_TAIL_SHARE},
             dict(cold_status=su["cold_status"], gap_median=gap_median,
                  tail_share=tail,
                  truth_failed=sum(st != 1 for st in truth["status"])))


# ---------------------------------------------------------------------------
# (d) four cards
# ---------------------------------------------------------------------------

def phase_four(B4=4096, steps=STEPS, n_devices=4):
    """Sharded flagship step over ``n_devices`` cards against the same batch
    on one card. Returns the efficiency."""
    import jax
    import jax.numpy as jnp

    import altro_mpc as at
    from altro_mpc.parallel import make_scenario_mesh, sharded_mpc_step
    from bench import flagship_setup

    if len(jax.devices()) < n_devices:
        raise RuntimeError(f"--four needs {n_devices} devices, found "
                           f"{len(jax.devices())}")
    prob_mpc, opts, X_track, U_track, noise = flagship_setup(B4, steps)
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(prob_mpc.x0[None, :] + 0.01 * rng.standard_normal(
        (B4, prob_mpc.n)), jnp.float32)
    sol0 = jax.jit(jax.vmap(
        lambda x0: at.solve(prob_mpc.replace(x0=x0), opts)))(x0s)
    state0 = (x0s, sol0.X, sol0.U, sol0.duals, jnp.asarray(0))

    runs = {}
    for nd in (1, n_devices):
        mesh = make_scenario_mesh(nd)
        jstep = jax.jit(sharded_mpc_step(prob_mpc, opts, X_track, U_track,
                                         mesh))
        t0 = time.perf_counter()
        path = _kernel_names(jstep.lower(state0, noise[0]).as_text())
        jax.block_until_ready(jstep(state0, noise[0]))
        compile_s = time.perf_counter() - t0
        walls = []
        for _ in range(3):
            state = state0
            t0 = time.perf_counter()
            for t in range(steps):
                state, metrics = jstep(state, noise[t])
            jax.block_until_ready(state)
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        n_success = int(metrics[2])
        max_viol = float(metrics[1])
        _line("d", f"sharded_flagship_B{B4}_{nd}dev", path, compile_s,
              f"solves_per_s={B4 * steps / wall:.1f} wall_s={wall:.4f} "
              f"success={n_success}/{B4} max_viol={max_viol:.2e}")
        if n_success != B4 or not max_viol <= MAX_VIOL:
            raise AssertionError(f"{nd}-device sharded step failed")
        runs[nd] = (wall, state)
    (w1, s1), (w4, s4) = runs[1], runs[n_devices]
    dX = float(np.max(np.abs(np.asarray(s1[1]) - np.asarray(s4[1]))))
    dU = float(np.max(np.abs(np.asarray(s1[2]) - np.asarray(s4[2]))))
    eff = w1 / (n_devices * w4)
    _line("d", f"sharded_vs_single_B{B4}", "-", 0.0,
          f"max_dX={dX:.2e} max_dU={dU:.2e} efficiency={eff:.3f}")
    if not max(dX, dU) <= 1e-4:
        raise AssertionError(f"sharded and single-card lanes differ: "
                             f"dX {dX:.2e} dU {dU:.2e}")
    return eff


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded phase (d)")
    p.add_argument("--truth", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.truth:
        print(json.dumps(_truth(json.loads(sys.stdin.read()))))
        return 0

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    import altro_mpc  # noqa: F401  (fails here outside a checkout)
    from altro_mpc.utils.runtime import card_description, enable_compile_cache

    enable_compile_cache()
    print(f"card: {card_description()}", flush=True)
    if args.four:
        phase_four()
    else:
        phase_kernels()
        phase_flagship()
        phase_rocket()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
