"""Single-instance warm-MPC latency: native AL-iLQR vs JAX vs reference.

The reference's single-core latency row (BASELINE.md random-linear horizon
sweep; figures/horizon_comp.tikz mean line) times `benchmark_solve!` —
the solver call alone on a warm-started, already-updated problem
(random_linear_problem.jl:161). This driver reproduces that accounting on
the same config (n=12, m=6, 1% noise, 100 warm steps):

- ``native``: the C++ AL-iLQR (native/ilqr_solver.cpp) — per-step
  ``solve()`` wall with shifts/update as untimed prep (the reference
  scope). Also records update+solve (the honest end-to-end number).
- ``jax``: the jitted whole-step (shifts + solve in one program; the
  step IS the solve on this path, so the number is conservative).

Writes results_cpu/single_latency.json.

Run: JAX_PLATFORMS=cpu python -m altro_mpc.bench.single_latency
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

# reference ALTRO horizon-sweep means (BASELINE.md; horizon_comp.tikz)
REFERENCE_MS = {11: 0.193, 31: 0.583, 51: 0.984, 71: 1.406, 101: 2.132}


def _config(N_mpc: int, T: int, seed: int = 0):
    import altro_mpc as at
    from altro_mpc.models import random_linear as rl

    rng = np.random.default_rng(seed)
    N_track = N_mpc + T + 2
    prob = rl.gen_random_linear(rng, 12, 6, N_track, dtype=jnp.float64)
    X_track, U_track = rl.gen_trajectory(rng, prob, N_track)
    pm = rl.gen_tracking_mpc(prob, X_track, U_track, N_mpc)
    opts = at.SolverOptions(
        cost_tolerance=1e-4, gradient_tolerance=1e-4,
        constraint_tolerance=1e-4, penalty_initial=1e3,
        penalty_scaling=100.0, reset_duals=False,
        # the flagship's tuned warm-solve knobs (bench.py): L=2 ladder +
        # exact-step early stop — agreement vs the f64 oracle unchanged
        iterations_linesearch=2, early_exact_tol=1e-3)
    return pm, X_track, U_track, opts, rng


def native_row(N_mpc: int, T: int = 100):
    from altro_mpc.costs import retarget_tracking
    from altro_mpc.mpc import track_window
    from altro_mpc.native import qp as native_qp

    pm, X_track, U_track, opts, rng = _config(N_mpc, T)
    w = native_qp.ilqr_setup(pm)
    s = w.solve(opts)
    assert s.status == 1
    Xc, Uc, lam = s.X, s.U, s.lam
    A = np.asarray(pm.dynamics.A[0])
    B = np.asarray(pm.dynamics.B[0])
    d = np.asarray(pm.dynamics.d[0])
    x0 = np.asarray(pm.x0)
    noise = rng.standard_normal((T, 12))
    solve_ms, upd_ms, iters, viols = [], [], [], []
    for t in range(T):
        x_prop = A @ x0 + B @ Uc[0] + d
        x0 = x_prop + noise[t] * np.max(np.abs(x_prop)) / 100.0
        Xw, Uw = track_window(X_track, U_track, t + 1, pm.N)
        pk = pm.replace(cost=retarget_tracking(pm.cost, Xw, Uw),
                        x0=jnp.asarray(x0))
        U_ws = np.concatenate([Uc[1:], Uc[-1:]], 0)
        lam_ws = np.concatenate([lam[1:], lam[-1:]], 0)
        X_ws = np.concatenate([Xc[1:],
                               (A @ Xc[-1] + B @ Uc[-1] + d)[None]], 0)
        t0 = time.perf_counter()
        w.update(pk)
        t1 = time.perf_counter()
        s = w.solve(opts, U0=U_ws, lam0=lam_ws, X0=X_ws)
        t2 = time.perf_counter()
        assert s.status == 1, (t, s.viol)
        upd_ms.append((t1 - t0) * 1e3)
        solve_ms.append((t2 - t1) * 1e3)
        iters.append(s.iterations)
        viols.append(s.viol)
        Xc, Uc, lam = s.X, s.U, s.lam
    return dict(
        N=N_mpc,
        solve_ms_mean=round(float(np.mean(solve_ms)), 4),
        solve_ms_p50=round(float(np.percentile(solve_ms, 50)), 4),
        solve_ms_std=round(float(np.std(solve_ms)), 4),
        update_ms_mean=round(float(np.mean(upd_ms)), 4),
        update_plus_solve_ms=round(float(np.mean(upd_ms)
                                         + np.mean(solve_ms)), 4),
        mean_iters=round(float(np.mean(iters)), 3),
        max_viol=float(np.max(viols)),
        reference_ms=REFERENCE_MS.get(N_mpc),
        vs_reference=round(REFERENCE_MS[N_mpc] / float(np.mean(solve_ms)), 2)
        if N_mpc in REFERENCE_MS else None,
    )


def jax_row(N_mpc: int, T: int = 60):
    from altro_mpc.mpc import make_mpc_step

    pm, X_track, U_track, opts, rng = _config(N_mpc, T)
    step, init_carry = make_mpc_step(pm, opts, X_track, U_track,
                                     shared_k=True)
    jstep = jax.jit(step)
    carry = jax.block_until_ready(jax.jit(init_carry)())
    noise = jnp.asarray(rng.standard_normal((T, 12)), jnp.float64)
    out = jstep(carry, noise[0], jnp.asarray(0, jnp.int32))
    jax.block_until_ready(out[1].status)
    walls, iters = [], []
    for t in range(T):
        t0 = time.perf_counter()
        carry, o = jstep(carry, noise[t], jnp.asarray(t, jnp.int32))
        jax.block_until_ready(o.status)
        walls.append((time.perf_counter() - t0) * 1e3)
        iters.append(int(o.iters))
    return dict(N=N_mpc,
                step_ms_mean=round(float(np.mean(walls)), 4),
                step_ms_p50=round(float(np.percentile(walls, 50)), 4),
                mean_iters=round(float(np.mean(iters)), 3))


def write_figure(res, path="figures/single_latency.png"):
    """Horizon-sweep latency comparison (figures/horizon_comp.tikz analog;
    repo convention: red = this framework, neutral dark = reference)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    Ns = [r["N"] for r in res["native"]]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(Ns, [REFERENCE_MS[n] for n in Ns], "s--", color="0.25",
            lw=2, label="reference ALTRO (Julia, 1 core)")
    ax.plot(Ns, [r["solve_ms_mean"] for r in res["native"]], "o-",
            color="tab:red", lw=2, label="native AL-iLQR (this framework)")
    ax.plot(Ns, [r["update_plus_solve_ms"] for r in res["native"]], "o:",
            color="tab:red", lw=1.2, alpha=0.7,
            label="native incl. problem update")
    ax.set_xlabel("MPC horizon N")
    ax.set_ylabel("warm solve time (ms)")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def main():
    if jax.default_backend() != "cpu":  # pragma: no cover
        raise SystemExit("run on CPU: JAX_PLATFORMS=cpu")
    jax.config.update("jax_enable_x64", True)
    res = {"config": "random-linear n=12 m=6, 1% noise, warm MPC steps",
           "native": [], "jax": []}
    for N in (11, 31, 51, 71, 101):
        r = native_row(N)
        print(f"native N={N}: solve {r['solve_ms_mean']} ms "
              f"(ref {r['reference_ms']} -> {r['vs_reference']}x), "
              f"update+solve {r['update_plus_solve_ms']} ms, "
              f"iters {r['mean_iters']}", flush=True)
        res["native"].append(r)
    for N in (11, 31, 51, 71, 101):
        r = jax_row(N)
        print(f"jax    N={N}: step {r['step_ms_mean']} ms "
              f"(iters {r['mean_iters']})", flush=True)
        res["jax"].append(r)
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "results_cpu", "single_latency.json")
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {out}")
    try:
        write_figure(res)
        print("wrote figures/single_latency.png")
    except Exception as e:  # plotting is best-effort
        print(f"(figure skipped: {e})")


if __name__ == "__main__":
    main()
