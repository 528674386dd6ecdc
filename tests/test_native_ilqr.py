"""Native AL-iLQR (native/ilqr_solver.cpp) vs the JAX solver.

The native solver is the CPU-latency twin of solver/altro.py (the role
Altro.jl's compiled solver plays in the reference's single-core numbers,
figures/horizon_comp.tikz). Parity bar: same flat AL+iLQR loop — identical
ITERATION COUNTS and trajectories to f64 roundoff against the f64 JAX
solver, cold and warm, bounds and SOC cones.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import altro_mpc as at
from altro_mpc.models import random_linear as rl
from altro_mpc.native import qp as native_qp

pytestmark = pytest.mark.skipif(not native_qp.available(),
                                reason="native toolchain unavailable")


def _flagship(N_mpc=21, T_extra=10, seed=0):
    rng = np.random.default_rng(seed)
    N_track = N_mpc + T_extra + 2
    prob = rl.gen_random_linear(rng, 12, 6, N_track, dtype=jnp.float64)
    X_track, U_track = rl.gen_trajectory(rng, prob, N_track)
    return rl.gen_tracking_mpc(prob, X_track, U_track, N_mpc), X_track, U_track


OPTS = at.SolverOptions(cost_tolerance=1e-4, gradient_tolerance=1e-4,
                        constraint_tolerance=1e-4, penalty_initial=1e3,
                        penalty_scaling=100.0, reset_duals=False)


def test_cold_solve_matches_jax():
    pm, _, _ = _flagship()
    sol = jax.jit(at.solve)(pm, OPTS)
    w = native_qp.ilqr_setup(pm)
    ns = w.solve(OPTS)
    assert ns.status == 1
    assert ns.iterations == int(sol.stats.iterations)
    assert ns.outer_iterations == int(sol.stats.outer_iterations)
    np.testing.assert_allclose(ns.X, np.asarray(sol.X), atol=1e-9)
    np.testing.assert_allclose(ns.U, np.asarray(sol.U), atol=1e-9)


def test_warm_mpc_sequence_matches_jax():
    """Three warm-started MPC re-solves in lockstep (shifted U/lam/X and a
    retargeted window), native vs JAX — the run_MPC hot line."""
    from altro_mpc.costs import retarget_tracking
    from altro_mpc.mpc import shift_fill, track_window

    pm, X_track, U_track = _flagship()
    N = pm.N
    sol = jax.jit(at.solve)(pm, OPTS)
    w = native_qp.ilqr_setup(pm)
    ns = w.solve(OPTS)

    A = np.asarray(pm.dynamics.A[0])
    B = np.asarray(pm.dynamics.B[0])
    d = np.asarray(pm.dynamics.d[0])
    rng = np.random.default_rng(1)
    x0 = np.asarray(pm.x0)
    Xc, Uc, lam = ns.X, ns.U, ns.lam
    jX, jU, jduals = sol.X, sol.U, sol.duals
    for t in range(3):
        x_prop = A @ x0 + B @ Uc[0] + d
        x0 = x_prop + rng.standard_normal(12) * np.max(np.abs(x_prop)) / 100
        Xw, Uw = track_window(X_track, U_track, t + 1, N)
        pk = pm.replace(cost=retarget_tracking(pm.cost, Xw, Uw),
                        x0=jnp.asarray(x0))
        # JAX side
        U_ws = shift_fill(jU)
        duals_ws = tuple(dd.shift() for dd in jduals)
        js = at.solve(pk, OPTS, U0=U_ws, duals=duals_ws)
        jX, jU, jduals = js.X, js.U, js.duals
        # native side (same shifts; lam blocks concatenated)
        w.update(pk)
        nsol = w.solve(OPTS,
                       U0=np.concatenate([Uc[1:], Uc[-1:]], 0),
                       lam0=np.concatenate([lam[1:], lam[-1:]], 0))
        Xc, Uc, lam = nsol.X, nsol.U, nsol.lam
        assert nsol.status == int(js.stats.status) == 1
        assert nsol.iterations == int(js.stats.iterations), t
        np.testing.assert_allclose(Uc, np.asarray(jU), atol=1e-8)


def test_soc_solve_matches_jax():
    """SOC cones (rocket thrust/angle/glideslope) through the dense
    projection-Jacobian branch: identical iterates vs the JAX solver even on
    a deliberately hard window (equal iteration counts, equal violation)."""
    from altro_mpc.models import rocket

    N = 41
    prob = rocket.rocket_problem(N=N, tf=(N - 1) * 0.05, dtype=jnp.float64)
    # scale the initial state toward the pad so the short horizon is feasible
    prob = prob.replace(x0=prob.x0 / 6.0)
    opts = at.SolverOptions(cost_tolerance=1e-5, gradient_tolerance=1e-6,
                            constraint_tolerance=1e-4, penalty_initial=1e-2,
                            penalty_scaling=500.0, iterations_outer=40,
                            iterations_inner=100)
    sol = jax.jit(at.solve)(prob, opts, U0=rocket.hover_controls(prob))
    w = native_qp.ilqr_setup(prob)
    ns = w.solve(opts, U0=np.asarray(rocket.hover_controls(prob)))
    assert ns.iterations == int(sol.stats.iterations)
    assert abs(ns.viol - float(sol.stats.viol)) < 1e-6
    np.testing.assert_allclose(ns.U, np.asarray(sol.U), atol=1e-6)
