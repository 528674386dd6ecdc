"""Rocket soft-landing benchmark tests (SOC-constrained).

Mirrors the reference's correctness checks: cold-solve SOC boundary activity
(run_simple_rocket.jl:112-116) and lockstep MPC agreement with the conic
baseline (run_Rocket_MPC, simple_rocket.jl:106-206).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import altro_mpc as at
from altro_mpc.models import rocket
from altro_mpc.mpc import gen_tracking_mpc, run_mpc_lockstep_conic

COLD_OPTS = at.SolverOptions(
    cost_tolerance=1e-6, gradient_tolerance=1e-8,
    constraint_tolerance=1e-5, penalty_initial=1e-2, penalty_scaling=500.0,
    iterations_outer=40, iterations_inner=100)

MPC_OPTS = at.SolverOptions(
    cost_tolerance=1e-4, constraint_tolerance=1e-4,
    penalty_initial=1e3, penalty_scaling=10.0, reset_duals=False)


@pytest.fixture(scope="module")
def cold_solve():
    # The reference cold-solve config: N=301, dt=0.05 (tf=15 s). Shorter
    # horizons make the landing infeasible from this x0.
    N = 301
    prob = rocket.rocket_problem(N=N, tf=(N - 1) * 0.05)
    sol = at.solve(prob, COLD_OPTS, U0=rocket.hover_controls(prob))
    return prob, sol


def test_cold_solve_converges(cold_solve):
    prob, sol = cold_solve
    assert int(sol.stats.status) == 1
    assert float(sol.stats.viol) < 1e-5
    # lands at the goal
    np.testing.assert_allclose(sol.X[-1], np.zeros(6), atol=1e-4)


def test_soc_boundary_activity(cold_solve):
    """The solution should ride the SOC boundaries (reference spot check:
    max thrust, 5-deg thrust angle, 45-deg glideslope)."""
    prob, sol = cold_solve
    U, X = sol.U, sol.X
    u_bnd = 10.0 * 9.81 * 2.0

    thrust = jnp.linalg.norm(U, axis=-1)
    assert float(jnp.max(thrust)) <= u_bnd + 1e-3

    angle = jnp.rad2deg(jnp.arctan2(jnp.linalg.norm(U[:, :2], axis=-1),
                                    U[:, 2]))
    assert float(jnp.max(angle)) <= 5.0 + 1e-3
    # thrust-angle cone actually binds during the maneuver
    assert float(jnp.max(angle)) >= 5.0 - 0.5

    glide = jnp.rad2deg(jnp.arctan2(jnp.linalg.norm(X[7:-1, :2], axis=-1),
                                    X[7:-1, 2]))
    assert float(jnp.max(glide)) <= 45.0 + 0.1


def test_rocket_mpc_lockstep_tolerance_sweep(cold_solve):
    """Warm-started SOC MPC, ALTRO vs the in-framework conic ADMM: the
    trajectory disagreement shrinks as the ALTRO tolerance tightens (the
    reference's tolerance-convergence correctness study,
    run_simple_rocket.jl:146-206 / figures/rocket_solver_tol.tikz; at loose
    tolerances the reference itself records O(0.1-70) errors)."""
    prob, sol = cold_solve
    N_mpc = 21
    dt = 0.05
    prob_mpc = gen_tracking_mpc(prob, sol.X, sol.U, N_mpc, dt=dt)

    T = 6
    rng = np.random.default_rng(1)
    noise = jnp.asarray(rng.standard_normal((T, 6)))

    errs = []
    for tol in (1e-4, 1e-6, 1e-8):
        opts = at.SolverOptions(
            cost_tolerance=tol, gradient_tolerance=tol * 1e-2,
            constraint_tolerance=tol, penalty_initial=1e3,
            penalty_scaling=10.0, reset_duals=False, iterations_outer=40)
        res = run_mpc_lockstep_conic(
            prob_mpc, opts, sol.X, sol.U, noise, conic_eps=1e-9,
            conic_max_iter=50000, noise_model=rocket.rocket_noise_model())
        assert int(jnp.sum(res.status[:, 0])) == T
        assert int(jnp.sum(res.status[:, 1])) == T
        errs.append(float(jnp.max(res.err_U)))
    assert errs[2] < errs[0], f"error did not shrink with tolerance: {errs}"
    assert errs[2] < 1e-3, f"tight-tolerance disagreement too large: {errs}"
