"""Solver correctness against closed-form LQR / constrained QP oracles."""
import jax
import jax.numpy as jnp
import numpy as np

import altro_mpc as at
from altro_mpc.utils.lqr import finite_lqr


def _random_system(key, n, m):
    k1, k2 = jax.random.split(key)
    A = jax.random.normal(k1, (n, n)) * 0.3 + jnp.eye(n) * 0.7
    B = jax.random.normal(k2, (n, m)) * 0.5
    return A, B


def test_unconstrained_matches_lqr_recursion():
    n, m, N = 6, 3, 25
    key = jax.random.PRNGKey(0)
    A, B = _random_system(key, n, m)
    Q = jnp.eye(n) * 2.0
    R = jnp.eye(m) * 0.5
    Qf = jnp.eye(n) * 10.0
    x0 = jax.random.normal(jax.random.PRNGKey(1), (n,))

    dyn = at.lti_dynamics(A, B, N)
    cost = at.lqr_objective(Q, R, Qf, jnp.zeros(n), N, dt=1.0)
    prob = at.Problem(dynamics=dyn, cost=cost, constraints=(), x0=x0)
    sol = jax.jit(at.solve, static_argnames=())(prob, at.SolverOptions(
        cost_tolerance=1e-10, gradient_tolerance=1e-10))

    # exact Riccati oracle
    Ks, ds = finite_lqr(A, B, Q, R, Qf, np.zeros(n), np.zeros(m), np.zeros(n), N)
    x = np.asarray(x0, np.float64)
    Xs, Us = [x], []
    for k in range(N - 1):
        u = Ks[k] @ x + ds[k]
        Us.append(u)
        x = np.asarray(A, np.float64) @ x + np.asarray(B, np.float64) @ u
        Xs.append(x)
    np.testing.assert_allclose(sol.U, np.stack(Us), atol=1e-6)
    np.testing.assert_allclose(sol.X, np.stack(Xs), atol=1e-6)
    assert int(sol.stats.status) == 1


def test_goal_constraint_reached():
    n, m, N = 4, 2, 31
    A, B = _random_system(jax.random.PRNGKey(2), n, m)
    xf = jnp.array([1.0, -1.0, 0.5, 0.0])
    x0 = jnp.zeros(n)

    dyn = at.lti_dynamics(A, B, N)
    cost = at.lqr_objective(jnp.eye(n) * 1e-2, jnp.eye(m) * 1e-1,
                            jnp.eye(n) * 1e-2, xf, N)
    cons = (at.goal_constraint(N, n, m, xf),)
    prob = at.Problem(dynamics=dyn, cost=cost, constraints=cons, x0=x0)
    sol = at.solve(prob, at.SolverOptions(constraint_tolerance=1e-6,
                                          penalty_initial=10.0,
                                          penalty_scaling=100.0))
    assert int(sol.stats.status) == 1
    np.testing.assert_allclose(sol.X[-1], xf, atol=1e-5)


def test_control_bounds_respected_and_active():
    n, m, N = 4, 2, 31
    A, B = _random_system(jax.random.PRNGKey(3), n, m)
    x0 = jnp.ones(n) * 5.0
    u_bnd = 0.4

    dyn = at.lti_dynamics(A, B, N)
    cost = at.lqr_objective(jnp.eye(n), jnp.eye(m) * 1e-3, jnp.eye(n) * 10,
                            jnp.zeros(n), N)
    cons = (at.bound_constraint(N, n, m, u_min=-u_bnd, u_max=u_bnd),)
    prob = at.Problem(dynamics=dyn, cost=cost, constraints=cons, x0=x0)
    sol = at.solve(prob, at.SolverOptions(constraint_tolerance=1e-6,
                                          penalty_initial=1e3,
                                          penalty_scaling=100.0))
    assert int(sol.stats.status) == 1
    assert float(jnp.max(jnp.abs(sol.U))) <= u_bnd + 1e-5
    # bounds should actually bind for this aggressive problem
    assert float(jnp.max(jnp.abs(sol.U))) >= u_bnd - 1e-3


def test_soc_constraint_binds():
    """||u|| <= b SOC constraint: solution rides the cone boundary when the
    unconstrained optimum exceeds it (mirrors the rocket max-thrust
    boundary-activity spot check, run_simple_rocket.jl:112-116)."""
    n, m, N = 4, 2, 21
    A, B = _random_system(jax.random.PRNGKey(4), n, m)
    x0 = jnp.ones(n) * 3.0
    bnd = 0.3

    dyn = at.lti_dynamics(A, B, N)
    cost = at.lqr_objective(jnp.eye(n), jnp.eye(m) * 1e-3, jnp.eye(n) * 10,
                            jnp.zeros(n), N)
    prob_uncon = at.Problem(dynamics=dyn, cost=cost, constraints=(), x0=x0)
    sol_uncon = at.solve(prob_uncon, at.SolverOptions())
    assert float(jnp.max(jnp.linalg.norm(sol_uncon.U, axis=-1))) > bnd

    cons = (at.norm_constraint(N, n, m, bnd, on="control"),)
    prob = at.Problem(dynamics=dyn, cost=cost, constraints=cons, x0=x0)
    sol = at.solve(prob, at.SolverOptions(constraint_tolerance=1e-6,
                                          penalty_initial=1e2,
                                          penalty_scaling=100.0))
    norms = jnp.linalg.norm(sol.U, axis=-1)
    assert int(sol.stats.status) == 1
    assert float(jnp.max(norms)) <= bnd + 1e-5
    assert float(jnp.max(norms)) >= bnd - 1e-3  # binds


def test_vmap_solve():
    """The solve is vmap-safe: batched solves equal individual solves."""
    n, m, N, Bsz = 4, 2, 15, 5
    A, B = _random_system(jax.random.PRNGKey(5), n, m)
    dyn = at.lti_dynamics(A, B, N)
    cost = at.lqr_objective(jnp.eye(n), jnp.eye(m) * 0.1, jnp.eye(n) * 5,
                            jnp.zeros(n), N)
    cons = (at.bound_constraint(N, n, m, u_min=-1.0, u_max=1.0),)

    x0s = jax.random.normal(jax.random.PRNGKey(6), (Bsz, n)) * 2.0
    opts = at.SolverOptions(penalty_initial=1e2, penalty_scaling=10.0)

    def solve_one(x0):
        prob = at.Problem(dynamics=dyn, cost=cost, constraints=cons, x0=x0)
        return at.solve(prob, opts)

    batched = jax.jit(jax.vmap(solve_one))(x0s)
    for i in range(Bsz):
        single = solve_one(x0s[i])
        np.testing.assert_allclose(batched.U[i], single.U, atol=1e-7)
        assert int(batched.stats.status[i]) == 1
