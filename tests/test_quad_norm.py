"""Nonlinear quadratic norm constraints (the reference's 'naive'
Inequality-sense comparison variant)."""
import jax.numpy as jnp
import numpy as np
import pytest

import altro_mpc as at


def test_quad_norm_binds_like_soc():
    """||u||^2 <= b^2 (quadratic NONPOS) should give the same solution as the
    SOC ||u|| <= b on a problem where the bound binds."""
    import jax
    n, m, N = 4, 2, 21
    key = jax.random.PRNGKey(4)
    A = jax.random.normal(key, (n, n)) * 0.3 + jnp.eye(n) * 0.7
    B = jax.random.normal(jax.random.PRNGKey(5), (n, m)) * 0.5
    x0 = jnp.ones(n) * 3.0
    bnd = 0.3

    dyn = at.lti_dynamics(A, B, N)
    cost = at.lqr_objective(jnp.eye(n), jnp.eye(m) * 1e-3, jnp.eye(n) * 10,
                            jnp.zeros(n), N)

    soc = at.Problem(dynamics=dyn, cost=cost,
                     constraints=(at.norm_constraint(N, n, m, bnd),), x0=x0)
    naive = at.Problem(
        dynamics=dyn, cost=cost,
        constraints=(at.quad_norm_constraint(N, n, m, jnp.eye(m), offset=bnd),),
        x0=x0)

    opts = at.SolverOptions(constraint_tolerance=1e-8, cost_tolerance=1e-8,
                            gradient_tolerance=1e-10, penalty_initial=1e2,
                            penalty_scaling=10.0, iterations_outer=40)
    sol_soc = at.solve(soc, opts)
    sol_naive = at.solve(naive, opts)
    assert int(sol_soc.stats.status) == 1
    assert int(sol_naive.stats.status) == 1
    # both ride the bound; controls agree
    np.testing.assert_allclose(sol_naive.U, sol_soc.U, atol=1e-4)
    norms = jnp.linalg.norm(sol_naive.U, axis=-1)
    assert float(jnp.max(norms)) <= bnd + 1e-6


def test_naive_rocket_cold_solve():
    """SOC-vs-naive rocket comparison (run_simple_rocket.jl:72-102): the
    naive quadratic-constraint formulation solves the same problem, typically
    needing more iterations."""
    from altro_mpc.models import rocket
    N = 151
    kw = dict(N=N, tf=(N - 1) * 0.1)
    opts = at.SolverOptions(cost_tolerance=1e-6, gradient_tolerance=1e-8,
                            constraint_tolerance=1e-5, penalty_initial=1e-2,
                            penalty_scaling=100.0, iterations_outer=40,
                            iterations_inner=100)
    sol_soc = at.solve(rocket.rocket_problem(**kw), opts,
                       U0=rocket.hover_controls(rocket.rocket_problem(**kw)))
    prob_naive = rocket.rocket_problem(conic=False, **kw)
    sol_naive = at.solve(prob_naive, opts,
                         U0=rocket.hover_controls(prob_naive))
    assert int(sol_soc.stats.status) == 1
    assert int(sol_naive.stats.status) == 1
    # same landing trajectory to reasonable accuracy
    np.testing.assert_allclose(sol_naive.X[-1], np.zeros(6), atol=1e-3)
    # loose agreement: both are tolerance-1e-5 solves of a nonconvex vs conic
    # formulation; the paths differ at the 0.1-position level mid-trajectory
    assert float(jnp.max(jnp.abs(sol_naive.X - sol_soc.X))) < 0.3
