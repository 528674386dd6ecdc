"""The parallel line-search ladder: its width does not move the optimum,
and the batched solve (the ladder rollout's custom_vmap rule) matches
single-lane solves on the conic families.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import altro_mpc as at


def _rocket_window(dtype):
    from altro_mpc.models import rocket
    from altro_mpc.mpc import gen_tracking_mpc

    N = 61
    prob = rocket.rocket_problem(N=N, tf=(N - 1) * 0.05, dtype=dtype)
    opts = at.SolverOptions(
        cost_tolerance=1e-5, gradient_tolerance=1e-6,
        constraint_tolerance=1e-4, penalty_initial=1e-2,
        penalty_scaling=500.0, iterations_outer=40, iterations_inner=100)
    sol = at.solve(prob, opts, U0=rocket.hover_controls(prob))
    return gen_tracking_mpc(prob, sol.X, sol.U, 21, dt=0.05)


def _family(family, dtype=jnp.float64):
    if family == "rocket":
        return _rocket_window(dtype), dict(
            cost_tolerance=1e-6, gradient_tolerance=1e-8,
            constraint_tolerance=1e-6, penalty_initial=1e2,
            penalty_scaling=10.0, iterations_outer=30, iterations_inner=50)
    from altro_mpc.models import random_linear as rl
    rng = np.random.default_rng(7)
    return rl.gen_random_linear(rng, 8, 4, 31, dtype=dtype), dict(
        cost_tolerance=1e-8, gradient_tolerance=1e-9,
        constraint_tolerance=1e-8, penalty_initial=1e3,
        penalty_scaling=100.0)


@pytest.mark.parametrize("family", ["rocket", "bounds"])
def test_ladder_width_keeps_optimum(family):
    pm, kw = _family(family)
    sol_short = at.solve(pm, at.SolverOptions(iterations_linesearch=5, **kw))
    sol_long = at.solve(pm, at.SolverOptions(iterations_linesearch=10, **kw))
    assert int(sol_short.stats.status) == 1
    assert int(sol_long.stats.status) == 1
    # same optimum at the solve tolerance (the iterate sequences differ
    # wherever the short ladder has no rung for the step the long one takes)
    assert float(jnp.max(jnp.abs(sol_short.U - sol_long.U))) < 1e-4
    gap = abs(float(sol_short.stats.cost) - float(sol_long.stats.cost)) / max(
        abs(float(sol_long.stats.cost)), 1e-9)
    assert gap < 1e-7


def test_vmap_matches_single():
    """Batched (the custom_vmap XLA branch on CPU) vs single-lane solves."""
    pm, kw = _family("rocket")
    opts = at.SolverOptions(**kw)
    rng = np.random.default_rng(3)
    x0s = jnp.asarray(pm.x0)[None, :] + jnp.asarray(
        0.01 * rng.standard_normal((3, pm.n)), jnp.float64)
    sols = jax.vmap(lambda x0: at.solve(pm.replace(x0=x0), opts))(x0s)
    for i in range(3):
        s1 = at.solve(pm.replace(x0=x0s[i]), opts)
        # batched einsums contract in a different order than the
        # single-lane program: f64 reduction-order noise only
        assert int(sols.stats.iterations[i]) == int(s1.stats.iterations)
        np.testing.assert_allclose(np.asarray(sols.U[i]),
                                   np.asarray(s1.U), atol=2e-6)
