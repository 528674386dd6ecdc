"""Flexible-satellite benchmark tests (benchmark 4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import altro_mpc as at
from altro_mpc.models import flexible_satellite as fs
from altro_mpc.solver import admm_qp
from altro_mpc.transcribe import to_batch_qp

OPTS = at.SolverOptions(cost_tolerance=1e-6, gradient_tolerance=1e-8,
                        constraint_tolerance=1e-6, penalty_initial=100.0,
                        penalty_scaling=100.0)


@pytest.fixture(scope="module")
def prob():
    return fs.flexsat_problem()


def test_model_dimensions(prob):
    assert (prob.n, prob.m, prob.N) == (12, 3, 80)
    # discretized A should be stable-ish (flexible modes are lightly damped)
    eigs = np.abs(np.linalg.eigvals(np.asarray(prob.dynamics.A[0])))
    assert eigs.max() <= 1.0 + 1e-9


def test_cold_solve_vs_admm_qp(prob):
    """ALTRO and the QP baseline agree on the condensed QP (the reference's
    cross-check, flexible_sat_mpc.jl:216-237)."""
    sol = at.solve(prob, OPTS)
    assert int(sol.stats.status) == 1
    assert float(jnp.max(jnp.abs(sol.U))) <= 0.01 + 1e-7

    qp = to_batch_qp(prob)
    qsol = admm_qp.solve(admm_qp.setup(qp), eps_abs=1e-9, max_iter=20000)
    Xq, Uq = admm_qp.extract_traj(qp, qsol.x)
    assert int(qsol.status) == 1
    np.testing.assert_allclose(sol.X, Xq, atol=1e-4)
    np.testing.assert_allclose(sol.U, Uq, atol=1e-4)


def test_regulator_mpc_converges_to_origin(prob):
    """45-step regulator MPC (flexible_sat_mpc.jl:242-308): bounded controls,
    successful solves, attitude error decreasing."""
    T = 45
    rng = np.random.default_rng(2)
    noise = jnp.asarray(rng.standard_normal((T, prob.n)))
    opts = at.SolverOptions(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                            penalty_initial=100.0, penalty_scaling=100.0)
    res = jax.jit(fs.run_regulator_mpc)(prob, opts, noise)
    assert int(jnp.sum(res.status)) == T
    # bounds honored to the AL constraint tolerance (1e-4)
    assert float(jnp.max(jnp.abs(res.U))) <= 0.01 + 1e-4
    # MRP attitude magnitude shrinks substantially over the run
    att0 = float(jnp.linalg.norm(prob.x0[:3]))
    attT = float(jnp.mean(jnp.linalg.norm(res.x0[-5:, :3], axis=-1)))
    assert attT < 0.5 * att0
