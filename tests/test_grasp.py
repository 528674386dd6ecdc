"""Grasp-optimization benchmark tests (time-varying SOC constraints)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import altro_mpc as at
from altro_mpc.models import grasp
from altro_mpc.mpc import gen_tracking_mpc, run_mpc_lockstep_conic

COLD_OPTS = at.SolverOptions(
    cost_tolerance=1e-6, gradient_tolerance=1e-8, constraint_tolerance=1e-6,
    penalty_initial=10.0, penalty_scaling=10.0, iterations_outer=30,
    iterations_inner=50)

MPC_OPTS = at.SolverOptions(
    cost_tolerance=1e-4, constraint_tolerance=1e-4, penalty_initial=1e4,
    penalty_scaling=100.0, reset_duals=False)


@pytest.fixture(scope="module")
def setup():
    N, tf = 61, 6.0
    o = grasp.make_grasp_object(N, tf)
    prob = grasp.grasp_problem(o, N, tf)
    sol = at.solve(prob, COLD_OPTS, U0=grasp.hover_controls(o, N))
    return o, prob, sol


def test_cold_solve_feasible(setup):
    o, prob, sol = setup
    assert int(sol.stats.status) == 1
    assert float(sol.stats.viol) < 1e-6
    np.testing.assert_allclose(sol.X[-1], np.zeros(6), atol=1e-4)


def test_constraints_satisfied_pointwise(setup):
    """Check the physics directly: torque balance, max force, friction cones
    (the reference's constraint structure, grasp_problem.jl:32-67)."""
    o, prob, sol = setup
    N = prob.N
    F1, F2 = sol.U[:, :3], sol.U[:, 3:]
    v1, v2 = o.v1[:N - 1], o.v2[:N - 1]

    # torque balance
    tau = jnp.einsum("kij,kj->ki", o.B1[:N - 1], F1) \
        + jnp.einsum("kij,kj->ki", o.B2[:N - 1], F2)
    target = jnp.stack([o.thdd[:N - 1], jnp.zeros(N - 1), jnp.zeros(N - 1)], -1)
    np.testing.assert_allclose(tau, target, atol=1e-5)

    # max normal force
    assert float(jnp.max(jnp.einsum("ki,ki->k", v1, F1))) <= o.f_max + 1e-5
    assert float(jnp.max(jnp.einsum("ki,ki->k", v2, F2))) <= o.f_max + 1e-5

    # friction cones
    for v, F in ((v1, F1), (v2, F2)):
        P = jnp.eye(3) - jnp.einsum("ki,kj->kij", v, v)
        tang = jnp.linalg.norm(jnp.einsum("kij,kj->ki", P, F), axis=-1)
        norm = o.mu * jnp.einsum("ki,ki->k", v, F)
        assert float(jnp.max(tang - norm)) <= 1e-5


def test_mpc_time_varying_constraints_lockstep(setup):
    """Warm-started grasp MPC with per-step rotated constraint windows,
    ALTRO vs conic ADMM (run_grasp_mpc, grasp_mpc.jl:7-109)."""
    o, prob, sol = setup
    N_mpc = 11
    dt = 6.0 / 60
    prob_mpc = gen_tracking_mpc(prob, sol.X, sol.U, N_mpc,
                                Qk=1e3, Rk=1.0, Qfk=10.0, dt=dt)
    # initial window constraints (k0 = 0)
    prob_mpc = prob_mpc.replace(constraints=grasp.grasp_constraints(o, N_mpc, 0))

    def constraints_fn(k):
        return grasp.grasp_constraints(o, N_mpc, k)

    T = 10
    rng = np.random.default_rng(0)
    noise = jnp.asarray(rng.standard_normal((T, 6)))
    res = run_mpc_lockstep_conic(prob_mpc, MPC_OPTS, sol.X, sol.U, noise,
                                 conic_eps=1e-8, constraints_fn=constraints_fn)
    assert int(jnp.sum(res.status[:, 0])) == T
    assert int(jnp.sum(res.status[:, 1])) == T
    assert float(jnp.max(res.viol)) < 1e-4
    # agreement at tolerance level: ALTRO at 1e-4 vs tight conic — the
    # per-step gap is O(1e-2) worst-case (control magnitudes ~2-3), matching
    # the reference's recorded err_traj behavior at loose tolerances
    assert float(jnp.max(res.err_X)) < 5e-2
    assert float(jnp.max(res.err_U)) < 5e-2
