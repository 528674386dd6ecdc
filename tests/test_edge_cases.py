"""Edge-case coverage: masked SOC rows in the conic transcription, and the
grasp visualization smoke test."""
import jax.numpy as jnp
import numpy as np

import altro_mpc as at
from altro_mpc.cones import Cone
from altro_mpc.solver import admm_conic
from altro_mpc.transcribe import to_batch_conic


def test_masked_soc_rows_do_not_constrain():
    """SOC blocks inactive at some knots produce all-zero rows (s = 0 is on
    the cone boundary -> trivially feasible); the conic solve must behave as
    if those knots had no constraint."""
    n, m, N = 3, 2, 6
    import jax
    A = jax.random.normal(jax.random.PRNGKey(0), (n, n)) * 0.3 \
        + jnp.eye(n) * 0.7
    B = jax.random.normal(jax.random.PRNGKey(1), (n, m))
    dyn = at.lti_dynamics(A, B, N)
    cost = at.lqr_objective(jnp.eye(n), jnp.eye(m) * 1e-3, jnp.eye(n) * 10,
                            jnp.zeros(n), N)
    x0 = jnp.ones(n) * 3.0

    # SOC active only on the first two knots
    con_masked = at.norm_constraint(N, n, m, 0.3, on="control",
                                    start=0, stop=2)
    prob = at.Problem(dynamics=dyn, cost=cost, constraints=(con_masked,),
                      x0=x0)

    cp = to_batch_conic(prob)
    sol = admm_conic.solve(admm_conic.setup(cp), eps_abs=1e-9)
    assert int(sol.status) == 1
    X, U = admm_conic.extract_traj(cp, sol.x)
    norms = np.linalg.norm(np.asarray(U), axis=-1)
    # bound holds on the masked-active knots...
    assert norms[0] <= 0.3 + 1e-6 and norms[1] <= 0.3 + 1e-6
    # ...and is exceeded later (so the masked rows really don't constrain)
    assert norms[2:].max() > 0.3

    # ALTRO agrees
    asol = at.solve(prob, at.SolverOptions(constraint_tolerance=1e-7,
                                           penalty_initial=1e2,
                                           penalty_scaling=10.0))
    np.testing.assert_allclose(asol.U, U, atol=1e-4)


def test_grasp_visualization_smoke(tmp_path):
    from altro_mpc.models import grasp, grasp_viz

    N, tf = 31, 3.0
    o = grasp.make_grasp_object(N, tf)
    prob = grasp.grasp_problem(o, N, tf)
    sol = at.solve(prob, at.SolverOptions(
        constraint_tolerance=1e-4, penalty_initial=10.0, penalty_scaling=10.0,
        iterations_outer=20), U0=grasp.hover_controls(o, N))
    path = str(tmp_path / "grasp.png")
    grasp_viz.plot_grasp_trajectory(o, sol.X, sol.U, path)
    import os
    assert os.path.getsize(path) > 1000
