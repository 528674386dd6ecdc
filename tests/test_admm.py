"""ADMM QP / conic solver unit tests: analytic solutions + KKT residuals."""
import jax
import jax.numpy as jnp
import numpy as np

import altro_mpc as at
from altro_mpc.cones import Cone
from altro_mpc.solver import admm_conic, admm_qp
from altro_mpc.transcribe import BatchConic, BatchQP


def test_box_qp_analytic():
    # min 0.5||x - c||^2 s.t. -1 <= x <= 1  ->  x* = clip(c, -1, 1)
    NN = 4
    c = jnp.array([0.5, 2.0, -3.0, 0.0])
    qp = BatchQP(P=jnp.eye(NN), q=-c, A=jnp.eye(NN),
                 l=-jnp.ones(NN), u=jnp.ones(NN), n=NN, m=0, N=1)
    work = admm_qp.setup(qp)
    sol = admm_qp.solve(work, eps_abs=1e-8)
    np.testing.assert_allclose(sol.x, jnp.clip(c, -1, 1), atol=1e-6)
    assert int(sol.status) == 1


def test_eq_qp_kkt():
    # Random strictly convex QP with equality constraints: verify KKT.
    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    NN, ME = 8, 3
    L = jax.random.normal(k1, (NN, NN))
    P = L @ L.T + jnp.eye(NN)
    q = jax.random.normal(k2, (NN,))
    A = jax.random.normal(k3, (ME, NN))
    b = jax.random.normal(k4, (ME,))
    qp = BatchQP(P=P, q=q, A=A, l=b, u=b, n=NN, m=0, N=1)
    sol = admm_qp.solve(admm_qp.setup(qp), eps_abs=1e-9)
    # KKT: Px + q + A'y = 0, Ax = b
    np.testing.assert_allclose(P @ sol.x + q + A.T @ sol.y,
                               jnp.zeros(NN), atol=1e-6)
    np.testing.assert_allclose(A @ sol.x, b, atol=1e-7)


def test_conic_matches_qp_on_box():
    # Same box QP expressed in conic form (nonneg slack rows).
    NN = 4
    c = jnp.array([0.5, 2.0, -3.0, 0.0])
    # x <= 1  and  -x <= 1
    A = jnp.concatenate([jnp.eye(NN), -jnp.eye(NN)], axis=0)
    b = jnp.ones(2 * NN)
    prob = BatchConic(P=jnp.eye(NN), q=-c, A=A, b=b,
                      segments=((Cone.NONPOS, 2 * NN),), n=NN, m=0, N=1)
    sol = admm_conic.solve(admm_conic.setup(prob), eps_abs=1e-8)
    np.testing.assert_allclose(sol.x, jnp.clip(c, -1, 1), atol=1e-6)


def test_conic_soc_projection_problem():
    # min 0.5||x - c||^2 s.t. ||x[:2]|| <= x[2]  ->  x* = proj_SOC(c)
    from altro_mpc.cones import project_soc
    c = jnp.array([3.0, 4.0, 1.0])
    # SOC membership of x itself: b - Ax = x in SOC -> A = -I, b = 0
    prob = BatchConic(P=jnp.eye(3), q=-c, A=-jnp.eye(3), b=jnp.zeros(3),
                      segments=((Cone.SOC, 3),), n=3, m=0, N=1)
    sol = admm_conic.solve(admm_conic.setup(prob), eps_abs=1e-9)
    np.testing.assert_allclose(sol.x, project_soc(c), atol=1e-6)


def test_transcription_qp_matches_altro_unconstrained():
    """Batch QP of an unconstrained LQR problem: ADMM and ALTRO agree."""
    n, m, N = 4, 2, 11
    key = jax.random.PRNGKey(1)
    A = jax.random.normal(key, (n, n)) * 0.3 + jnp.eye(n) * 0.5
    B = jax.random.normal(jax.random.PRNGKey(2), (n, m))
    x0 = jnp.array([1.0, -2.0, 0.5, 0.3])

    dyn = at.lti_dynamics(A, B, N)
    cost = at.lqr_objective(jnp.eye(n), jnp.eye(m) * 0.1, jnp.eye(n) * 5,
                            jnp.zeros(n), N)
    prob = at.Problem(dynamics=dyn, cost=cost, constraints=(), x0=x0)

    sol_altro = at.solve(prob, at.SolverOptions(cost_tolerance=1e-10,
                                                gradient_tolerance=1e-10))
    from altro_mpc.transcribe import to_batch_qp
    qp = to_batch_qp(prob)
    sol_qp = admm_qp.solve(admm_qp.setup(qp), eps_abs=1e-9)
    Xq, Uq = admm_qp.extract_traj(qp, sol_qp.x)
    np.testing.assert_allclose(sol_altro.X, Xq, atol=1e-5)
    np.testing.assert_allclose(sol_altro.U, Uq, atol=1e-5)
