"""Native C++ QP/conic solver as a foreign-codebase oracle (the OSQP and
ECOS/COSMO roles, random_linear_problem.jl:68-76 / run_simple_rocket.jl:156-188)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import altro_mpc as at
from altro_mpc.native import available, solve_conic, solve_qp
from altro_mpc.solver import admm_conic, admm_qp
from altro_mpc.transcribe import to_batch_conic, to_batch_qp

pytestmark = pytest.mark.skipif(not available(),
                                reason="g++ not available to build native lib")


def test_native_box_qp():
    c = np.array([0.5, 2.0, -3.0, 0.0])
    sol = solve_qp(np.eye(4), -c, np.eye(4), -np.ones(4), np.ones(4),
                   eps_abs=1e-9)
    assert sol.status == 1
    np.testing.assert_allclose(sol.x, np.clip(c, -1, 1), atol=1e-7)


def test_native_matches_jax_admm_on_random_linear():
    """Three-way oracle: ALTRO (JAX), ADMM QP (JAX), ADMM QP (C++)."""
    from altro_mpc.models import random_linear as rl
    rng = np.random.default_rng(7)
    prob = rl.gen_random_linear(rng, 8, 3, 21)
    X_track, U_track = rl.gen_trajectory(rng, prob, 21)
    prob_mpc = rl.gen_tracking_mpc(prob, X_track, U_track, 21)

    qp = to_batch_qp(prob_mpc)
    jax_sol = admm_qp.solve(admm_qp.setup(qp), eps_abs=1e-8, max_iter=40000)
    nat_sol = solve_qp(np.asarray(qp.P), np.asarray(qp.q), np.asarray(qp.A),
                       np.asarray(qp.l), np.asarray(qp.u), eps_abs=1e-8,
                       max_iter=40000)
    assert int(jax_sol.status) == 1 and nat_sol.status == 1
    np.testing.assert_allclose(np.asarray(jax_sol.x), nat_sol.x, atol=1e-5)

    altro_sol = at.solve(prob_mpc, at.SolverOptions(
        cost_tolerance=1e-8, gradient_tolerance=1e-10,
        constraint_tolerance=1e-8, penalty_initial=1e3,
        penalty_scaling=100.0))
    Xa, Ua = altro_sol.X, altro_sol.U
    Xn, Un = admm_qp.extract_traj(qp, jnp.asarray(nat_sol.x))
    np.testing.assert_allclose(Xa, Xn, atol=1e-5)
    np.testing.assert_allclose(Ua, Un, atol=1e-5)


def _conic_three_way(prob, eps=1e-7, atol=1e-5):
    """JAX conic ADMM vs the native C++ conic oracle on one instance.

    Asserts x agreement to ``atol`` AND objective agreement to 1e-6
    relative — on ill-conditioned instances (min eig of P ~ R*dt = 5e-3 on
    the rocket window) a 1e-8 cost gap already permits ~1e-4 primal drift,
    so ``atol`` alone under-determines optimality."""
    cp = to_batch_conic(prob)
    jax_sol = admm_conic.solve(admm_conic.setup(cp), eps_abs=eps,
                               max_iter=200000)
    nat_sol = solve_conic(np.asarray(cp.P), np.asarray(cp.q),
                          np.asarray(cp.A), np.asarray(cp.b), cp.segments,
                          eps_abs=eps, max_iter=200000)
    assert int(jax_sol.status) == 1, "JAX conic ADMM did not converge"
    assert nat_sol.status == 1, (
        f"native conic oracle did not converge (rp={nat_sol.r_prim:.2e}, "
        f"rd={nat_sol.r_dual:.2e})")
    np.testing.assert_allclose(np.asarray(jax_sol.x), nat_sol.x, atol=atol)
    P, q = np.asarray(cp.P), np.asarray(cp.q)
    obj = lambda x: 0.5 * x @ P @ x + q @ x
    fj, fn = obj(np.asarray(jax_sol.x)), obj(nat_sol.x)
    assert abs(fj - fn) <= 1e-6 * max(1.0, abs(fj))
    return cp, nat_sol


def test_native_conic_soc_projection_qp():
    """Tiny SOC program with a known solution: min ||x - c||^2 s.t. x in SOC.
    Formulated as Ax + s = 0, s in SOC with A = -I, so s = x."""
    c = np.array([3.0, 4.0, 1.0])  # ||(3,4)|| = 5 > 1 -> boundary projection
    P = np.eye(3)
    q = -c
    A = -np.eye(3)
    b = np.zeros(3)
    sol = solve_conic(P, q, A, b, (("soc", 3),), eps_abs=1e-9)
    assert sol.status == 1
    # closed-form SOC projection of (v, s): ((a+s)/2a) (v, a), a = ||v||
    scale = (5.0 + 1.0) / (2 * 5.0)
    expect = np.array([3.0 * scale, 4.0 * scale, 5.0 * scale])
    np.testing.assert_allclose(sol.x, expect, atol=1e-6)


@pytest.fixture(scope="module")
def rocket_window():
    """Rocket SOC MPC-window instance — the program class the reference
    hands ECOS every MPC step (simple_rocket.jl:106-216). Built from a
    short cold solve used purely as the tracking reference."""
    from altro_mpc.models import rocket
    from altro_mpc.mpc import gen_tracking_mpc
    N = 61
    prob = rocket.rocket_problem(N=N, tf=(N - 1) * 0.05)
    cold = at.solve(prob, at.SolverOptions(
        cost_tolerance=1e-6, gradient_tolerance=1e-8,
        constraint_tolerance=1e-5, penalty_initial=1e-2,
        penalty_scaling=500.0, iterations_outer=40, iterations_inner=100),
        U0=rocket.hover_controls(prob))
    return gen_tracking_mpc(prob, cold.X, cold.U, 21, dt=0.05)


def test_native_conic_matches_jax_on_rocket(rocket_window):
    """The ECOS oracle role on the rocket SOC MPC window (thrust norm +
    thrust angle + glideslope cones). x-agreement tolerance reflects the
    instance's conditioning floor (see _conic_three_way); the cost-parity
    assertion carries the optimality claim."""
    _conic_three_way(rocket_window, eps=1e-9, atol=1e-3)


def test_native_conic_matches_jax_on_grasp():
    """The ECOS/Mosek oracle role on a grasp instance with time-varying
    torque-balance equality + max-force inequality + two SOC friction
    cones per knot (grasp_benchmark.jl:36-62)."""
    from altro_mpc.models import grasp
    N, tf = 31, 3.0
    o = grasp.make_grasp_object(N, tf)
    prob = grasp.grasp_problem(o, N, tf)
    _conic_three_way(prob)


def test_native_conic_matches_altro_on_rocket(rocket_window):
    """Cross-family check: the native conic oracle against ALTRO's conic
    AL-iLQR trajectory on the same instance."""
    cp, nat_sol = _conic_three_way(rocket_window, eps=1e-9, atol=1e-3)
    altro_sol = at.solve(rocket_window, at.SolverOptions(
        cost_tolerance=1e-8, gradient_tolerance=1e-10,
        constraint_tolerance=1e-8, penalty_initial=1e3,
        penalty_scaling=10.0, iterations_outer=30))
    assert int(altro_sol.stats.status) == 1
    Xn, Un = admm_conic.extract_traj(cp, jnp.asarray(nat_sol.x))
    np.testing.assert_allclose(altro_sol.X, Xn, atol=2e-3)
    np.testing.assert_allclose(altro_sol.U, Un, atol=2e-3)


# ---------------------------------------------------------------------------
# Native knot-structured ADMM (knot_solver.cpp) — the timing-grade
# OSQP/ECOS-role backend. Kept in algorithmic lockstep with
# solver/knot_admm.py; these tests pin that equivalence.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trot_qp():
    from altro_mpc.models.quadruped import config, controller
    from altro_mpc.solver import knot_admm

    cfg = config.MPCConfig(linearized_friction=True)
    prob, x_des = controller.build_mpc_problem(cfg)
    base = controller.make_baseline_state("admm_qp", prob, cfg, x_des,
                                          native=False)
    return base


def test_native_knot_matches_jax_iterations(trot_qp):
    """The C solver is the same algorithm at the same rho: identical
    iteration count (to the check cadence) and residual-level agreement on
    the trot QP."""
    from altro_mpc.native import qp as nqp
    from altro_mpc.solver import knot_admm

    jsol = knot_admm.solve(trot_qp, eps_abs=1e-4)
    w = nqp.knot_setup(trot_qp.qp, rho=0.1)
    # check at the Python CHUNK cadence so the stopping points coincide
    nsol = w.solve(eps_abs=1e-4, check_every=25)
    assert nsol.status == 1 and int(jsol.status) == 1
    assert nsol.iterations == int(jsol.iterations)
    # both stopped at the same tolerance on a strongly convex QP
    np.testing.assert_allclose(np.asarray(jsol.U), nsol.U, atol=0.5,
                               rtol=0.1)


def test_native_knot_tight_solution_agreement(trot_qp):
    """At tight tolerance both implementations converge to the same QP
    optimum (unique for strongly convex QPs)."""
    from altro_mpc.native import qp as nqp
    from altro_mpc.solver import knot_admm

    jsol = knot_admm.solve(trot_qp, eps_abs=1e-8, max_iter=20000)
    w = nqp.knot_setup(trot_qp.qp, rho=0.1)
    nsol = w.solve(eps_abs=1e-8, max_iter=20000)
    assert nsol.status == 1 and int(jsol.status) == 1
    np.testing.assert_allclose(np.asarray(jsol.U), nsol.U, atol=2e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(jsol.X), nsol.X, atol=2e-5)


def test_native_knot_update_and_warm_start(trot_qp):
    """update() + warm solve: same optimum as a cold tight solve, fewer
    iterations than the zero start (the OSQP warm_start=true pattern)."""
    from altro_mpc.native import qp as nqp

    w = nqp.knot_setup(trot_qp.qp, rho=0.1)
    s0 = w.solve(eps_abs=1e-6, max_iter=20000)
    assert s0.status == 1
    w.update(trot_qp.qp)           # same values: refactor path exercised
    s1 = w.solve(eps_abs=1e-6, warm=True, max_iter=20000)
    assert s1.status == 1
    assert s1.iterations <= 10     # warm start on the identical problem
    # both iterates satisfy the 1e-6 relative criterion; on a ~130 N force
    # scale that allows ~1e-4-level differences between stopping points
    np.testing.assert_allclose(s0.U, s1.U, atol=1e-3)


def test_native_knot_soc_blocks():
    """SOC friction-cone variant (ECOS role) matches the JAX knot ADMM at
    tight tolerance."""
    from altro_mpc.models.quadruped import config, controller
    from altro_mpc.native import qp as nqp
    from altro_mpc.solver import knot_admm

    cfg = config.MPCConfig(linearized_friction=False)
    prob, x_des = controller.build_mpc_problem(cfg)
    base = controller.make_baseline_state("admm_conic", prob, cfg, x_des,
                                          native=False)
    jsol = knot_admm.solve(base, eps_abs=1e-8, max_iter=30000)
    w = nqp.knot_setup(base.qp, rho=0.1)
    nsol = w.solve(eps_abs=1e-8, max_iter=30000)
    assert nsol.status == 1 and int(jsol.status) == 1
    np.testing.assert_allclose(np.asarray(jsol.U), nsol.U, atol=5e-4,
                               rtol=1e-3)


def test_native_knot_polish(trot_qp):
    """OSQP-style active-set polish (knot_solver.cpp polish_solution): a
    converged LOOSE solve (eps 1e-3) with polish=True must land near-exact
    residuals and match a tight no-polish solve's controls — the mechanism
    behind the reference OSQP's quality at speed (OSQPParams.jl:127-128)."""
    from altro_mpc.native import qp as nqp

    w = nqp.knot_setup(trot_qp.qp, rho=0.1)
    tight = w.solve(eps_abs=1e-9, max_iter=50000)
    assert tight.status == 1
    w2 = nqp.knot_setup(trot_qp.qp, rho=0.1)
    loose = w2.solve(eps_abs=1e-3, max_iter=20000, polish=False)
    pol = nqp.knot_setup(trot_qp.qp, rho=0.1).solve(
        eps_abs=1e-3, max_iter=20000, polish=True)
    assert pol.status == 1
    # polish drives residuals far below the loose termination point
    assert pol.r_prim < 1e-8 and pol.r_dual < 1e-5
    assert pol.r_prim <= loose.r_prim and pol.r_dual <= loose.r_dual
    # and the polished controls agree with the tight solve (1e-3 on a
    # ~130 N force scale, like the neighboring stopping-point tests: the
    # loose iterate's active set can differ from the optimum's by a
    # near-degenerate row, which moves U by ~1e-4 at rd ~1e-7)
    np.testing.assert_allclose(pol.U, tight.U, atol=1e-3)
