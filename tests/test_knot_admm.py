"""MPC-structured (block-tridiagonal) ADMM vs the dense oracles.

The knot solver is the timing-grade OSQP/ECOS role for the quadruped
(OSQPParams.jl:127-162 setup-once pattern); these tests pin it to the dense
ADMM solvers on the same instances across the QP and SOC program classes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import altro_mpc as at
from altro_mpc.solver import admm_conic, admm_qp, knot_admm
from altro_mpc.transcribe import to_batch_conic, to_batch_qp


def test_knot_matches_dense_on_random_linear():
    from altro_mpc.models import random_linear as rl
    rng = np.random.default_rng(7)
    prob = rl.gen_random_linear(rng, 8, 3, 21)
    X_track, U_track = rl.gen_trajectory(rng, prob, 21)
    pm = rl.gen_tracking_mpc(prob, X_track, U_track, 21)

    qp = to_batch_qp(pm)
    dense = admm_qp.solve(admm_qp.setup(qp), eps_abs=1e-8, max_iter=40000)
    Xd, Ud = admm_qp.extract_traj(qp, dense.x)
    ks = knot_admm.solve(knot_admm.setup(knot_admm.to_knot_qp(pm)),
                         eps_abs=1e-8, max_iter=40000)
    assert int(dense.status) == 1 and int(ks.status) == 1
    np.testing.assert_allclose(np.asarray(ks.X), np.asarray(Xd), atol=1e-6)
    np.testing.assert_allclose(np.asarray(ks.U), np.asarray(Ud), atol=1e-6)


def test_knot_matches_dense_conic_on_grasp():
    """SOC path: torque-balance equality + max-force inequality + two SOC
    friction cones per knot."""
    from altro_mpc.models import grasp
    N, tf = 31, 3.0
    o = grasp.make_grasp_object(N, tf)
    prob = grasp.grasp_problem(o, N, tf)
    cp = to_batch_conic(prob)
    dense = admm_conic.solve(admm_conic.setup(cp), eps_abs=1e-7,
                             max_iter=100000)
    Xd, Ud = admm_conic.extract_traj(cp, dense.x)
    ks = knot_admm.solve(knot_admm.setup(knot_admm.to_knot_qp(prob)),
                         eps_abs=1e-7, max_iter=100000)
    assert int(dense.status) == 1 and int(ks.status) == 1
    np.testing.assert_allclose(np.asarray(ks.U), np.asarray(Ud), atol=1e-4)


def test_knot_refactor_matches_fresh_setup():
    """refactor() (setup-once scalings + banded refactor) must solve a
    perturbed instance to the same answer as a fresh setup()."""
    from altro_mpc.models import random_linear as rl
    rng = np.random.default_rng(3)
    prob = rl.gen_random_linear(rng, 6, 2, 15)
    X_track, U_track = rl.gen_trajectory(rng, prob, 15)
    pm = rl.gen_tracking_mpc(prob, X_track, U_track, 15)
    kqp0 = knot_admm.to_knot_qp(pm)
    work0 = knot_admm.setup(kqp0)

    # perturb dynamics + x0 (the per-step relinearization pattern)
    pm2 = pm.replace(
        dynamics=pm.dynamics.replace(
            A=pm.dynamics.A * 1.01,
            d=pm.dynamics.d + 0.01),
        x0=pm.x0 + 0.05)
    kqp2 = knot_admm.to_knot_qp(pm2)
    s_ref = knot_admm.solve(knot_admm.refactor(work0, kqp2), eps_abs=1e-8,
                            max_iter=40000)
    s_fresh = knot_admm.solve(knot_admm.setup(kqp2), eps_abs=1e-8,
                              max_iter=40000)
    assert int(s_ref.status) == 1 and int(s_fresh.status) == 1
    np.testing.assert_allclose(np.asarray(s_ref.U), np.asarray(s_fresh.U),
                               atol=1e-6)


def test_knot_vmaps_over_scenarios():
    """The solver must vmap over a batch of x0 (the batched scenario axis)."""
    from altro_mpc.models import random_linear as rl
    rng = np.random.default_rng(11)
    prob = rl.gen_random_linear(rng, 6, 2, 15)
    X_track, U_track = rl.gen_trajectory(rng, prob, 15)
    pm = rl.gen_tracking_mpc(prob, X_track, U_track, 15)
    kqp = knot_admm.to_knot_qp(pm)
    work = knot_admm.setup(kqp)

    x0s = pm.x0[None, :] + jnp.asarray(
        0.1 * rng.standard_normal((4, pm.n)))

    def solve_one(x0):
        w = work.replace(qp=work.qp.replace(x0=x0))
        return knot_admm.solve(w, eps_abs=1e-6)

    batch = jax.jit(jax.vmap(solve_one))(x0s)
    assert int(jnp.min(batch.status)) == 1
    # spot-check one lane against a single solve
    single = solve_one(x0s[2])
    np.testing.assert_allclose(np.asarray(batch.U[2]),
                               np.asarray(single.U), atol=1e-8)
