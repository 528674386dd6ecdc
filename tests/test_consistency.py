"""Cross-component consistency oracles: the batch transcription, the cost
stacks, constraint evaluation, and the warm-start utilities must all agree
on the same problem."""
import jax
import jax.numpy as jnp
import numpy as np

import altro_mpc as at
from altro_mpc.costs import retarget_tracking, tracking_objective
from altro_mpc.mpc import shift_fill, track_window
from altro_mpc.models import random_linear as rl
from altro_mpc.transcribe import to_batch_conic, to_batch_qp


def _problem(N=13, n=5, m=2, seed=0):
    rng = np.random.default_rng(seed)
    prob = rl.gen_random_linear(rng, n, m, N)
    X_track, U_track = rl.gen_trajectory(rng, prob, N)
    return prob, X_track, U_track


def _stack(X, U):
    n = X.shape[1]
    m = U.shape[1]
    zs = [jnp.concatenate([X[k], U[k]]) for k in range(U.shape[0])]
    zs.append(X[-1])
    return jnp.concatenate(zs)


def test_qp_objective_matches_cost_total():
    """0.5 z'Pz + q'z (+const) == cost.total along any trajectory."""
    prob, X_track, U_track = _problem()
    qp = to_batch_qp(prob)
    rng = np.random.default_rng(1)
    for _ in range(3):
        U = jnp.asarray(rng.standard_normal((prob.N - 1, prob.m)))
        X = prob.dynamics.rollout(prob.x0, U)
        z = _stack(X, U)
        J_qp = 0.5 * z @ qp.P @ z + qp.q @ z + jnp.sum(prob.cost.c)
        np.testing.assert_allclose(float(J_qp),
                                   float(prob.cost.total(X, U)), rtol=1e-10)


def test_qp_rows_match_constraint_evaluate():
    """The transcribed constraint rows reproduce block.evaluate residuals."""
    prob, _, _ = _problem()
    qp = to_batch_qp(prob)
    rng = np.random.default_rng(2)
    U = jnp.asarray(rng.standard_normal((prob.N - 1, prob.m)))
    X = prob.dynamics.rollout(prob.x0, U)
    z = _stack(X, U)
    Az = qp.A @ z
    # dynamics + x0 rows are exactly satisfied on a rollout
    nd = prob.N * prob.n
    np.testing.assert_allclose(Az[:nd], np.asarray(qp.l[:nd]), atol=1e-9)
    # bound rows: Az - u == c (residual of the NONPOS block)
    con = prob.constraints[0]
    c = con.evaluate(X, U) * con.mask[:, None]
    np.testing.assert_allclose(np.asarray(Az[nd:] - qp.u[nd:]).reshape(-1),
                               np.asarray(c).reshape(-1), atol=1e-9)


def test_conic_and_qp_transcriptions_agree():
    prob, _, _ = _problem()
    qp = to_batch_qp(prob)
    cp = to_batch_conic(prob)
    np.testing.assert_allclose(qp.P, cp.P)
    np.testing.assert_allclose(qp.q, cp.q)


def test_retarget_tracking_equals_rebuild():
    prob, X_track, U_track = _problem(N=21)
    N_mpc = 11
    cost0 = tracking_objective(jnp.eye(prob.n) * 10, jnp.eye(prob.m) * 0.1,
                               jnp.eye(prob.n) * 10, X_track[:N_mpc],
                               U_track[:N_mpc - 1], dt=0.1)
    k0 = 4
    Xw, Uw = track_window(X_track, U_track, jnp.asarray(k0), N_mpc)
    re = retarget_tracking(cost0, Xw, Uw)
    rebuilt = tracking_objective(jnp.eye(prob.n) * 10, jnp.eye(prob.m) * 0.1,
                                 jnp.eye(prob.n) * 10,
                                 X_track[k0:k0 + N_mpc],
                                 U_track[k0:k0 + N_mpc - 1], dt=0.1)
    for a, b in zip(jax.tree_util.tree_leaves(re),
                    jax.tree_util.tree_leaves(rebuilt)):
        np.testing.assert_allclose(a, b, atol=1e-12)


def test_shift_fill_semantics():
    x = jnp.arange(12.0).reshape(4, 3)
    s = shift_fill(x)
    np.testing.assert_allclose(s[:-1], x[1:])
    np.testing.assert_allclose(s[-1], x[-1])


def test_dual_shift_semantics():
    prob, _, _ = _problem()
    duals = prob.init_duals(10.0)
    d = duals[0].replace(lam=jnp.arange(float(duals[0].lam.size))
                         .reshape(duals[0].lam.shape))
    s = d.shift()
    np.testing.assert_allclose(s.lam[:-1], d.lam[1:])
    np.testing.assert_allclose(s.lam[-1], d.lam[-1])
    np.testing.assert_allclose(s.rho, d.rho)  # penalties untouched by shift
