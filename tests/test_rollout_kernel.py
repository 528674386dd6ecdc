"""Line-search ladder rollout: the custom_vmap XLA path and the Triton
kernel (interpret mode) vs explicit per-scenario rollouts. The compiled
kernel runs in chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np

import altro_mpc as at
from altro_mpc.ops.rollout import batched_ls_rollout
from altro_mpc.solver.altro import _ls_rollouts_fn, rollout_closed_loop


def test_ls_rollouts_match_reference():
    n, m, N, Bt = 5, 3, 13, 4
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 8)
    # shared dynamics (the kernel's contract), per-lane iterates and gains
    A = jax.random.normal(ks[0], (N - 1, n, n)) * 0.3
    B = jax.random.normal(ks[1], (N - 1, n, m)) * 0.4
    dd = jax.random.normal(ks[2], (N - 1, n)) * 0.1
    Xb = jax.random.normal(ks[3], (Bt, N, n))
    Ub = jax.random.normal(ks[4], (Bt, N - 1, m))
    K = jax.random.normal(ks[5], (Bt, N - 1, m, n)) * 0.2
    dff = jax.random.normal(ks[6], (Bt, N - 1, m)) * 0.5
    alphas = tuple(0.5 ** i for i in range(6))

    fn = _ls_rollouts_fn(alphas)
    Xs, Us = jax.vmap(fn, in_axes=(None, None, None, 0, 0, 0, 0))(
        A, B, dd, Xb, Ub, K, dff)
    assert Xs.shape == (Bt, 6, N, n)
    assert Us.shape == (Bt, 6, N - 1, m)
    Xk, Uk = batched_ls_rollout(
        A.astype(jnp.float32), B.astype(jnp.float32),
        dd.astype(jnp.float32), *(a.astype(jnp.float32)
                                  for a in (Xb, Ub, K, dff)),
        alphas, interpret=True)

    # reference: explicit rollout per (scenario, alpha)
    dyn = at.LTVDynamics(A=A, B=B, d=dd)
    for b in (0, Bt - 1):
        for idx in (0, len(alphas) - 1):
            Xr, Ur = rollout_closed_loop(dyn, Xb[b], Ub[b], K[b], dff[b],
                                         alphas[idx])
            np.testing.assert_allclose(Xs[b, idx], Xr, atol=1e-10)
            np.testing.assert_allclose(Us[b, idx], Ur, atol=1e-10)
            np.testing.assert_allclose(Xk[b, idx], Xr, atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(Uk[b, idx], Ur, atol=1e-4, rtol=1e-4)


def test_solver_unchanged_with_fused_path():
    """End-to-end: the LTV fused line-search path gives the same solves."""
    n, m, N = 4, 2, 15
    key = jax.random.PRNGKey(5)
    A = jax.random.normal(key, (n, n)) * 0.3 + jnp.eye(n) * 0.7
    B = jax.random.normal(jax.random.PRNGKey(6), (n, m)) * 0.5
    dyn = at.lti_dynamics(A, B, N)
    cost = at.lqr_objective(jnp.eye(n), jnp.eye(m) * 0.1, jnp.eye(n) * 5,
                            jnp.zeros(n), N)
    cons = (at.bound_constraint(N, n, m, u_min=-1.0, u_max=1.0),)
    x0s = jax.random.normal(jax.random.PRNGKey(7), (4, n)) * 2.0
    opts = at.SolverOptions(penalty_initial=1e2, penalty_scaling=10.0)

    sols = jax.jit(jax.vmap(lambda x0: at.solve(
        at.Problem(dynamics=dyn, cost=cost, constraints=cons, x0=x0),
        opts)))(x0s)
    assert int(jnp.sum(sols.stats.status)) == 4
    assert float(jnp.max(sols.stats.viol)) < 1e-4
