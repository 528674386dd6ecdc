"""Parity: the kernel path of the expansion + backward boundary (XLA AL
expansion, then the Triton Riccati backward kernel in interpret mode) vs
the composed XLA path. The compiled kernel runs in chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np

import altro_mpc as at
from altro_mpc.models import random_linear as rl
from altro_mpc.ops.riccati import batched_backward
from altro_mpc.solver.altro import _expand_backward_base, expand_lane


def _kernel_path(pm, X, U, lams, rhos, reg):
    exp = jax.vmap(lambda *a: expand_lane(pm.cost, pm.constraints, *a))(
        X, U, lams, rhos)
    return batched_backward(pm.dynamics.A, pm.dynamics.B, *exp, reg,
                            interpret=True)


def _check(pm, X, U, lams, rhos, reg):
    K_f, d_f, dV1_f, dV2_f = _kernel_path(pm, X, U, lams, rhos, reg)
    K_b, d_b, dV1_b, dV2_b = jax.vmap(
        _expand_backward_base,
        in_axes=(None, None, None, None, 0, 0, 0, 0, 0))(
        pm.cost, pm.dynamics.A, pm.dynamics.B, pm.constraints,
        X, U, lams, rhos, reg)

    np.testing.assert_allclose(K_f, K_b, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(d_f, d_b, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(dV1_f, dV1_b, rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(dV2_f, dV2_b, rtol=2e-3, atol=1e-3)


def test_fused_matches_base():
    Bt = 4
    rng = np.random.default_rng(0)
    prob = rl.gen_random_linear(rng, 5, 3, 9, dtype=jnp.float32)
    X_track, U_track = rl.gen_trajectory(rng, prob, 9)
    prob_mpc = rl.gen_tracking_mpc(prob, X_track, U_track, 7)
    N, n, m = prob_mpc.N, prob_mpc.n, prob_mpc.m

    X = jnp.asarray(rng.standard_normal((Bt, N, n)), jnp.float32)
    U = jnp.asarray(rng.standard_normal((Bt, N - 1, m)), jnp.float32)
    duals = prob_mpc.init_duals(10.0)
    lams = tuple(
        jnp.asarray(rng.standard_normal((Bt,) + d.lam.shape), jnp.float32)
        for d in duals)
    # NONPOS multipliers live in the nonnegative orthant
    lams = tuple(jnp.abs(l) for l in lams)
    rhos = tuple(jnp.full((Bt,) + d.rho.shape, 10.0, jnp.float32)
                 for d in duals)
    reg = jnp.zeros((Bt,), jnp.float32)
    _check(prob_mpc, X, U, lams, rhos, reg)


def test_fused_matches_base_soc_rocket():
    """SOC cones on the kernel path (rocket thrust/angle/glideslope:
    control SOC, state SOC, all three projection cases exercised by random
    multipliers) vs the composed XLA path."""
    from altro_mpc.models import rocket
    from altro_mpc.mpc import gen_tracking_mpc

    Bt = 4
    rng = np.random.default_rng(1)
    Nc = 41
    prob = rocket.rocket_problem(N=Nc, tf=(Nc - 1) * 0.05,
                                 dtype=jnp.float32)
    sol = at.solve(prob, at.SolverOptions(
        cost_tolerance=1e-4, constraint_tolerance=1e-3, penalty_initial=1e-2,
        penalty_scaling=500.0, iterations_outer=20, iterations_inner=30),
        U0=rocket.hover_controls(prob))
    pm = gen_tracking_mpc(prob, sol.X, sol.U, 13, dt=0.05)
    N, n, m = pm.N, pm.n, pm.m

    X = sol.X[None, :N] + 0.05 * jnp.asarray(
        rng.standard_normal((Bt, N, n)), jnp.float32)
    U = sol.U[None, :N - 1] + 0.05 * jnp.asarray(
        rng.standard_normal((Bt, N - 1, m)), jnp.float32)
    duals = pm.init_duals(10.0)
    lams = tuple(
        jnp.asarray(rng.standard_normal((Bt,) + d.lam.shape), jnp.float32)
        for d in duals)
    rhos = tuple(jnp.full((Bt,) + d.rho.shape, 10.0, jnp.float32)
                 for d in duals)
    reg = jnp.full((Bt,), 1.0, jnp.float32)
    _check(pm, X, U, lams, rhos, reg)
