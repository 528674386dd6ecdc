"""Multi-device scenario sharding on the forced 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import altro_mpc as at
from altro_mpc.models import random_linear as rl
from altro_mpc.mpc import shift_fill
from altro_mpc.parallel import make_scenario_mesh, sharded_mpc_step, sharded_solve

OPTS = at.SolverOptions(penalty_initial=1e3, penalty_scaling=100.0,
                        reset_duals=False)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    n, m, N_track, N_mpc = 6, 3, 61, 11
    prob = rl.gen_random_linear(rng, n, m, N_track)
    X_track, U_track = rl.gen_trajectory(rng, prob, N_track)
    prob_mpc = rl.gen_tracking_mpc(prob, X_track, U_track, N_mpc)
    return prob, prob_mpc, X_track, U_track


def test_devices_available():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"


def test_sharded_solve_matches_vmap(setup):
    prob, prob_mpc, X_track, U_track = setup
    mesh = make_scenario_mesh()
    B = 16
    x0s = jnp.asarray(np.random.default_rng(1).standard_normal((B, prob.n)))

    U_sharded, total_iters, max_viol = jax.jit(
        lambda x: sharded_solve(prob_mpc, OPTS, x, mesh))(x0s)

    def one(x0):
        return at.solve(prob_mpc.replace(x0=x0), OPTS).U

    U_vmap = jax.vmap(one)(x0s)
    np.testing.assert_allclose(U_sharded, U_vmap, atol=1e-8)
    assert float(max_viol) < 1e-4
    assert int(total_iters) > 0


@pytest.fixture(scope="module")
def rocket_window():
    """Small feasible rocket SOC tracking window (thrust/angle/glideslope
    cones all present) for the conic sharding cases."""
    from altro_mpc.models import rocket
    from altro_mpc.mpc import gen_tracking_mpc

    N = 41
    prob = rocket.rocket_problem(N=N, tf=(N - 1) * 0.05)
    prob = prob.replace(x0=prob.x0 / 6.0)
    cold_opts = at.SolverOptions(cost_tolerance=1e-5, gradient_tolerance=1e-6,
                                 constraint_tolerance=1e-4,
                                 penalty_initial=1e-2, penalty_scaling=500.0,
                                 iterations_outer=40, iterations_inner=100)
    cold = jax.jit(at.solve)(prob, cold_opts)
    assert int(cold.stats.status) == 1
    pm = gen_tracking_mpc(prob, cold.X, cold.U, 13, dt=0.05)
    opts = at.SolverOptions(cost_tolerance=1e-5, gradient_tolerance=1e-6,
                            constraint_tolerance=1e-4, penalty_initial=1e2,
                            penalty_scaling=10.0, reset_duals=False,
                            iterations_outer=15, iterations_inner=8,
                            reg_min=1.0, early_exact_tol=1e-3)
    return pm, cold.X, cold.U, opts


def test_sharded_conic_solve_matches_vmap(rocket_window):
    """SOC-constrained solves sharded over the mesh == the vmapped batch
    (the conic path had never run under shard_map before)."""
    pm, X_track, U_track, opts = rocket_window
    mesh = make_scenario_mesh()
    B = 16
    rng = np.random.default_rng(4)
    x0s = jnp.asarray(pm.x0)[None] + 0.02 * jnp.asarray(
        rng.standard_normal((B, pm.n)))

    U_sharded, total_iters, max_viol = jax.jit(
        lambda x: sharded_solve(pm, opts, x, mesh))(x0s)
    U_vmap = jax.vmap(lambda x0: at.solve(pm.replace(x0=x0), opts).U)(x0s)
    np.testing.assert_allclose(np.asarray(U_sharded), np.asarray(U_vmap),
                               atol=1e-8)
    assert float(max_viol) < 1e-4


def test_sharded_compacted_conic_step_matches_vmap(rocket_window):
    """The device-compacted CONIC MPC step under shard_map (compaction's
    argsort/gather/scatter runs PER SHARD) == the plain vmapped step —
    exactly where a mesh bug would hide."""
    from jax.sharding import PartitionSpec as P

    from altro_mpc.mpc import (make_mpc_step, make_mpc_step_device_compacted)
    from altro_mpc.parallel.sharding import BATCH_AXIS, shard_map

    pm, X_track, U_track, opts = rocket_window
    mesh = make_scenario_mesh()
    B, T = 16, 2
    rng = np.random.default_rng(5)
    noise = jnp.asarray(rng.standard_normal((T, B, pm.n)))

    step, init_carry = make_mpc_step(pm, opts, X_track, U_track,
                                     shared_k=True)
    vstep = jax.jit(jax.vmap(step, in_axes=(0, 0, None)))
    carry = jax.jit(jax.vmap(lambda _: init_carry()))(jnp.arange(B))
    ref = []
    for t in range(T):
        carry, out = vstep(carry, noise[t], jnp.asarray(t, jnp.int32))
        ref.append(out)

    # tiny cap/block so compaction + catch-all both engage inside a shard
    bstep, icc = make_mpc_step_device_compacted(
        pm, opts, X_track, U_track, it_cap=1, block=2)
    carry2 = jax.jit(jax.vmap(lambda _: icc()))(jnp.arange(B))
    spec = jax.tree_util.tree_map(lambda _: P(BATCH_AXIS), carry2)
    sstep = shard_map(
        lambda c, nz, k: bstep(c, nz, k), mesh,
        in_specs=(spec, P(BATCH_AXIS), P()),
        out_specs=(spec, jax.tree_util.tree_map(
            lambda _: P(BATCH_AXIS),
            jax.eval_shape(lambda c, nz, k: bstep(c, nz, k)[1],
                           carry2, noise[0], jnp.asarray(0, jnp.int32)))))
    jstep = jax.jit(sstep, static_argnums=())
    for t in range(T):
        carry2, out2 = jstep(carry2, noise[t], jnp.asarray(t, jnp.int32))
        np.testing.assert_array_equal(np.asarray(out2.U),
                                      np.asarray(ref[t].U))
        np.testing.assert_array_equal(np.asarray(out2.iters),
                                      np.asarray(ref[t].iters))
        np.testing.assert_array_equal(np.asarray(out2.status),
                                      np.asarray(ref[t].status))


def test_sharded_mpc_step_runs(setup):
    prob, prob_mpc, X_track, U_track = setup
    mesh = make_scenario_mesh()
    B = 8
    n = prob.n

    step = sharded_mpc_step(prob_mpc, OPTS, X_track, U_track, mesh)

    # initial batched cold solves
    x0s = jnp.tile(prob_mpc.x0, (B, 1))
    sol0 = jax.vmap(lambda x0: at.solve(prob_mpc.replace(x0=x0), OPTS))(x0s)
    state = (x0s, sol0.X, sol0.U, sol0.duals, jnp.asarray(0))

    rng = np.random.default_rng(2)
    jstep = jax.jit(step)
    for _ in range(3):
        noise = jnp.asarray(rng.standard_normal((B, n)))
        state, (total_iters, max_viol, n_success) = jstep(state, noise)
    assert int(n_success) == B
    assert float(max_viol) < 1e-4
