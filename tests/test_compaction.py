"""Straggler-compaction equivalence: solve_partial + solve_resume must
reproduce the uncapped solve exactly (per-lane iterate sequences are
unchanged — every lane freezes on its own convergence), and the compacted
MPC step must match the plain batched step.

The capability has no reference counterpart (the reference solves one
problem at a time); it exists because a vmapped batch's while-loop runs
until the slowest lane converges, so wall time follows the lane-max
iteration count (SOC configs: 3-4x the lane mean).
"""
import numpy as np

import jax
import jax.numpy as jnp

import altro_mpc as at
from altro_mpc.models import random_linear, rocket
from altro_mpc.mpc import (gen_tracking_mpc, make_mpc_step,
                           make_mpc_step_compacted, run_compacted_step)
from altro_mpc.solver import altro as S


def test_partial_resume_exact_conic():
    """Capped-then-block-resumed conic solves are bit-identical to
    uncapped, including cycle-padded gather/scatter blocks."""
    prob = rocket.rocket_problem(N=31, tf=30 * 0.05, dtype=jnp.float64)
    opts = at.SolverOptions(cost_tolerance=1e-5, gradient_tolerance=1e-6,
                            constraint_tolerance=1e-4, penalty_initial=1e-2,
                            penalty_scaling=500.0, iterations_outer=40,
                            iterations_inner=100)
    rng = np.random.default_rng(0)
    x0s = (jnp.asarray(prob.x0)[None]
           + 0.1 * jnp.asarray(rng.standard_normal((8, 6))))
    U0 = rocket.hover_controls(prob)

    ref = jax.jit(jax.vmap(
        lambda x0: at.solve(prob.replace(x0=x0), opts, U0=U0)))(x0s)
    assert int(jnp.max(ref.stats.iterations)) > 10  # cap actually binds

    state = jax.jit(jax.vmap(
        lambda x0: S.solve_partial(prob.replace(x0=x0), opts, U0=U0,
                                   it_cap=10)))(x0s)
    vres = jax.jit(jax.vmap(
        lambda s: S._flat_while(prob, opts, s, None)))
    done = np.asarray(state[10])
    idx = np.nonzero(~done)[0]
    assert idx.size > 0
    for lo in range(0, idx.size, 4):
        take = np.resize(idx[lo:lo + 4], 4)  # cycle-padded like the bench
        sub = jax.tree_util.tree_map(lambda a: a[take], state)
        sub = vres(sub)
        state = jax.tree_util.tree_map(
            lambda a, b: a.at[jnp.asarray(take)].set(b), state, sub)
    fin = jax.jit(jax.vmap(lambda s: S._finalize(prob, s)))(state)
    np.testing.assert_array_equal(np.asarray(fin.U), np.asarray(ref.U))
    np.testing.assert_array_equal(np.asarray(fin.stats.iterations),
                                  np.asarray(ref.stats.iterations))
    np.testing.assert_array_equal(np.asarray(fin.stats.status),
                                  np.asarray(ref.stats.status))


def test_compacted_mpc_step_matches_plain():
    """The compacted MPC step (partial + block resume + extract) produces
    the same controls/violations/iterations as make_mpc_step(shared_k)."""
    rng = np.random.default_rng(1)
    prob = random_linear.gen_random_linear(rng, 6, 3, 41, dtype=jnp.float64)
    cold = jax.jit(at.solve)(prob, at.SolverOptions(
        cost_tolerance=1e-6, constraint_tolerance=1e-6,
        penalty_initial=1e3, penalty_scaling=100.0))
    pm = gen_tracking_mpc(prob, cold.X, cold.U, 15)
    opts = at.SolverOptions(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                            penalty_initial=1e3, penalty_scaling=100.0,
                            reset_duals=False)
    B, T = 8, 4
    noise = jnp.asarray(rng.standard_normal((T, B, 6)))

    step, init_carry = make_mpc_step(pm, opts, cold.X, cold.U, shared_k=True)
    vstep = jax.jit(jax.vmap(step, in_axes=(0, 0, None)))
    carry = jax.jit(jax.vmap(lambda _: init_carry()))(jnp.arange(B))
    ref = []
    for t in range(T):
        carry, out = vstep(carry, noise[t], jnp.asarray(t, jnp.int32))
        ref.append(out)

    pfn, rfn, efn, icc = make_mpc_step_compacted(pm, opts, cold.X, cold.U,
                                                 it_cap=1)
    jp = jax.jit(jax.vmap(pfn, in_axes=(0, 0, None)))
    jr = jax.jit(jax.vmap(rfn, in_axes=(0, None)))
    je = jax.jit(jax.vmap(efn, in_axes=(0, 0, None)))
    carry2 = jax.jit(jax.vmap(lambda _: icc()))(jnp.arange(B))
    for t in range(T):
        carry2, out2 = run_compacted_step(jp, jr, je, carry2, noise[t],
                                          jnp.asarray(t, jnp.int32), block=4)
        np.testing.assert_array_equal(np.asarray(out2.U),
                                      np.asarray(ref[t].U))
        np.testing.assert_array_equal(np.asarray(out2.iters),
                                      np.asarray(ref[t].iters))
        np.testing.assert_array_equal(np.asarray(out2.status),
                                      np.asarray(ref[t].status))


def test_device_compacted_two_level_matches_plain():
    """The device-side compacted step with a nested compaction schedule
    (capped resume + sub-block gather) is bit-identical to the plain
    batched step — caps only pause lanes, never change their iterates."""
    from altro_mpc.mpc import make_mpc_step_device_compacted

    rng = np.random.default_rng(3)
    prob = random_linear.gen_random_linear(rng, 6, 3, 41, dtype=jnp.float64)
    cold = jax.jit(at.solve)(prob, at.SolverOptions(
        cost_tolerance=1e-6, constraint_tolerance=1e-6,
        penalty_initial=1e3, penalty_scaling=100.0))
    pm = gen_tracking_mpc(prob, cold.X, cold.U, 15)
    opts = at.SolverOptions(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                            penalty_initial=1e3, penalty_scaling=100.0,
                            reset_duals=False)
    B, T = 8, 3
    noise = jnp.asarray(rng.standard_normal((T, B, 6)))

    step, init_carry = make_mpc_step(pm, opts, cold.X, cold.U, shared_k=True)
    vstep = jax.jit(jax.vmap(step, in_axes=(0, 0, None)))
    carry = jax.jit(jax.vmap(lambda _: init_carry()))(jnp.arange(B))
    ref = []
    for t in range(T):
        carry, out = vstep(carry, noise[t], jnp.asarray(t, jnp.int32))
        ref.append(out)

    # tiny caps/blocks so both compaction levels and both catch-alls engage
    bstep, icc = make_mpc_step_device_compacted(
        pm, opts, cold.X, cold.U, it_cap=1, block=4, levels=((1, 2),))
    jb = jax.jit(bstep)
    carry2 = jax.jit(jax.vmap(lambda _: icc()))(jnp.arange(B))
    for t in range(T):
        carry2, out2 = jb(carry2, noise[t], jnp.asarray(t, jnp.int32))
        np.testing.assert_array_equal(np.asarray(out2.U),
                                      np.asarray(ref[t].U))
        np.testing.assert_array_equal(np.asarray(out2.iters),
                                      np.asarray(ref[t].iters))
        np.testing.assert_array_equal(np.asarray(out2.status),
                                      np.asarray(ref[t].status))


def test_device_compacted_track_mode_matches_plain():
    """warm_start="track" (tracking-seeded solves, the r5 rocket config
    mode) composes with device-side compaction bit-identically too."""
    from altro_mpc.mpc import make_mpc_step_device_compacted

    rng = np.random.default_rng(4)
    prob = random_linear.gen_random_linear(rng, 6, 3, 41, dtype=jnp.float64)
    cold = jax.jit(at.solve)(prob, at.SolverOptions(
        cost_tolerance=1e-6, constraint_tolerance=1e-6,
        penalty_initial=1e3, penalty_scaling=100.0))
    pm = gen_tracking_mpc(prob, cold.X, cold.U, 15)
    opts = at.SolverOptions(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                            penalty_initial=1e3, penalty_scaling=100.0,
                            reset_duals=True)
    B, T = 8, 2
    noise = jnp.asarray(rng.standard_normal((T, B, 6)))

    step, init_carry = make_mpc_step(pm, opts, cold.X, cold.U,
                                     shared_k=True, warm_start="track")
    vstep = jax.jit(jax.vmap(step, in_axes=(0, 0, None)))
    carry = jax.jit(jax.vmap(lambda _: init_carry()))(jnp.arange(B))
    ref = []
    for t in range(T):
        carry, out = vstep(carry, noise[t], jnp.asarray(t, jnp.int32))
        ref.append(out)

    bstep, icc = make_mpc_step_device_compacted(
        pm, opts, cold.X, cold.U, it_cap=1, block=4, levels=((1, 2),),
        warm_start="track")
    jb = jax.jit(bstep)
    carry2 = jax.jit(jax.vmap(lambda _: icc()))(jnp.arange(B))
    for t in range(T):
        carry2, out2 = jb(carry2, noise[t], jnp.asarray(t, jnp.int32))
        np.testing.assert_array_equal(np.asarray(out2.U),
                                      np.asarray(ref[t].U))
        np.testing.assert_array_equal(np.asarray(out2.iters),
                                      np.asarray(ref[t].iters))
