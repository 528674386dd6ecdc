"""Multi-device scale-out: scenario batches sharded over a device mesh.

The reference is single-threaded/single-process (SURVEY.md section 2.8); the
scale-out axes are:

- batch axis: ``vmap`` thousands of MPC scenarios per chip
- device axis: shard the scenario batch over a 1-D mesh with ``shard_map``;
  XLA collectives (``psum``/``pmax``) ride the interconnect for the aggregate
  residual/iteration reductions of scaling studies

Horizon sharding is intentionally absent at N <= 101 (scan Riccati is
latency-optimal there); batch sharding is the win (SURVEY.md section 5).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# check_vma=False: the solver body is purely per-scenario (no cross-device
# dataflow except the explicit psum/pmax reductions), but its scan/while
# carries initialize from literals, which trips the varying-manual-axes
# strictness check under shard_map.
from jax import shard_map as _shard_map


def shard_map(f, mesh, in_specs, out_specs):
    return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                      check_vma=False)

from ..costs import retarget_tracking
from ..mpc import shift_fill, track_window
from ..problem import Problem
from ..solver.altro import solve
from ..solver.options import SolverOptions

BATCH_AXIS = "batch"


def make_scenario_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over all (or the first n) devices, axis name 'batch'."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return jax.make_mesh((len(devs),), (BATCH_AXIS,), devices=devs)


def sharded_solve(prob: Problem, opts: SolverOptions, x0s, mesh: Mesh):
    """Solve a batch of problems differing in x0, sharded over the mesh.

    Returns (U_batch [B, N-1, m], stats aggregates). B must divide evenly by
    the mesh size. Collectives: psum of iteration counts, pmax of violation.
    """
    def local(x0_blk):
        def one(x0):
            sol = solve(prob.replace(x0=x0), opts)
            return sol.U, sol.stats.iterations, sol.stats.viol

        U, iters, viol = jax.vmap(one)(x0_blk)
        total_iters = jax.lax.psum(jnp.sum(iters), BATCH_AXIS)
        max_viol = jax.lax.pmax(jnp.max(viol), BATCH_AXIS)
        return U, total_iters, max_viol

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(BATCH_AXIS),),
                   out_specs=(P(BATCH_AXIS), P(), P()))
    return fn(x0s)


def sharded_mpc_step(prob_mpc: Problem, opts: SolverOptions, X_track, U_track,
                     mesh: Mesh):
    """Build the jittable sharded full MPC step — the framework's 'training
    step' analog: per scenario, propagate + perturb x0, advance the tracking
    window, shift primal/dual warm starts, re-solve; then psum-reduce
    aggregate health metrics across devices.

    Returns a function step(state, noise) -> (state, metrics) where state is
    (x0s [B,n], Xs [B,N,n], Us [B,N-1,m], duals-batch, k) and metrics are
    scalars reduced over the whole fleet. The carried states seed the next
    solve's warm start (exact LTI seam correction — mpc._xws_corrector —
    skipping the per-solve init rollout).
    """
    N = prob_mpc.N
    dyn = prob_mpc.dynamics
    from ..mpc import _xws_corrector
    xws = _xws_corrector(dyn)

    def one_scenario(x0, X, U, duals, k, noise_i):
        x_prop = dyn.step(x0, U[0], 0)
        x0_new = x_prop + noise_i * jnp.max(jnp.abs(x_prop)) / 100.0
        Xw, Uw = track_window(X_track, U_track, k, N)
        cost_new = retarget_tracking(prob_mpc.cost, Xw, Uw)
        prob_k = prob_mpc.replace(cost=cost_new, x0=x0_new)
        U_ws = shift_fill(U)
        X_ws = None if xws is None else xws(X, U_ws, x0_new)
        sol = solve(prob_k, opts, U0=U_ws,
                    duals=tuple(d.shift() for d in duals), X0=X_ws)
        return x0_new, sol.X, sol.U, sol.duals, sol.stats

    def local(x0_blk, X_blk, U_blk, duals_blk, k, noise_blk):
        x0n, Xn, Un, dualsn, stats = jax.vmap(
            one_scenario, in_axes=(0, 0, 0, 0, None, 0))(
                x0_blk, X_blk, U_blk, duals_blk, k, noise_blk)
        # fleet-wide aggregates over the interconnect
        total_iters = jax.lax.psum(jnp.sum(stats.iterations), BATCH_AXIS)
        max_viol = jax.lax.pmax(jnp.max(stats.viol), BATCH_AXIS)
        n_success = jax.lax.psum(jnp.sum(stats.status), BATCH_AXIS)
        return x0n, Xn, Un, dualsn, (total_iters, max_viol, n_success)

    dual_spec = jax.tree_util.tree_map(lambda _: P(BATCH_AXIS),
                                       prob_mpc.init_duals(1.0))

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(BATCH_AXIS), P(BATCH_AXIS), dual_spec,
                  P(), P(BATCH_AXIS)),
        out_specs=(P(BATCH_AXIS), P(BATCH_AXIS), P(BATCH_AXIS), dual_spec,
                   (P(), P(), P())),
    )

    def step(state, noise):
        x0s, Xs, Us, duals, k = state
        x0n, Xn, Un, dualsn, metrics = fn(x0s, Xs, Us, duals, k + 1, noise)
        return (x0n, Xn, Un, dualsn, k + 1), metrics

    return step
