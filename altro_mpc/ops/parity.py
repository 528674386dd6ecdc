"""Kernel-vs-XLA parity cases at the shipped widths.

Each case builds the inputs one batched solver phase sees, runs the kernel
and the plain XLA reference on them, and reports the largest error. The
CPU tests run the kernels in interpret mode through these functions, and
``chip_smoke.py`` runs them compiled for the GPU.

Cases:

- ``flagship``: random-linear MPC window, n=12, m=6, N=30, one bound block
  (bench.py's configuration);
- ``rocket``: rocket soft-landing window, n=6, m=3, three SOC blocks
  (max thrust, thrust angle, glideslope).

``random_linear:n:m`` is the flagship window at other dimensions.

Tolerances: the kernel and the reference evaluate the same f32 recursion
in a different order of operations (scalarised FMAs against batched
matmuls at ``highest`` precision), so K and d agree to f32 rounding
amplified by the Cholesky solves' conditioning: atol 5e-4 with rtol 1e-3.
dV1/dV2 are sums over the horizon of terms of mixed sign and take rtol
2e-3. The rollouts repeat a 30-step chain of the same arithmetic: atol
and rtol 1e-4.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

TOL_GAINS = dict(atol=5e-4, rtol=1e-3)
TOL_DV = dict(atol=1e-3, rtol=2e-3)
TOL_ROLLOUT = dict(atol=1e-4, rtol=1e-4)
LADDER = (1.0, 0.5, 0.0)


def flagship_window(N: int = 30, n: int = 12, m: int = 6, seed: int = 0):
    """Random-linear tracking MPC window (f32)."""
    from ..models import random_linear as rl

    rng = np.random.default_rng(seed)
    prob = rl.gen_random_linear(rng, n, m, N + 10, dtype=jnp.float32)
    X_track, U_track = rl.gen_trajectory(rng, prob, N + 10)
    return rl.gen_tracking_mpc(prob, X_track, U_track, N)


def rocket_window(N: int = 21):
    """Rocket soft-landing tracking window with its three SOC blocks (f32),
    around a cold solve of a short landing problem."""
    import altro_mpc as at
    from ..models import rocket
    from ..mpc import gen_tracking_mpc

    Nc = 2 * N
    prob = rocket.rocket_problem(N=Nc, tf=(Nc - 1) * 0.05,
                                 dtype=jnp.float32)
    sol = jax.jit(at.solve)(prob, at.SolverOptions(
        cost_tolerance=1e-4, constraint_tolerance=1e-3, penalty_initial=1e-2,
        penalty_scaling=500.0, iterations_outer=20, iterations_inner=30),
        U0=rocket.hover_controls(prob))
    return gen_tracking_mpc(prob, sol.X, sol.U, N, dt=0.05), sol.X, sol.U


def make_case(name: str, B: int, seed: int = 0):
    """Per-lane inputs of both kernels for case ``name`` at batch ``B``:
    iterates near the window's reference, random multipliers (all three SOC
    projection cases occur), penalty 10, regularization 0.5."""
    rng = np.random.default_rng(seed)
    if name == "flagship" or name.startswith("random_linear:"):
        # "random_linear:n:m" is the flagship window at other dimensions
        dims = (map(int, name.split(":")[1:]) if name != "flagship"
                else (12, 6))
        pm = flagship_window(*(30, *dims))
        Xr = jnp.zeros((pm.N, pm.n), jnp.float32)
        Ur = jnp.zeros((pm.N - 1, pm.m), jnp.float32)
        scale = 1.0
    elif name == "rocket":
        pm, Xs, Us = rocket_window()
        Xr, Ur = Xs[:pm.N], Us[:pm.N - 1]
        scale = 0.05
    else:
        raise ValueError(f"unknown parity case {name!r}")
    N, n, m = pm.N, pm.n, pm.m

    def noise(*shape):
        return jnp.asarray(rng.standard_normal(shape), jnp.float32)

    X = Xr[None] + scale * noise(B, N, n)
    U = Ur[None] + scale * noise(B, N - 1, m)
    duals = pm.init_duals(10.0)
    lams = tuple(jnp.abs(noise(B, *d.lam.shape)) for d in duals)
    rhos = tuple(jnp.full((B,) + d.rho.shape, 10.0, jnp.float32)
                 for d in duals)
    reg = jnp.full((B,), 0.5, jnp.float32)
    return dict(prob=pm, X=X, U=U, lams=lams, rhos=rhos, reg=reg)


def _max_err(a, b, atol, rtol):
    """(max abs error, max of |a-b| / (atol + rtol |b|)): within tolerance
    iff the second is <= 1."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    diff = np.abs(a - b)
    return float(diff.max()), float((diff / (atol + rtol * np.abs(b))).max())


def backward_parity(case, block=None, interpret=False):
    """Riccati backward kernel against the vmapped XLA scan, on the AL
    expansion of the case's iterates. Returns {output: (max abs err,
    tolerance ratio)}."""
    from ..solver.altro import backward_pass, expand_lane
    from .riccati import BLOCK, batched_backward

    pm = case["prob"]
    A, B = pm.dynamics.A, pm.dynamics.B

    with jax.default_matmul_precision("highest"):
        exp = jax.jit(jax.vmap(lambda *a: expand_lane(
            pm.cost, pm.constraints, *a)))(
                case["X"], case["U"], case["lams"], case["rhos"])
        got = jax.jit(lambda *a: batched_backward(
            A, B, *a, block=block or BLOCK, interpret=interpret))(
                *exp, case["reg"])
        ref = jax.jit(jax.vmap(lambda *a: backward_pass(A, B, *a)))(
            *exp, case["reg"])
    names = ("K", "d", "dV1", "dV2")
    tols = (TOL_GAINS, TOL_GAINS, TOL_DV, TOL_DV)
    return {k: _max_err(g, r, **t)
            for k, g, r, t in zip(names, got, ref, tols)}


def rollout_parity(case, alphas=LADDER, block=None, interpret=False):
    """Ladder-rollout kernel against per-lane, per-rung XLA scans, with the
    gains the backward pass gives at the case's iterates (a stable closed
    loop, as in the solver). Returns {output: (max abs err, tolerance
    ratio)}."""
    from ..solver.altro import _expand_backward_base, rollout_closed_loop
    from .rollout import BLOCK, batched_ls_rollout

    pm = case["prob"]
    dyn = pm.dynamics
    with jax.default_matmul_precision("highest"):
        K, d, _, _ = jax.jit(jax.vmap(lambda *a: _expand_backward_base(
            pm.cost, dyn.A, dyn.B, pm.constraints, *a)))(
                case["X"], case["U"], case["lams"], case["rhos"],
                case["reg"])
    lane = (case["X"], case["U"], K, d)
    with jax.default_matmul_precision("highest"):
        Xs, Us = jax.jit(lambda *a: batched_ls_rollout(
            dyn.A, dyn.B, dyn.d, *a, alphas, block=block or BLOCK,
            interpret=interpret))(*lane)

        def ref_one(Xb, Ub, K, d):
            return jax.vmap(lambda al: rollout_closed_loop(
                dyn, Xb, Ub, K, d, al))(jnp.asarray(alphas, Xb.dtype))

        Xr, Ur = jax.jit(jax.vmap(ref_one))(*lane)
    return {"X": _max_err(Xs, Xr, **TOL_ROLLOUT),
            "U": _max_err(Us, Ur, **TOL_ROLLOUT)}
