"""Flexible-satellite attitude MPC benchmark (benchmark 4).

Parity with benchmarks/flexible_satellite/flexible_sat_mpc.jl:59-166:
12-state analytic flexible-spacecraft model (MRP attitude kinematics row,
rigid-body row coupled to 3 flexible modes via momentum-coupling matrices,
modal damping/stiffness), exact ZOH discretization at dt=0.5, N=80 regulator
with Q=10I, R=0.1I, +-0.01 control bounds.

The reference's MPC loop (flexible_sat_mpc.jl:242-308) is a *regulator*:
each step only refreshes x0 (propagated + 2e-4 noise) and re-solves — no
warm-start shifting (the shift lines are commented out) — so the runner here
is :func:`run_regulator_mpc`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..constraints import bound_constraint
from ..costs import lqr_objective
from ..dynamics import lti_dynamics, zoh_discretize
from ..problem import Problem
from ..solver.altro import solve
from ..solver.options import SolverOptions
from ..mpc import MPCResults, shift_fill


def flexsat_AB(dtype=jnp.float64):
    """Analytic continuous (A, B) and their ZOH discretization at dt=0.5
    (generate_AB, flexible_sat_mpc.jl:71-130)."""
    J = np.diag([1.0, 2.0, 3.0])
    B_sc = np.eye(3)
    phi = np.array([[0, 1, 0], [1, 0, 0], [0, 0.2, -0.8]])  # noqa: F841
    delta = np.array([[0, 0, 1], [0, 1, 0], [-0.7, 0.1, 0.1]])
    T = np.linalg.inv(J - delta.T @ delta)
    j = 3
    zeta = np.array([0.001, 0.001, 0.001])
    Delta = np.array([0.05, 0.2, 0.125]) * (2 * np.pi)
    C = np.diag(2 * zeta * Delta)
    K = np.diag(Delta**2)

    Z33, Z3j = np.zeros((3, 3)), np.zeros((3, j))
    A = np.block([
        [Z33, 0.25 * np.eye(3), Z3j, Z3j],
        [Z33, Z33, T @ delta.T @ K, T @ delta.T @ C],
        [Z3j.T, Z3j.T, np.zeros((j, j)), np.eye(j)],
        [Z3j.T, Z3j.T, -K - delta @ T @ delta.T @ K,
         -C - delta @ T @ delta.T @ C],
    ])
    B = np.vstack([Z33, -T @ B_sc, Z3j, delta @ T @ B_sc])
    Ad, Bd, _ = zoh_discretize(jnp.asarray(A, dtype), jnp.asarray(B, dtype), 0.5)
    return Ad, Bd


def flexsat_problem(N: int = 80, u_bnd: float = 0.01,
                    dtype=jnp.float64) -> Problem:
    """N=80 regulator from x0 = [.1,.1,.1,0...], Q=10I, R=0.1I, Qf=Q
    (flexible_sat_mpc.jl:133-166). Stage costs carry the reference's dt=0.1
    knot scaling."""
    Ad, Bd = flexsat_AB(dtype)
    n, m = Bd.shape
    x0 = jnp.zeros(n, dtype).at[:3].set(0.1)
    xf = jnp.zeros(n, dtype)
    Q = 10.0 * jnp.eye(n, dtype=dtype)
    R = 0.1 * jnp.eye(m, dtype=dtype)
    dyn = lti_dynamics(Ad, Bd, N)
    cost = lqr_objective(Q, R, Q, xf, N, dt=0.1)
    cons = (bound_constraint(N, n, m, u_min=-u_bnd, u_max=u_bnd, dtype=dtype),)
    return Problem(dynamics=dyn, cost=cost, constraints=cons, x0=x0)


def run_regulator_mpc(prob: Problem, opts: SolverOptions, noise,
                      noise_scale: float = 2e-4) -> MPCResults:
    """Regulator MPC: propagate x0 through the first control + additive
    noise, re-solve with warm primals (flexible_sat_mpc.jl:261-276; no
    shifting, duals reset per opts)."""
    dyn = prob.dynamics
    sol0 = solve(prob, opts)

    def step(carry, noise_i):
        x0, U, duals = carry
        x0_new = dyn.step(x0, U[0], 0) + noise_scale * noise_i
        sol = solve(prob.replace(x0=x0_new), opts, U0=U, duals=duals)
        out = MPCResults(X=sol.X, U=sol.U, iters=sol.stats.iterations,
                         status=sol.stats.status, viol=sol.stats.viol,
                         x0=x0_new)
        return (x0_new, sol.U, sol.duals), out

    _, results = jax.lax.scan(step, (prob.x0, sol0.U, sol0.duals), noise)
    return results
