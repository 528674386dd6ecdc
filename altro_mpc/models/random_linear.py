"""Random marginally-stable linear MPC benchmark (benchmark 1).

Parity with benchmarks/random_linear_mpc/random_linear.jl:4-65 and
random_linear_problem.jl:5-32: random orthogonal-similarity spectra,
controllability-checked (A, B), diagonal LQR costs, +-3 control bounds,
and a random-control tracking trajectory (run_random_linear.jl:29-39).

Exact Julia RNG streams cannot be replicated; distributions are matched
(SURVEY.md section 7 "Hard parts").
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constraints import bound_constraint
from ..costs import lqr_objective, tracking_objective
from ..dynamics import LTVDynamics, lti_dynamics
from ..problem import Problem


def gen_marginally_stable(rng: np.random.Generator, n: int, m: int,
                          tol: float = 1e-4, max_iter: int = 20):
    """Discrete (A, B): A = Q diag(v) Q' with random orthogonal Q and spectrum
    scaled to spectral radius 1/(1+tol); B ~ N(0,1); retried until
    controllable (random_linear.jl:26-65)."""
    import warnings

    best = None
    for _ in range(max_iter):
        v = rng.standard_normal(n)
        v = v / (np.max(np.abs(v)) + tol)
        X = rng.standard_normal((n, n))
        Q, _ = np.linalg.qr(X)
        A = Q @ np.diag(v) @ Q.T
        B = rng.standard_normal((n, m))
        # controllability matrix rank check
        R = np.zeros((n, n * m))
        Ak = np.eye(n)
        for k in range(n):
            R[:, k * m:(k + 1) * m] = Ak @ B
            Ak = Ak @ A
        best = (A, B)
        if np.linalg.matrix_rank(R) == n:
            return A, B
    # At large n the controllability matrix's singular values decay
    # exponentially, so the numerical rank check fails even though random
    # systems are controllable with probability 1 — accept the candidate
    # (the reference's state-dim sweep reaches n=55 the same way).
    warnings.warn(f"controllability rank check failed numerically at n={n}; "
                  "accepting the last candidate system")
    return best


def gen_random_linear(rng: np.random.Generator, n: int, m: int, N: int,
                      dt: float = 0.1, dtype=jnp.float64) -> Problem:
    """LQR problem with Q = diag(10 rand(n)), R = 0.1 I, Qf = Q (N-1),
    +-3 control bounds, x0 = xf = 0 (random_linear_problem.jl:5-32)."""
    A, B = gen_marginally_stable(rng, n, m)
    Q = np.diag(10 * rng.random(n))
    R = 0.1 * np.eye(m)
    Qf = Q * (N - 1)

    dyn = lti_dynamics(jnp.asarray(A, dtype), jnp.asarray(B, dtype), N)
    cost = lqr_objective(jnp.asarray(Q, dtype), jnp.asarray(R, dtype),
                         jnp.asarray(Qf, dtype), jnp.zeros(n, dtype), N, dt=dt)
    cons = (bound_constraint(N, n, m, u_min=-3.0, u_max=3.0, dtype=dtype),)
    return Problem(dynamics=dyn, cost=cost, constraints=cons,
                   x0=jnp.zeros(n, dtype))


def gen_trajectory(rng: np.random.Generator, prob: Problem, N: int
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Tracking reference: rollout of N-1 standard-normal controls from x = 0
    (run_random_linear.jl:29-39). Returns (X_track [N,n], U_track [N-1,m])."""
    dtype = prob.x0.dtype
    U = jnp.asarray(rng.standard_normal((N - 1, prob.m)), dtype)
    A, B = prob.dynamics.A[0], prob.dynamics.B[0]
    dyn = lti_dynamics(A, B, N)
    # pin precision: at the accelerator's reduced default precision (TF32
    # on H100) the matmul passes drift a marginally-stable rollout,
    # silently giving the device a different tracking reference from the
    # host's (solutions then disagree with CPU oracles by that offset)
    with jax.default_matmul_precision("highest"):
        X = dyn.rollout(jnp.zeros(prob.n, dtype), U)
    return X, U


def gen_tracking_mpc(prob: Problem, X_track, U_track, N_mpc: int,
                     Qk: float = 10.0, Rk: float = 0.1, Qfk: float = None,
                     dt: float = 0.1) -> Problem:
    """See :func:`altro_mpc.mpc.gen_tracking_mpc` (generic across models)."""
    from ..mpc import gen_tracking_mpc as _gen
    return _gen(prob, X_track, U_track, N_mpc, Qk=Qk, Rk=Rk, Qfk=Qfk, dt=dt)
