"""Discrete-time dynamics models and discretization helpers.

Covers the capability of RobotDynamics.jl as used by the reference:

- ``RD.LinearModel`` (+ time-varying / affine variants) -> :class:`LTVDynamics`
- ``RD.PassThrough`` integration (model is already discrete)   -> build stacks
  directly (random_linear_problem.jl:29)
- ``RD.Exponential`` (exact ZOH via matrix exponential, rocket
  rocket_landing_problem.jl:39; flexible_sat_mpc.jl's hand-rolled ``c2d``)
  -> :func:`zoh_discretize`
- Euler ``A_d = I + A dt`` (quadruped altro_solver.jl:35-37) -> :func:`euler_discretize`
- nonlinear models + ForwardDiff Jacobians (quadruped
  linearized_dynamics.jl:46-66) -> :class:`NonlinearDynamics` with
  ``jax.jacfwd``

All shapes are static; stacks carry a leading knot axis of length N-1.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from .utils import struct


@struct.dataclass
class LTVDynamics:
    """x_{k+1} = A_k x_k + B_k u_k + d_k, k = 0..N-2. LTI models are stored
    broadcast to the horizon (tiny at N <= 101)."""

    A: jnp.ndarray  # [N-1, n, n]
    B: jnp.ndarray  # [N-1, n, m]
    d: jnp.ndarray  # [N-1, n]

    @property
    def N(self) -> int:
        return self.A.shape[0] + 1

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    @property
    def m(self) -> int:
        return self.B.shape[-1]

    def step(self, x, u, k):
        # precision pinned: dynamics propagation happens outside the
        # solver's pinned context too (MPC x0 propagation, trajectory
        # generation), and the accelerator's reduced default precision (TF32
        # on H100) there would silently desync the device's closed loop
        # from the host's
        with jax.default_matmul_precision("highest"):
            return self.A[k] @ x + self.B[k] @ u + self.d[k]

    def linearize(self, X, U):
        """(A, B, d) stacks about a trajectory — exact for linear models."""
        del X, U
        return self.A, self.B, self.d

    def rollout(self, x0, U):
        """Open-loop rollout; returns X [N, n]. Precision pinned (see step)."""
        def body(x, inp):
            A, B, d, u = inp
            x1 = A @ x + B @ u + d
            return x1, x1

        with jax.default_matmul_precision("highest"):
            _, X_tail = jax.lax.scan(body, x0, (self.A, self.B, self.d, U))
        return jnp.concatenate([x0[None], X_tail], axis=0)


@struct.dataclass
class NonlinearDynamics:
    """Discrete nonlinear dynamics ``x+ = f(params, x, u, k)``.

    ``f`` is static (hashable); ``params`` is a pytree of arrays so
    time-varying model data (e.g. the quadruped's contact schedule) can be
    refreshed per MPC step without re-jitting.
    """

    f: Callable = struct.field(pytree_node=False)
    params: any = None
    n_: int = struct.field(pytree_node=False, default=0)
    m_: int = struct.field(pytree_node=False, default=0)
    N_: int = struct.field(pytree_node=False, default=0)

    @property
    def N(self) -> int:
        return self.N_

    @property
    def n(self) -> int:
        return self.n_

    @property
    def m(self) -> int:
        return self.m_

    def step(self, x, u, k):
        return self.f(self.params, x, u, k)

    def linearize(self, X, U):
        """Per-knot (A, B, d) via jacfwd, vmapped over the horizon.

        d is the affine residual f(xbar, ubar) - A xbar - B ubar (parity with
        the quadruped's ``d = f(x, u) - A x - B u``, altro_solver.jl:37).
        """
        ks = jnp.arange(U.shape[0])
        Xs = X[:-1]

        def lin_one(x, u, k):
            A = jax.jacfwd(lambda xx: self.f(self.params, xx, u, k))(x)
            B = jax.jacfwd(lambda uu: self.f(self.params, x, uu, k))(u)
            d = self.f(self.params, x, u, k) - A @ x - B @ u
            return A, B, d

        return jax.vmap(lin_one)(Xs, U, ks)

    def rollout(self, x0, U):
        def body(carry, inp):
            x, k = carry
            u = inp
            x1 = self.f(self.params, x, u, k)
            return (x1, k + 1), x1

        (_, _), X_tail = jax.lax.scan(body, (x0, 0), U)
        return jnp.concatenate([x0[None], X_tail], axis=0)


# ----------------------------------------------------------------------------
# Discretization helpers (continuous (A, B, d) -> discrete (Ad, Bd, dd))
# ----------------------------------------------------------------------------

def zoh_discretize(A, B, dt, d=None):
    """Exact zero-order-hold discretization via one matrix exponential of the
    augmented system [[A, B, d], [0, 0, 0]].

    Parity with ``RD.Exponential`` (rocket_landing_problem.jl:39) and the
    flexible satellite's ``c2d`` (flexible_sat_mpc.jl:64) in one fused op.
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    n, m = B.shape
    has_d = d is not None
    dcol = jnp.asarray(d)[:, None] if has_d else jnp.zeros((n, 0), A.dtype)
    width = n + m + dcol.shape[1]
    top = jnp.concatenate([A, B, dcol], axis=1)
    M = jnp.concatenate([top, jnp.zeros((width - n, width), A.dtype)], axis=0)
    # pin precision: expm's squaring matmuls at the accelerator's reduced
    # default precision (TF32 on H100) would give the device a visibly
    # different discretization from the host's
    with jax.default_matmul_precision("highest"):
        E = jax.scipy.linalg.expm(M * dt)
    Ad = E[:n, :n]
    Bd = E[:n, n:n + m]
    dd = E[:n, n + m] if has_d else jnp.zeros(n, A.dtype)
    return Ad, Bd, dd


def euler_discretize(A, B, dt, d=None):
    """A_d = I + A dt, B_d = B dt (quadruped altro_solver.jl:35-37)."""
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    n = A.shape[0]
    Ad = jnp.eye(n, dtype=A.dtype) + A * dt
    Bd = B * dt
    dd = (jnp.asarray(d) * dt) if d is not None else jnp.zeros(n, A.dtype)
    return Ad, Bd, dd


def lti_dynamics(Ad, Bd, N: int, dd=None) -> LTVDynamics:
    """Broadcast a discrete LTI model to an N-knot :class:`LTVDynamics`."""
    Ad = jnp.asarray(Ad)
    Bd = jnp.asarray(Bd)
    n = Ad.shape[0]
    dd = jnp.zeros(n, Ad.dtype) if dd is None else jnp.asarray(dd)
    return LTVDynamics(
        A=jnp.broadcast_to(Ad, (N - 1,) + Ad.shape),
        B=jnp.broadcast_to(Bd, (N - 1,) + Bd.shape),
        d=jnp.broadcast_to(dd, (N - 1, n)),
    )


def rk4(f: Callable, x, u, dt, *args):
    """Classic RK4 step for continuous dynamics ``xdot = f(x, u, *args)``."""
    k1 = f(x, u, *args)
    k2 = f(x + 0.5 * dt * k1, u, *args)
    k3 = f(x + 0.5 * dt * k2, u, *args)
    k4 = f(x + dt * k3, u, *args)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
