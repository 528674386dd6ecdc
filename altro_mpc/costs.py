"""Quadratic trajectory objectives as static-shaped pytrees.

Mirrors the capability of TrajectoryOptimization.jl's ``LQRObjective`` /
``TrackingObjective`` (consumed by the reference at e.g.
benchmarks/random_linear_mpc/random_linear_problem.jl:19 and
benchmarks/mpc.jl:29) but stored accelerator-first: dense stacks with a leading knot
axis so every cost/expansion evaluation is one batched matmul.

Conventions
-----------
Total cost over a trajectory (X: [N, n], U: [N-1, m]):

    J = sum_k 0.5 x_k'Q_k x_k + q_k'x_k + 0.5 u_k'R_k u_k + r_k'u_k
              + u_k'H_k x_k + c_k            for k < N-1 (stage)
        + 0.5 x_T'Q_T x_T + q_T'x_T + c_T    at k = N-1 (terminal)

The reference's ``dt`` scaling of stage costs (TO evaluates stage costs
multiplied by the knot dt; see the ``q .*= dt`` in
random_linear_problem.jl:53) is folded into the stored stacks by the
constructors, so downstream code never thinks about dt.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from .utils import struct


@struct.dataclass
class QuadCost:
    """Per-knot quadratic cost stacks. R/r/H rows at the terminal knot are zero."""

    Q: jnp.ndarray  # [N, n, n]
    q: jnp.ndarray  # [N, n]
    R: jnp.ndarray  # [N, m, m]   (row N-1 unused/zero)
    r: jnp.ndarray  # [N, m]
    H: jnp.ndarray  # [N, m, n]   cross term (zero for every reference problem)
    c: jnp.ndarray  # [N]

    @property
    def N(self) -> int:
        return self.Q.shape[0]

    @property
    def n(self) -> int:
        return self.Q.shape[-1]

    @property
    def m(self) -> int:
        return self.R.shape[-1]

    # ------------------------------------------------------------------
    def stage_terms(self, x, u, k):
        """Scalar cost at knot k (traced, k may be dynamic)."""
        Q, q, R, r, H, c = (a[k] for a in (self.Q, self.q, self.R, self.r, self.H, self.c))
        return (0.5 * x @ Q @ x + q @ x + 0.5 * u @ R @ u + r @ u + u @ H @ x + c)

    def total(self, X, U):
        """Total trajectory cost, vectorized over knots (MXU-friendly)."""
        N = self.N
        Upad = jnp.concatenate([U, jnp.zeros_like(U[:1])], axis=0)  # [N, m]
        xQx = jnp.einsum("ki,kij,kj->k", X, self.Q, X)
        uRu = jnp.einsum("ki,kij,kj->k", Upad, self.R, Upad)
        uHx = jnp.einsum("ki,kij,kj->k", Upad, self.H, X)
        lin = jnp.einsum("ki,ki->k", X, self.q) + jnp.einsum("ki,ki->k", Upad, self.r)
        per_knot = 0.5 * xQx + 0.5 * uRu + uHx + lin + self.c
        return jnp.sum(per_knot)

    def expansion(self, X, U):
        """Gradients/Hessians of the cost along (X, U).

        Returns (lx [N,n], lu [N,m], lxx [N,n,n], luu [N,m,m], lux [N,m,n]).
        Row N-1 of lu/luu/lux is zero by construction.
        """
        Upad = jnp.concatenate([U, jnp.zeros_like(U[:1])], axis=0)
        lx = jnp.einsum("kij,kj->ki", self.Q, X) + self.q \
            + jnp.einsum("kji,kj->ki", self.H, Upad)
        lu = jnp.einsum("kij,kj->ki", self.R, Upad) + self.r \
            + jnp.einsum("kij,kj->ki", self.H, X)
        return lx, lu, self.Q, self.R, self.H


def _stack(mat, N):
    return jnp.broadcast_to(mat, (N,) + mat.shape)


def lqr_objective(Q, R, Qf, xf, N: int, dt: float = 1.0, uf=None) -> QuadCost:
    """LQR objective tracking the fixed goal state ``xf``.

    Parity with TO ``LQRObjective(Q, R, Qf, xf, N)``
    (random_linear_problem.jl:19, rocket_landing_problem.jl:83). Stage costs
    are scaled by ``dt`` to match TO's knot-point cost evaluation.
    """
    Q, R, Qf = jnp.asarray(Q), jnp.asarray(R), jnp.asarray(Qf)
    xf = jnp.asarray(xf)
    n, m = Q.shape[0], R.shape[0]
    uf = jnp.zeros(m, Q.dtype) if uf is None else jnp.asarray(uf)

    Qs = _stack(Q * dt, N).at[N - 1].set(Qf)
    Rs = _stack(R * dt, N).at[N - 1].set(jnp.zeros_like(R))
    qs = _stack(-(Q * dt) @ xf, N).at[N - 1].set(-Qf @ xf)
    rs = _stack(-(R * dt) @ uf, N).at[N - 1].set(jnp.zeros(m, Q.dtype))
    cs = jnp.full((N,), 0.5 * xf @ (Q * dt) @ xf + 0.5 * uf @ (R * dt) @ uf, Q.dtype)
    cs = cs.at[N - 1].set(0.5 * xf @ Qf @ xf)
    Hs = jnp.zeros((N, m, n), Q.dtype)
    return QuadCost(Q=Qs, q=qs, R=Rs, r=rs, H=Hs, c=cs)


def tracking_objective(Q, R, Qf, X_ref, U_ref, dt: float = 1.0) -> QuadCost:
    """Objective tracking a reference trajectory window.

    Parity with TO ``TrackingObjective(Q, R, Z, Qf=Qf)`` built by
    ``gen_tracking_problem`` (benchmarks/mpc.jl:29). X_ref: [N, n],
    U_ref: [N-1, m].
    """
    Q, R, Qf = jnp.asarray(Q), jnp.asarray(R), jnp.asarray(Qf)
    X_ref = jnp.asarray(X_ref)
    U_ref = jnp.asarray(U_ref)
    N, n = X_ref.shape
    m = R.shape[0]

    Qs = _stack(Q * dt, N).at[N - 1].set(Qf)
    Rs = _stack(R * dt, N).at[N - 1].set(jnp.zeros_like(R))
    Upad = jnp.concatenate([U_ref, jnp.zeros((1, m), U_ref.dtype)], axis=0)
    # parenthesize before negating: `-a.at[i].set(v)` binds as
    # `-(a.at[i].set(v))` and would flip the terminal row's sign
    qs = (-jnp.einsum("ij,kj->ki", Q * dt, X_ref)).at[N - 1].set(
        -Qf @ X_ref[N - 1])
    rs = (-jnp.einsum("ij,kj->ki", R * dt, Upad)).at[N - 1].set(
        jnp.zeros(m, R.dtype))
    cs = 0.5 * jnp.einsum("ki,ij,kj->k", X_ref, Q * dt, X_ref) \
        + 0.5 * jnp.einsum("ki,ij,kj->k", Upad, R * dt, Upad)
    cs = cs.at[N - 1].set(0.5 * X_ref[N - 1] @ Qf @ X_ref[N - 1])
    Hs = jnp.zeros((N, m, n), Q.dtype)
    return QuadCost(Q=Qs, q=qs, R=Rs, r=rs, H=Hs, c=cs)


def retarget_tracking(cost: QuadCost, X_ref, U_ref) -> QuadCost:
    """Refresh the linear terms of a tracking objective for a new reference
    window without touching Q/R stacks (the MPC hot path; parity with
    ``TO.update_trajectory!`` at random_linear_problem.jl:133).

    Assumes H == 0 (true for all reference problems).
    """
    N, m = cost.N, cost.m
    Upad = jnp.concatenate([U_ref, jnp.zeros((1, m), U_ref.dtype)], axis=0)
    # precision pinned: this runs in the MPC step outside the solver's
    # pinned context; the accelerator's reduced default precision (TF32 on
    # H100) would retarget the cost to a slightly different reference than
    # the host's
    with jax.default_matmul_precision("highest"):
        qs = -jnp.einsum("kij,kj->ki", cost.Q, X_ref)
        rs = -jnp.einsum("kij,kj->ki", cost.R, Upad)
        cs = 0.5 * jnp.einsum("ki,kij,kj->k", X_ref, cost.Q, X_ref) \
            + 0.5 * jnp.einsum("ki,kij,kj->k", Upad, cost.R, Upad)
    return cost.replace(q=qs, r=rs, c=cs)
