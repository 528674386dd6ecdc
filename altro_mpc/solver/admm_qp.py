"""Dense ADMM QP solver (the in-framework OSQP equivalent).

Plays the role OSQP (C, ADMM) plays in the reference (random-linear,
flexible-satellite, quadruped QP baselines; setup/update/warm-start API at
random_linear_problem.jl:68-76,149-157): an on-device lockstep cross-check
oracle and baseline timing target. Same algorithm family as OSQP:

- modified Ruiz equilibration (D/E diagonal scalings + cost scaling c),
  essential for badly-scaled problems like the quadruped MPC QP
  (state weights 5e3 against control weights 1e-3)
- splitting iteration with per-row penalty R (equality rows, l == u, get
  rho * RHO_EQ_SCALE as in OSQP):

    (P + sigma I + A' R A) xt = sigma x - q + A'(R z - y)
    z+ = clip(alpha A xt + (1-alpha) z + y / R, l, u)
    y+ = y + R (alpha A xt + (1-alpha) z - z+)

- termination on UNSCALED residuals

The KKT matrix is factored once (dense Cholesky — fine for the reference's
problem sizes, NN <= ~2k) and reused across iterations and MPC steps; the
solve loop is a bounded ``lax.while_loop``, fully jit/vmap-safe.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from ..utils import struct

from ..transcribe import BatchQP

RHO_EQ_SCALE = 1e3


@struct.dataclass
class ADMMQPWork:
    """Factored workspace (reusable across solves while P, A, rho fixed)."""

    qp: BatchQP            # original (unscaled) problem
    chol: jnp.ndarray      # Cholesky of scaled P + sigma I + A' R A
    rho_vec: jnp.ndarray   # [M] penalties (scaled space)
    sigma: jnp.ndarray
    alpha: jnp.ndarray
    D: jnp.ndarray         # [NN] variable scaling
    E: jnp.ndarray         # [M] constraint scaling
    c: jnp.ndarray         # cost scaling


@struct.dataclass
class ADMMQPSolution:
    x: jnp.ndarray         # primal [NN] (unscaled)
    z: jnp.ndarray         # Ax at solution [M]
    y: jnp.ndarray         # duals [M]
    iterations: jnp.ndarray
    r_prim: jnp.ndarray
    r_dual: jnp.ndarray
    status: jnp.ndarray    # 1 converged


def _ruiz(P, q, A, iters: int = 10):
    """Modified Ruiz equilibration (the OSQP scaling strategy)."""
    NN = P.shape[0]
    M = A.shape[0]
    dtype = P.dtype
    D = jnp.ones(NN, dtype)
    E = jnp.ones(M, dtype)
    c = jnp.ones((), dtype)

    def body(_, carry):
        D, E, c = carry
        Ps = c * (D[:, None] * P * D[None, :])
        As = E[:, None] * A * D[None, :]
        col_norm = jnp.maximum(jnp.max(jnp.abs(Ps), axis=0),
                               jnp.max(jnp.abs(As), axis=0))
        row_norm = jnp.max(jnp.abs(As), axis=1)
        # leave identically-zero rows/cols alone (masked constraint rows):
        # repeatedly "normalizing" them blows E up geometrically and
        # overflows f32.
        delta_d = jnp.where(col_norm > 1e-12,
                            1.0 / jnp.sqrt(jnp.clip(col_norm, 1e-8, 1e8)), 1.0)
        delta_e = jnp.where(row_norm > 1e-12,
                            1.0 / jnp.sqrt(jnp.clip(row_norm, 1e-8, 1e8)), 1.0)
        D = jnp.clip(D * delta_d, 1e-6, 1e6)
        E = jnp.clip(E * delta_e, 1e-6, 1e6)
        # cost normalization
        Ps = c * (D[:, None] * P * D[None, :])
        qs = c * (D * q)
        gamma = 1.0 / jnp.clip(
            jnp.maximum(jnp.mean(jnp.max(jnp.abs(Ps), axis=0)),
                        jnp.max(jnp.abs(qs))), 1e-8, 1e8)
        return D, E, c * gamma

    D, E, c = jax.lax.fori_loop(0, iters, body, (D, E, c))
    return D, E, c


def setup(qp: BatchQP, rho: float = 0.1, sigma: float = 1e-6,
          alpha: float = 1.6, scaling_iters: int = 10) -> ADMMQPWork:
    dtype = qp.P.dtype
    D, E, c = _ruiz(qp.P, qp.q, qp.A, scaling_iters)
    Ps = c * (D[:, None] * qp.P * D[None, :])
    As = E[:, None] * qp.A * D[None, :]

    eq = jnp.isclose(qp.l, qp.u)
    rho_vec = jnp.where(eq, rho * RHO_EQ_SCALE, rho).astype(dtype)
    K = Ps + sigma * jnp.eye(qp.num_vars, dtype=dtype) \
        + As.T @ (rho_vec[:, None] * As)
    chol = jax.scipy.linalg.cholesky(K, lower=True)
    return ADMMQPWork(qp=qp, chol=chol, rho_vec=rho_vec,
                      sigma=jnp.asarray(sigma, dtype),
                      alpha=jnp.asarray(alpha, dtype), D=D, E=E, c=c)


def update(work: ADMMQPWork, q=None, l=None, u=None) -> ADMMQPWork:
    """Refresh linear data without refactoring (parity with OSQP.update!)."""
    qp = work.qp
    qp = qp.replace(q=qp.q if q is None else q,
                    l=qp.l if l is None else l,
                    u=qp.u if u is None else u)
    return work.replace(qp=qp)


def refactor(work: ADMMQPWork, qp: BatchQP) -> ADMMQPWork:
    """Swap in a QP with new P/A values but the SAME structure, reusing the
    cached Ruiz scalings and penalty pattern and refactoring only the KKT —
    the reference's setup-once + in-place ``OSQP.update!(Ax=...)`` pattern
    (Woofer/MPCControl/Structs/OSQPParams.jl:127-162: OSQP refactors its
    fixed-pattern sparse KKT internally on the next solve). The scalings are
    a preconditioner, not a correctness condition, so reusing them across
    the mild per-step relinearization changes is safe."""
    dtype = qp.P.dtype
    D, E, c = work.D, work.E, work.c
    Ps = c * (D[:, None] * qp.P * D[None, :])
    As = E[:, None] * qp.A * D[None, :]
    K = Ps + work.sigma * jnp.eye(qp.num_vars, dtype=dtype) \
        + As.T @ (work.rho_vec[:, None] * As)
    chol = jax.scipy.linalg.cholesky(K, lower=True)
    return work.replace(qp=qp, chol=chol)


CHUNK = 25  # ADMM iterations between residual checks / rho adaptations


def solve(work, x0=None, y0=None, **kw):
    """Precision-pinned entry point (reduced-precision matmul passes, TF32
    on H100, stall ADMM convergence; full f32 is faster end-to-end)."""
    with jax.default_matmul_precision("highest"):
        return _solve_impl(work, x0=x0, y0=y0, **kw)


def _solve_impl(work: ADMMQPWork, x0: Optional[jnp.ndarray] = None,
          y0: Optional[jnp.ndarray] = None, eps_abs: float = 1e-5,
          eps_rel: Optional[float] = None,
          max_iter: int = 4000) -> ADMMQPSolution:
    qp = work.qp
    dtype = qp.P.dtype
    D, E, c = work.D, work.E, work.c
    NN, M = qp.num_vars, qp.A.shape[0]

    # scaled data
    Ps = c * (D[:, None] * qp.P * D[None, :])
    qs = c * (D * qp.q)
    As = E[:, None] * qp.A * D[None, :]
    ls = E * qp.l
    us = E * qp.u
    eq = jnp.isclose(qp.l, qp.u)
    eye = jnp.eye(NN, dtype=dtype)

    # warm starts map into scaled space
    x = jnp.zeros(NN, dtype) if x0 is None else x0 / D
    y = jnp.zeros(M, dtype) if y0 is None else (c / E) * y0
    z = jnp.clip(As @ x, ls, us)
    inf = jnp.asarray(jnp.inf, dtype)

    def rho_vec_of(rho):
        return jnp.where(eq, rho * RHO_EQ_SCALE, rho)

    def factor(rho):
        K = Ps + work.sigma * eye + As.T @ (rho_vec_of(rho)[:, None] * As)
        return jax.scipy.linalg.cholesky(K, lower=True)

    # OSQP termination: eps_abs + eps_rel * scale (the reference configures
    # OSQP with eps_abs = eps_rel = cost_tolerance,
    # random_linear_problem.jl:71-74)
    eps_rel_v = eps_abs if eps_rel is None else eps_rel

    def unscaled_residuals(x, z, y):
        xu = D * x
        zu = z / E
        yu = (E / c) * y
        Ax = qp.A @ xu
        Px = qp.P @ xu
        Aty = qp.A.T @ yu
        rp = jnp.max(jnp.abs(Ax - zu))
        rd = jnp.max(jnp.abs(Px + qp.q + Aty))
        sp = jnp.maximum(jnp.max(jnp.abs(Ax)), jnp.max(jnp.abs(zu)))
        sd = jnp.maximum(jnp.max(jnp.abs(Px)),
                         jnp.maximum(jnp.max(jnp.abs(Aty)),
                                     jnp.max(jnp.abs(qp.q))))
        ok = (rp < eps_abs + eps_rel_v * sp) & (rd < eps_abs + eps_rel_v * sd)
        return rp, rd, ok

    def cond(s):
        x, z, y, rho, chol, it, rp, rd, done = s
        return (~done) & (it < max_iter)

    def body(s):
        x, z, y, rho, chol, it, rp, rd, done = s
        rho_vec = rho_vec_of(rho)

        def inner(_, xyz):
            x, z, y = xyz
            rhs = work.sigma * x - qs + As.T @ (rho_vec * z - y)
            xt = jax.scipy.linalg.cho_solve((chol, True), rhs)
            Axt = As @ xt
            x_n = work.alpha * xt + (1 - work.alpha) * x
            z_hat = work.alpha * Axt + (1 - work.alpha) * z
            z_n = jnp.clip(z_hat + y / rho_vec, ls, us)
            y_n = y + rho_vec * (z_hat - z_n)
            return x_n, z_n, y_n

        x_n, z_n, y_n = jax.lax.fori_loop(0, CHUNK, inner, (x, z, y))

        # Non-finite guard (seen in f32 with aggressive rho): revert the
        # chunk and pull rho toward a safer value before refactoring.
        finite = jnp.all(jnp.isfinite(x_n)) & jnp.all(jnp.isfinite(y_n)) \
            & jnp.all(jnp.isfinite(z_n))
        x_n = jnp.where(finite, x_n, x)
        z_n = jnp.where(finite, z_n, z)
        y_n = jnp.where(finite, y_n, y)

        rp_n, rd_n, done_n = unscaled_residuals(x_n, z_n, y_n)
        done_n = done_n & finite

        # OSQP-style adaptive rho on relative scaled residuals, with
        # refactorization when rho moves meaningfully.
        Ax = As @ x_n
        rp_rel = jnp.max(jnp.abs(Ax - z_n)) / jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Ax)), jnp.max(jnp.abs(z_n))), 1e-10)
        Px = Ps @ x_n
        Aty = As.T @ y_n
        rd_rel = jnp.max(jnp.abs(Px + qs + Aty)) / jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Px)),
                        jnp.maximum(jnp.max(jnp.abs(Aty)),
                                    jnp.max(jnp.abs(qs)))), 1e-10)
        ratio = jnp.sqrt(rp_rel / jnp.maximum(rd_rel, 1e-16))
        rho_prop = jnp.clip(rho * ratio, 1e-4, 1e4)
        rho_prop = jnp.where(finite, rho_prop, jnp.maximum(rho * 0.1, 1e-4))
        adapt = (~done_n) & (
            (~finite) | (rho_prop > 5.0 * rho) | (rho_prop < rho / 5.0))
        rho_n = jnp.where(adapt, rho_prop, rho)
        chol_raw = jax.lax.cond(adapt, factor, lambda _: chol, rho_n)
        # a non-PD factorization poisons everything downstream: keep the old
        # factor (and old rho) if the new one contains non-finite entries
        chol_ok = jnp.all(jnp.isfinite(chol_raw))
        chol_n = jnp.where(chol_ok, chol_raw, chol)
        rho_n = jnp.where(chol_ok, rho_n, rho)

        out = (x_n, z_n, y_n, rho_n, chol_n, it + CHUNK, rp_n, rd_n, done_n)
        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(done, a, b), s, out)

    rho0 = jnp.asarray(work.rho_vec[jnp.argmin(eq.astype(jnp.int32))]
                       if M else 0.1, dtype)
    rho0 = jnp.where(jnp.all(eq), work.rho_vec[0] / RHO_EQ_SCALE, rho0)
    s0 = (x, z, y, rho0, work.chol, jnp.zeros((), jnp.int32), inf, inf,
          jnp.zeros((), bool))
    x, z, y, rho, chol, it, rp, rd, done = jax.lax.while_loop(cond, body, s0)
    return ADMMQPSolution(x=D * x, z=z / E, y=(E / c) * y, iterations=it,
                          r_prim=rp, r_dual=rd, status=done.astype(jnp.int32))


def extract_traj(qp: BatchQP, x):
    """Split the stacked primal into (X [N, n], U [N-1, m])."""
    n, m, N = qp.n, qp.m, qp.N
    base = jnp.arange(N) * (n + m)
    X = x[base[:, None] + jnp.arange(n)[None, :]]
    U = x[(base[:-1] + n)[:, None] + jnp.arange(m)[None, :]]
    return X, U
