"""Dense ADMM conic solver (the in-framework ECOS/COSMO/Mosek-role baseline).

Plays the role the interior-point/ADMM SOCP solvers play in the reference
(rocket: simple_rocket.jl:109-114; grasp: grasp_benchmark.jl:36-62; quadruped
ECOS backend): an on-device cross-check oracle for conic problems. COSMO-style
ADMM on

    min 0.5 z'Pz + q'z   s.t.  Az + s = b,  s in K
    (K = product of zero cones, the nonnegative orthant, and SOCs)

with splitting variable w = s:

    (P + rho A'A) z+ = -q + rho A'(b - w - y/rho)
    w+ = proj_K(b - A z+ - y / rho)
    y+ = y + rho (A z+ + w+ - b)

Zero-cone rows (equalities) use rho * RHO_EQ_SCALE. KKT factored once by
dense Cholesky; bounded while_loop, jit/vmap-safe.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from ..utils import struct

from ..cones import Cone, project_soc
from ..transcribe import BatchConic

RHO_EQ_SCALE = 1e3


def _project_K(segments, v):
    """Project onto the cone product. ``segments`` is static metadata, so
    this unrolls into a few fused slice ops."""
    out = []
    off = 0
    for cone, length in segments:
        seg = jax.lax.dynamic_slice_in_dim(v, off, length)
        if cone == Cone.ZERO:
            out.append(jnp.zeros_like(seg))
        elif cone == Cone.NONPOS:
            out.append(jnp.maximum(seg, 0.0))
        elif cone == Cone.SOC:
            out.append(project_soc(seg))
        else:  # pragma: no cover
            raise ValueError(cone)
        off += length
    return jnp.concatenate(out)


@struct.dataclass
class ADMMConicWork:
    prob: BatchConic
    chol: jnp.ndarray
    rho_vec: jnp.ndarray
    alpha: jnp.ndarray


@struct.dataclass
class ADMMConicSolution:
    x: jnp.ndarray
    s: jnp.ndarray
    y: jnp.ndarray
    iterations: jnp.ndarray
    r_prim: jnp.ndarray
    r_dual: jnp.ndarray
    status: jnp.ndarray


def setup(prob: BatchConic, rho: float = 0.1, alpha: float = 1.6) -> ADMMConicWork:
    dtype = prob.P.dtype
    rows = []
    for cone, length in prob.segments:
        scale = RHO_EQ_SCALE if cone == Cone.ZERO else 1.0
        rows.append(jnp.full((length,), rho * scale, dtype))
    rho_vec = jnp.concatenate(rows)
    K = prob.P + prob.A.T @ (rho_vec[:, None] * prob.A) \
        + 1e-8 * jnp.eye(prob.num_vars, dtype=dtype)
    chol = jax.scipy.linalg.cholesky(K, lower=True)
    return ADMMConicWork(prob=prob, chol=chol, rho_vec=rho_vec,
                         alpha=jnp.asarray(alpha, dtype))


def update(work: ADMMConicWork, q=None, b=None) -> ADMMConicWork:
    p = work.prob
    p = p.replace(q=p.q if q is None else q, b=p.b if b is None else b)
    return work.replace(prob=p)


def refactor(work: ADMMConicWork, prob: BatchConic) -> ADMMConicWork:
    """Swap in a conic program with new P/A values but the same segment
    structure, reusing the penalty vector and refactoring only the KKT —
    the setup-once + in-place-update baseline pattern (ECOS role; cf.
    OSQPParams.jl:127-162 for the QP analog)."""
    dtype = prob.P.dtype
    K = prob.P + prob.A.T @ (work.rho_vec[:, None] * prob.A) \
        + 1e-8 * jnp.eye(prob.num_vars, dtype=dtype)
    chol = jax.scipy.linalg.cholesky(K, lower=True)
    return work.replace(prob=prob, chol=chol)


def solve(work, x0=None, y0=None, **kw):
    """Precision-pinned entry point (reduced-precision matmul passes, TF32
    on H100, stall ADMM convergence; full f32 is faster end-to-end)."""
    with jax.default_matmul_precision("highest"):
        return _solve_impl(work, x0=x0, y0=y0, **kw)


def _solve_impl(work: ADMMConicWork, x0: Optional[jnp.ndarray] = None,
          y0: Optional[jnp.ndarray] = None, eps_abs: float = 1e-6,
          eps_rel: Optional[float] = None,
          max_iter: int = 20000) -> ADMMConicSolution:
    p = work.prob
    dtype = p.P.dtype
    NN, M = p.num_vars, p.A.shape[0]
    x = jnp.zeros(NN, dtype) if x0 is None else x0
    y = jnp.zeros(M, dtype) if y0 is None else y0
    w = _project_K(p.segments, p.b - p.A @ x)
    rho = work.rho_vec
    inf = jnp.asarray(jnp.inf, dtype)
    eps_rel_v = eps_abs if eps_rel is None else eps_rel

    def cond(s):
        x, w, y, it, rp, rd, done = s
        return (~done) & (it < max_iter)

    def body(s):
        x, w, y, it, rp, rd, done = s
        rhs = -p.q + p.A.T @ (rho * (p.b - w) - y)
        x_n = jax.scipy.linalg.cho_solve((work.chol, True), rhs)
        Ax = p.A @ x_n
        w_prev = w
        w_n = _project_K(p.segments, p.b - Ax - y / rho)
        y_n = y + rho * (Ax + w_n - p.b)

        rp_n = jnp.max(jnp.abs(Ax + w_n - p.b))
        rd_n = jnp.max(jnp.abs(p.A.T @ (rho * (w_n - w_prev))))
        sp = jnp.maximum(jnp.max(jnp.abs(Ax)),
                         jnp.maximum(jnp.max(jnp.abs(w_n)),
                                     jnp.max(jnp.abs(p.b))))
        done_n = (rp_n < eps_abs + eps_rel_v * sp) & \
            (rd_n < eps_abs + eps_rel_v * sp)
        out = (x_n, w_n, y_n, it + 1, rp_n, rd_n, done_n)
        return jax.tree_util.tree_map(
            lambda a, c: jnp.where(done, a, c), s, out)

    s0 = (x, w, y, jnp.zeros((), jnp.int32), inf, inf, jnp.zeros((), bool))
    x, w, y, it, rp, rd, done = jax.lax.while_loop(cond, body, s0)
    return ADMMConicSolution(x=x, s=w, y=y, iterations=it, r_prim=rp,
                             r_dual=rd, status=done.astype(jnp.int32))


def extract_traj(prob: BatchConic, x):
    n, m, N = prob.n, prob.m, prob.N
    base = jnp.arange(N) * (n + m)
    X = x[base[:, None] + jnp.arange(n)[None, :]]
    U = x[(base[:-1] + n)[:, None] + jnp.arange(m)[None, :]]
    return X, U
