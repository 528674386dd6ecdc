"""MPC-structured ADMM QP solver (timing-grade OSQP role).

The dense ADMM in :mod:`admm_qp` treats the batch QP as an unstructured
[NN, NN] problem — fine as an oracle, but every iteration pays dense
matvecs and every adaptive-rho step a dense O(NN^3) refactor, which is why
it cannot approach the reference's sparse OSQP timings
(Woofer/MPCControl/Structs/OSQPParams.jl:127-162: setup-once sparse KKT,
in-place value updates, ~0.5 ms/solve).

This module is the structured equivalent: the QP stays in knot form

    variables  w_k = [x_k; u_k]            (u_{N-1} is a sigma-padded dummy)
    rows       dynamics defects [N-1, n]   (equality, rho * 1e3)
               x0 equality [n]             (equality, rho * 1e3)
               constraint blocks [N, p_b]  (equality or inequality per block)

so the KKT matrix P + sigma I + A' R A is block *tridiagonal* in the
(n+m)-sized knot blocks. Factorization is a `lax.scan` of (n+m)^3 block
Cholesky steps — O(N (n+m)^3) instead of O((N (n+m))^3) — and every matvec
is a batched small einsum. All shapes static; the solver jits, vmaps over
scenario batches, and maps onto batched small matmuls on an accelerator.

Same algorithm family as admm_qp / OSQP: modified Ruiz equilibration on the
structured data, over-relaxed splitting with per-row-group penalties,
unscaled-residual termination. rho is fixed per workspace (refactors are
cheap; callers pick rho per problem class — OSQP's adaptive schedule can be
emulated by re-calling :func:`refactor` with a new rho).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from ..utils import struct

from ..cones import Cone, project_soc
from ..dynamics import LTVDynamics
from ..problem import Problem

RHO_EQ_SCALE = 1e3
SIGMA = 1e-6
ALPHA = 1.6
CHUNK = 25
# The banded factor/solve scans run (n+m)-sized block ops N times; at MPC
# sizes (N~15-30, s~25) per-step dispatch overhead dominates the arithmetic,
# so the scans are unrolled (measured on the trot QP, 175 ADMM iterations:
# 32 -> 11 ms/solve going from unroll 1 to 15). The inner ADMM chunk is
# lightly unrolled too; full chunk unroll blows compile time for no gain.
UNROLL = 16
CHUNK_UNROLL = 5


@struct.dataclass
class KnotQP:
    """Knot-structured QP data (unscaled).

    Shapes: Q [N,n,n], q [N,n], R [N-1,m,m], r [N-1,m];
    dynamics A [N-1,n,n], B [N-1,n,m], d [N-1,n]; x0 [n];
    per constraint block: Cx [N,p,n], Cu [N,p,m], l/u [N,p]
    (rows are ``Cx x + Cu u`` with bounds [l, u]; masked knots have
    all-zero rows and l = u = 0)."""

    Q: jnp.ndarray
    q: jnp.ndarray
    R: jnp.ndarray
    r: jnp.ndarray
    A: jnp.ndarray
    B: jnp.ndarray
    d: jnp.ndarray
    x0: jnp.ndarray
    Cx: Tuple[jnp.ndarray, ...]
    Cu: Tuple[jnp.ndarray, ...]
    l: Tuple[jnp.ndarray, ...]
    u: Tuple[jnp.ndarray, ...]
    cones: Tuple[Cone, ...] = struct.field(pytree_node=False, default=())

    @property
    def dims(self):
        return self.Q.shape[0], self.Q.shape[1], self.R.shape[2]


def to_knot_qp(prob: Problem) -> KnotQP:
    """Problem -> knot-structured program (same math as
    transcribe.to_batch_qp / to_batch_conic, never materializing the dense
    [NN, NN] operators). SOC blocks are stored in conic form: row maps are
    negated so the slack s = b - (Cx x + Cu u) must lie in the SOC
    (transcribe.py's A = -M, b = v mapping)."""
    if not isinstance(prob.dynamics, LTVDynamics):
        raise TypeError("knot ADMM requires LTVDynamics (relinearize first)")
    N = prob.N
    c = prob.cost
    dtype = prob.x0.dtype
    big = jnp.asarray(jnp.inf, dtype)
    Cx, Cu, l, u, cones = [], [], [], [], []
    for con in prob.constraints:
        if not getattr(con, "is_affine", True):
            raise TypeError(f"nonlinear block {con.name!r}")
        mask = con.mask
        Cx_b = con.Cx * mask[:, None, None]
        Cu_b = (con.Cu * mask[:, None, None]).at[N - 1].set(0.0)
        v = con.b * mask[:, None]
        if con.cone == Cone.ZERO:
            l_b, u_b = -v, -v
        elif con.cone == Cone.NONPOS:  # rows: Cx x + Cu u <= -v
            l_b, u_b = jnp.full_like(v, -big), -v
        else:  # SOC: b - rows in SOC, rows = -(residual map)
            Cx_b, Cu_b = -Cx_b, -Cu_b
            l_b, u_b = v, v
        # masked knots: l = u = 0 so the all-zero rows read as satisfied
        l_b = jnp.where(mask[:, None] > 0, l_b, 0.0)
        u_b = jnp.where(mask[:, None] > 0, u_b, 0.0)
        Cx.append(Cx_b)
        Cu.append(Cu_b)
        l.append(l_b)
        u.append(u_b)
        cones.append(con.cone)
    return KnotQP(Q=c.Q, q=c.q, R=c.R[:-1], r=c.r[:-1],
                  A=prob.dynamics.A, B=prob.dynamics.B, d=prob.dynamics.d,
                  x0=prob.x0, Cx=tuple(Cx), Cu=tuple(Cu), l=tuple(l),
                  u=tuple(u), cones=tuple(cones))


# ---------------------------------------------------------------------------
# Ruiz equilibration on structured data
# ---------------------------------------------------------------------------

def _ruiz(qp: KnotQP, iters: int = 10):
    N, n, m = qp.dims
    dtype = qp.Q.dtype
    Dx = jnp.ones((N, n), dtype)
    Du = jnp.ones((N, m), dtype)
    E_dyn = jnp.ones((N - 1, n), dtype)
    E_x0 = jnp.ones((n,), dtype)
    E_blk = tuple(jnp.ones(lb.shape, dtype) for lb in qp.l)
    csc = jnp.ones((), dtype)

    def body(_, carry):
        Dx, Du, E_dyn, E_x0, E_blk, csc = carry
        Qs = jnp.abs(csc * Dx[:, :, None] * qp.Q * Dx[:, None, :])
        Rs = jnp.abs(csc * Du[:-1, :, None] * qp.R * Du[:-1, None, :])
        colx = jnp.max(Qs, axis=1)
        colu = jnp.concatenate([jnp.max(Rs, axis=1),
                                jnp.zeros((1, m), dtype)], axis=0)

        Adyn = jnp.abs(E_dyn[:, :, None] * qp.A * Dx[:-1, None, :])
        Bdyn = jnp.abs(E_dyn[:, :, None] * qp.B * Du[:-1, None, :])
        Sdyn = jnp.abs(E_dyn * Dx[1:])
        colx = colx.at[:-1].max(jnp.max(Adyn, axis=1))
        colx = colx.at[1:].max(Sdyn)
        colu = colu.at[:-1].max(jnp.max(Bdyn, axis=1))
        colx = colx.at[0].max(jnp.abs(E_x0 * Dx[0]))
        rows_dyn = jnp.maximum(jnp.max(Adyn, axis=2),
                               jnp.maximum(jnp.max(Bdyn, axis=2), Sdyn))
        row_x0 = jnp.abs(E_x0 * Dx[0])

        rows_blk = []
        cones = qp.cones or tuple(None for _ in qp.l)
        for Cx, Cu, E, cn in zip(qp.Cx, qp.Cu, E_blk, cones):
            Cxs = jnp.abs(E[:, :, None] * Cx * Dx[:, None, :])
            Cus = jnp.abs(E[:, :, None] * Cu * Du[:, None, :])
            colx = jnp.maximum(colx, jnp.max(Cxs, axis=1))
            colu = jnp.maximum(colu, jnp.max(Cus, axis=1))
            rb = jnp.maximum(jnp.max(Cxs, axis=2), jnp.max(Cus, axis=2))
            if cn == Cone.SOC:
                # a SOC is only invariant under uniform scaling: share one
                # row scale per knot (the max keeps dscale conservative)
                rb = jnp.broadcast_to(jnp.max(rb, axis=1, keepdims=True),
                                      rb.shape)
            rows_blk.append(rb)

        def dscale(nrm):
            return jnp.where(nrm > 1e-12,
                             1.0 / jnp.sqrt(jnp.clip(nrm, 1e-8, 1e8)), 1.0)

        Dx = jnp.clip(Dx * dscale(colx), 1e-6, 1e6)
        Du = jnp.clip(Du * dscale(colu), 1e-6, 1e6)
        E_dyn = jnp.clip(E_dyn * dscale(rows_dyn), 1e-6, 1e6)
        E_x0 = jnp.clip(E_x0 * dscale(row_x0), 1e-6, 1e6)
        E_blk = tuple(jnp.clip(E * dscale(rb), 1e-6, 1e6)
                      for E, rb in zip(E_blk, rows_blk))

        Qs = jnp.abs(csc * Dx[:, :, None] * qp.Q * Dx[:, None, :])
        qs = jnp.abs(csc * Dx * qp.q)
        rs = jnp.abs(csc * Du[:-1] * qp.r)
        pmean = jnp.mean(jnp.max(Qs, axis=1))
        qmax = jnp.maximum(jnp.max(qs), jnp.max(rs))
        gamma = 1.0 / jnp.clip(jnp.maximum(pmean, qmax), 1e-8, 1e8)
        return Dx, Du, E_dyn, E_x0, E_blk, csc * gamma

    return jax.lax.fori_loop(0, iters, body,
                             (Dx, Du, E_dyn, E_x0, E_blk, csc))


# ---------------------------------------------------------------------------
# Banded KKT
# ---------------------------------------------------------------------------

def _scaled_stacks(qp: KnotQP, Dx, Du, E_dyn, E_x0, E_blk, csc):
    """All scaled operator stacks used by assembly, matvecs, and solves."""
    Qs = csc * (Dx[:, :, None] * qp.Q * Dx[:, None, :])
    Rs = csc * (Du[:-1, :, None] * qp.R * Du[:-1, None, :])
    A_s = E_dyn[:, :, None] * qp.A * Dx[:-1, None, :]
    B_s = E_dyn[:, :, None] * qp.B * Du[:-1, None, :]
    S_s = E_dyn * Dx[1:]                       # row k's -x_{k+1} coefficient
    x0_s = E_x0 * Dx[0]
    Cx_s = tuple(E[:, :, None] * Cx * Dx[:, None, :]
                 for E, Cx in zip(E_blk, qp.Cx))
    Cu_s = tuple(E[:, :, None] * Cu * Du[:, None, :]
                 for E, Cu in zip(E_blk, qp.Cu))
    return Qs, Rs, A_s, B_s, S_s, x0_s, Cx_s, Cu_s


def _assemble_banded(stacks, N, n, m, dtype, rho, eq_blk):
    """Scaled K = P + sigma I + A' R A as block-tridiagonal stacks:
    diag [N, s, s] and lower couplings [N-1, s, s] (block k+1 rows, block k
    cols), s = n + m. The dummy terminal control gets sigma only."""
    Qs, Rs, A_s, B_s, S_s, x0_s, Cx_s, Cu_s = stacks
    s = n + m
    rho_eq = rho * RHO_EQ_SCALE

    diag = jnp.zeros((N, s, s), dtype)
    diag = diag.at[:, :n, :n].set(Qs)
    diag = diag.at[:-1, n:, n:].set(Rs)
    diag = diag.at[:, jnp.arange(s), jnp.arange(s)].add(SIGMA)

    J = jnp.concatenate([A_s, B_s], axis=2)                   # [N-1, n, s]
    diag = diag.at[:-1].add(rho_eq * jnp.einsum("kri,krj->kij", J, J))
    diag = diag.at[1:, :n, :n].add(
        rho_eq * jax.vmap(jnp.diag)(S_s * S_s))
    lower = jnp.zeros((N - 1, s, s), dtype)
    lower = lower.at[:, :n, :].set(
        -rho_eq * S_s[:, :, None] * J)                        # [N-1, n, s]

    diag = diag.at[0, :n, :n].add(rho_eq * jnp.diag(x0_s * x0_s))

    for Cx, Cu, eq in zip(Cx_s, Cu_s, eq_blk):
        rho_b = rho_eq if eq else rho
        C = jnp.concatenate([Cx, Cu], axis=2)                 # [N, p, s]
        diag = diag + rho_b * jnp.einsum("kpi,kpj->kij", C, C)
    return diag, lower


def _banded_cholesky(diag, lower):
    """Block-tridiagonal Cholesky: K = L L^T with L block-bidiagonal.
    Returns (Linv [N,s,s] = per-block L_k^{-1}, F [N-1,s,s]) — the inverses
    are materialized once so the repeated banded solves inside the ADMM
    loop are pure (batched) matmuls, not triangular solves."""
    s = diag.shape[1]
    eye = jnp.eye(s, dtype=diag.dtype)

    def step(L_prev_inv_t, inp):
        D_k, C_k = inp
        F_k = C_k @ L_prev_inv_t
        L_k = jax.scipy.linalg.cholesky(D_k - F_k @ F_k.T, lower=True)
        L_inv = jax.scipy.linalg.solve_triangular(L_k, eye, lower=True)
        return L_inv.T, (L_inv, F_k)

    L0 = jax.scipy.linalg.cholesky(diag[0], lower=True)
    L0_inv = jax.scipy.linalg.solve_triangular(L0, eye, lower=True)
    _, (Linv_rest, F) = jax.lax.scan(step, L0_inv.T, (diag[1:], lower),
                                     unroll=UNROLL)
    return jnp.concatenate([L0_inv[None], Linv_rest], axis=0), F


def _banded_solve(Linv, F, b):
    """Solve K w = b with the inverted band factor; b, w are [N, s]."""
    def fwd(z_prev, inp):
        Li_k, F_k, b_k = inp
        z_k = Li_k @ (b_k - F_k @ z_prev)
        return z_k, z_k

    z0 = Linv[0] @ b[0]
    _, z_rest = jax.lax.scan(fwd, z0, (Linv[1:], F, b[1:]), unroll=UNROLL)
    z = jnp.concatenate([z0[None], z_rest], axis=0)

    def bwd(w_next, inp):
        Li_k, F_k1, z_k = inp
        w_k = Li_k.T @ (z_k - F_k1.T @ w_next)
        return w_k, w_k

    wN = Linv[-1].T @ z[-1]
    _, w_rest = jax.lax.scan(bwd, wN, (Linv[:-1], F, z[:-1]), reverse=True,
                             unroll=UNROLL)
    return jnp.concatenate([w_rest, wN[None]], axis=0)


# ---------------------------------------------------------------------------
# Workspace / solve
# ---------------------------------------------------------------------------

@struct.dataclass
class KnotADMMWork:
    qp: KnotQP
    Linv: jnp.ndarray          # per-block L^{-1} of the banded factor
    F: jnp.ndarray
    Dx: jnp.ndarray
    Du: jnp.ndarray
    E_dyn: jnp.ndarray
    E_x0: jnp.ndarray
    E_blk: Tuple[jnp.ndarray, ...]
    csc: jnp.ndarray
    rho: jnp.ndarray
    eq_blk: Tuple[bool, ...] = struct.field(pytree_node=False)


@struct.dataclass
class KnotADMMSolution:
    X: jnp.ndarray             # [N, n]
    U: jnp.ndarray             # [N-1, m]
    iterations: jnp.ndarray
    r_prim: jnp.ndarray
    r_dual: jnp.ndarray
    status: jnp.ndarray
    # opaque scaled-space iterate (X, U, z, y, rho) for warm-starting the
    # next solve via ``solve(work, internal=sol.internal)``. Valid only with
    # a workspace sharing the SAME scalings (the setup-once baseline
    # pattern, OSQPParams.jl:127-162).
    internal: Optional[tuple] = None


def _is_eq_blk(qp: KnotQP):
    if qp.cones:
        return tuple(cn == Cone.ZERO for cn in qp.cones)
    return tuple(bool(jnp.all(jnp.isfinite(lb))) for lb in qp.l)


def setup(qp: KnotQP, rho: float = 0.1, scaling_iters: int = 10
          ) -> KnotADMMWork:
    N, n, m = qp.dims
    dtype = qp.Q.dtype
    Dx, Du, E_dyn, E_x0, E_blk, csc = _ruiz(qp, scaling_iters)
    eq_blk = _is_eq_blk(qp)
    stacks = _scaled_stacks(qp, Dx, Du, E_dyn, E_x0, E_blk, csc)
    diag, lower = _assemble_banded(stacks, N, n, m, dtype, rho, eq_blk)
    Linv, F = _banded_cholesky(diag, lower)
    return KnotADMMWork(qp=qp, Linv=Linv, F=F, Dx=Dx, Du=Du,
                        E_dyn=E_dyn, E_x0=E_x0, E_blk=E_blk, csc=csc,
                        rho=jnp.asarray(rho, dtype), eq_blk=eq_blk)


def refactor(work: KnotADMMWork, qp: KnotQP,
             rho: Optional[float] = None) -> KnotADMMWork:
    """New P/A values (same structure): reuse scalings, refactor the band —
    O(N (n+m)^3), the structured OSQP setup-once + update! pattern."""
    N, n, m = qp.dims
    rho_v = work.rho if rho is None else jnp.asarray(rho, work.rho.dtype)
    stacks = _scaled_stacks(qp, work.Dx, work.Du, work.E_dyn, work.E_x0,
                            work.E_blk, work.csc)
    diag, lower = _assemble_banded(stacks, N, n, m, qp.Q.dtype, rho_v,
                                   work.eq_blk)
    Linv, F = _banded_cholesky(diag, lower)
    return work.replace(qp=qp, Linv=Linv, F=F, rho=rho_v)


def solve(work, **kw):
    """Precision-pinned entry point (reduced-precision matmuls, TF32 on
    H100, stall ADMM)."""
    with jax.default_matmul_precision("highest"):
        return _solve_impl(work, **kw)


def _solve_impl(work: KnotADMMWork, eps_abs: float = 1e-5,
                eps_rel: Optional[float] = None,
                max_iter: int = 4000,
                internal: Optional[tuple] = None) -> KnotADMMSolution:
    qp = work.qp
    N, n, m = qp.dims
    dtype = qp.Q.dtype
    Dx, Du = work.Dx, work.Du
    E_dyn, E_x0, E_blk, csc = work.E_dyn, work.E_x0, work.E_blk, work.csc
    eps_rel_v = eps_abs if eps_rel is None else eps_rel
    stacks = _scaled_stacks(qp, Dx, Du, E_dyn, E_x0, E_blk, csc)
    _, _, A_s, B_s, S_s, x0_s, Cx_s, Cu_s = stacks

    qs = csc * (Dx * qp.q)
    rs = jnp.concatenate([csc * (Du[:-1] * qp.r),
                          jnp.zeros((1, m), dtype)], axis=0)

    ld = E_dyn * (-qp.d)
    lx0 = E_x0 * qp.x0
    lb = tuple(E * lo for E, lo in zip(E_blk, qp.l))
    ub = tuple(E * up for E, up in zip(E_blk, qp.u))

    def factor(rho_v):
        diag, lower = _assemble_banded(stacks, N, n, m, dtype, rho_v,
                                       work.eq_blk)
        return _banded_cholesky(diag, lower)

    cones = qp.cones or tuple(None for _ in qp.l)

    def proj_block(cn, v, lo, up):
        if cn == Cone.SOC:
            # slack s = up - v must lie in the SOC
            return up - project_soc(up - v)
        return jnp.clip(v, lo, up)

    def matvec(X, U):
        dyn = (jnp.einsum("kij,kj->ki", A_s, X[:-1])
               + jnp.einsum("kij,kj->ki", B_s, U[:-1]) - S_s * X[1:])
        x0r = x0_s * X[0]
        blocks = tuple(jnp.einsum("kpj,kj->kp", Cx, X)
                       + jnp.einsum("kpj,kj->kp", Cu, U)
                       for Cx, Cu in zip(Cx_s, Cu_s))
        return dyn, x0r, blocks

    def rmatvec(dyn, x0r, blocks):
        X = jnp.zeros((N, n), dtype)
        U = jnp.zeros((N, m), dtype)
        X = X.at[:-1].add(jnp.einsum("kij,ki->kj", A_s, dyn))
        X = X.at[1:].add(-S_s * dyn)
        U = U.at[:-1].add(jnp.einsum("kij,ki->kj", B_s, dyn))
        X = X.at[0].add(x0_s * x0r)
        for Cx, Cu, gb in zip(Cx_s, Cu_s, blocks):
            X = X + jnp.einsum("kpj,kp->kj", Cx, gb)
            U = U + jnp.einsum("kpj,kp->kj", Cu, gb)
        return X, U

    if internal is None:
        X = jnp.zeros((N, n), dtype)
        U = jnp.zeros((N, m), dtype)
        z0 = matvec(X, U)
        z = (ld, lx0,
             tuple(proj_block(cn, g, lo, up)
                   for cn, g, lo, up in zip(cones, z0[2], lb, ub)))
        y = jax.tree_util.tree_map(jnp.zeros_like, z)
    else:
        # scaled-space warm start from a previous solve under the SAME
        # scalings; z is re-projected against the new bounds so it starts
        # feasible for the updated problem data. The iterate's rho is NOT
        # adopted (the workspace factor is built for work.rho) — pass
        # ``rho=float(prev_rho)`` to :func:`refactor` to carry it.
        X, U, z_w, y, _ = internal
        z = (ld, lx0,
             tuple(proj_block(cn, g, lo, up)
                   for cn, g, lo, up in zip(cones, z_w[2], lb, ub)))
    inf = jnp.asarray(jnp.inf, dtype)

    def unscaled_residuals(X, U, z, y):
        Xu = Dx * X
        Uu = Du * U
        # primal: max |A w - z| over groups, with OSQP relative scale
        dyn_u = (jnp.einsum("kij,kj->ki", qp.A, Xu[:-1])
                 + jnp.einsum("kij,kj->ki", qp.B, Uu[:-1]) - Xu[1:])
        zu0 = z[0] / E_dyn
        rp = jnp.max(jnp.abs(dyn_u - zu0))
        sp = jnp.maximum(jnp.max(jnp.abs(dyn_u)), jnp.max(jnp.abs(zu0)))
        zux = z[1] / E_x0
        rp = jnp.maximum(rp, jnp.max(jnp.abs(Xu[0] - zux)))
        sp = jnp.maximum(sp, jnp.maximum(jnp.max(jnp.abs(Xu[0])),
                                         jnp.max(jnp.abs(zux))))
        for Cx, Cu, E, g in zip(qp.Cx, qp.Cu, E_blk, z[2]):
            row_u = (jnp.einsum("kpj,kj->kp", Cx, Xu)
                     + jnp.einsum("kpj,kj->kp", Cu, Uu))
            gu = g / E
            rp = jnp.maximum(rp, jnp.max(jnp.abs(row_u - gu)))
            sp = jnp.maximum(sp, jnp.maximum(jnp.max(jnp.abs(row_u)),
                                             jnp.max(jnp.abs(gu))))
        # dual: max |P w + q + A' y| unscaled
        Px = jnp.einsum("kij,kj->ki", qp.Q, Xu) + qp.q
        Pu = jnp.einsum("kij,kj->ki", qp.R, Uu[:-1]) + qp.r
        yd = (E_dyn / csc) * y[0]
        yx0 = (E_x0 / csc) * y[1]
        AtX = jnp.zeros_like(Xu).at[:-1].add(
            jnp.einsum("kij,ki->kj", qp.A, yd)).at[1:].add(-yd)
        AtU = jnp.zeros_like(Uu).at[:-1].add(
            jnp.einsum("kij,ki->kj", qp.B, yd))
        AtX = AtX.at[0].add(yx0 * 0 + yx0)
        for Cx, Cu, E, g in zip(qp.Cx, qp.Cu, E_blk, y[2]):
            gs = (E / csc) * g
            AtX = AtX + jnp.einsum("kpj,kp->kj", Cx, gs)
            AtU = AtU + jnp.einsum("kpj,kp->kj", Cu, gs)
        rd = jnp.maximum(jnp.max(jnp.abs(Px + AtX)),
                         jnp.max(jnp.abs(Pu + AtU[:-1])))
        sd = jnp.maximum(jnp.max(jnp.abs(Px)),
                         jnp.maximum(jnp.max(jnp.abs(AtX)),
                                     jnp.max(jnp.abs(AtU))))
        ok = (rp < eps_abs + eps_rel_v * sp) & (rd < eps_abs + eps_rel_v * sd)
        return rp, rd, ok

    Qs_s, Rs_s = stacks[0], stacks[1]

    def scaled_rel_residuals(X, U, z, y):
        """Relative primal/dual residuals in scaled space (the OSQP
        adaptive-rho signal)."""
        Az = matvec(X, U)
        num_p = jnp.maximum(
            jnp.max(jnp.abs(Az[0] - z[0])),
            jnp.maximum(jnp.max(jnp.abs(Az[1] - z[1])),
                        _tmax(tuple(g - gz for g, gz in zip(Az[2], z[2])))))
        den_p = jnp.maximum(_tmax(Az[2]) if Az[2] else 0.0,
                            jnp.maximum(jnp.max(jnp.abs(Az[0])),
                                        jnp.max(jnp.abs(Az[1]))))
        den_p = jnp.maximum(den_p, _tmax(z[2]) if z[2] else 0.0)
        den_p = jnp.maximum(den_p, jnp.maximum(jnp.max(jnp.abs(z[0])),
                                               jnp.max(jnp.abs(z[1]))))
        Px = jnp.einsum("kij,kj->ki", Qs_s, X) + qs
        Pu = jnp.einsum("kij,kj->ki", Rs_s, U[:-1]) + rs[:-1]
        AtX, AtU = rmatvec(*y)
        num_d = jnp.maximum(jnp.max(jnp.abs(Px + AtX)),
                            jnp.max(jnp.abs(Pu + AtU[:-1])))
        den_d = jnp.maximum(jnp.max(jnp.abs(Px)),
                            jnp.maximum(jnp.max(jnp.abs(AtX)),
                                        jnp.max(jnp.abs(AtU))))
        rp_rel = num_p / jnp.maximum(den_p, 1e-10)
        rd_rel = num_d / jnp.maximum(den_d, 1e-10)
        return rp_rel, rd_rel

    def _tmax(ts):
        out = jnp.zeros((), dtype)
        for t_ in ts:
            out = jnp.maximum(out, jnp.max(jnp.abs(t_)))
        return out

    def cond(state):
        X, U, z, y, rho, L_diag, F, it, rp, rd, done = state
        return (~done) & (it < max_iter)

    def body(state):
        X, U, z, y, rho, L_diag, F, it, rp, rd, done = state
        rho_eq = rho * RHO_EQ_SCALE
        rho_blk = tuple(rho_eq if eq else rho for eq in work.eq_blk)

        def inner(_, carry):
            X, U, z, y = carry
            rz = (rho_eq * z[0] - y[0], rho_eq * z[1] - y[1],
                  tuple(r_ * g - yb
                        for r_, g, yb in zip(rho_blk, z[2], y[2])))
            AtX, AtU = rmatvec(*rz)
            b = jnp.concatenate(
                [SIGMA * X - qs + AtX, SIGMA * U - rs + AtU], axis=1)
            w = _banded_solve(L_diag, F, b)
            Xt, Ut = w[:, :n], w[:, n:]
            X_n = ALPHA * Xt + (1 - ALPHA) * X
            U_n = ALPHA * Ut + (1 - ALPHA) * U
            Az = matvec(Xt, Ut)
            zh = (ALPHA * Az[0] + (1 - ALPHA) * z[0],
                  ALPHA * Az[1] + (1 - ALPHA) * z[1],
                  tuple(ALPHA * g + (1 - ALPHA) * gz
                        for g, gz in zip(Az[2], z[2])))
            z_n = (ld,                              # equality rows: z = b
                   lx0,
                   tuple(proj_block(cn, g + yb / r_, lo, up)
                         for cn, g, yb, r_, lo, up in
                         zip(cones, zh[2], y[2], rho_blk, lb, ub)))
            y_n = (y[0] + rho_eq * (zh[0] - z_n[0]),
                   y[1] + rho_eq * (zh[1] - z_n[1]),
                   tuple(yb + r_ * (g - gn)
                         for yb, r_, g, gn in
                         zip(y[2], rho_blk, zh[2], z_n[2])))
            return X_n, U_n, z_n, y_n

        Xn, Un, zn, yn = jax.lax.scan(
            lambda c, _: (inner(0, c), None), (X, U, z, y), None,
            length=CHUNK, unroll=CHUNK_UNROLL)[0]
        rp_n, rd_n, done_n = unscaled_residuals(Xn, Un, zn, yn)

        # OSQP-style adaptive rho; the banded refactor is O(N (n+m)^3),
        # so adapting is cheap here (unlike the dense solver)
        rp_rel, rd_rel = scaled_rel_residuals(Xn, Un, zn, yn)
        rho_prop = jnp.clip(rho * jnp.sqrt(rp_rel / jnp.maximum(rd_rel, 1e-16)),
                            1e-6, 1e6)
        adapt = (~done_n) & ((rho_prop > 5.0 * rho) | (rho_prop < rho / 5.0))
        rho_n = jnp.where(adapt, rho_prop, rho)
        L_n, F_n = jax.lax.cond(adapt, factor,
                                lambda _: (L_diag, F), rho_n)
        chol_ok = jnp.all(jnp.isfinite(L_n))
        L_n = jnp.where(chol_ok, L_n, L_diag)
        F_n = jnp.where(chol_ok, F_n, F)
        rho_n = jnp.where(chol_ok, rho_n, rho)

        out = (Xn, Un, zn, yn, rho_n, L_n, F_n, it + CHUNK, rp_n, rd_n,
               done_n)
        return jax.tree_util.tree_map(
            lambda a, b_: jnp.where(done, a, b_), state, out)

    state0 = (X, U, z, y, work.rho, work.Linv, work.F,
              jnp.zeros((), jnp.int32), inf, inf, jnp.zeros((), bool))
    out = jax.lax.while_loop(cond, body, state0)
    X, U, z, y, rho, L_diag, F, it, rp, rd, done = out
    return KnotADMMSolution(X=Dx * X, U=(Du * U)[:-1], iterations=it,
                            r_prim=rp, r_dual=rd,
                            status=done.astype(jnp.int32),
                            internal=(X, U, z, y, rho))
