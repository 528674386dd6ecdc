"""Batch transcription: trajectory Problem -> dense QP / conic program.

The accelerator-native equivalent of the reference's solver transcriptions
(``gen_OSQP`` random_linear_problem.jl:37-77, ``gen_JuMP_rocket``
simple_rocket.jl:1-57, ``gen_ECOS`` grasp_mpc_helpers.jl:120-147, the
flexible satellite's hand-built sparse QP flexible_sat_mpc.jl:193-224).

Variable layout matches the reference exactly (important for warm-start
shifting parity): z = [x_0, u_0, x_1, u_1, ..., x_{N-1}], NN = N n + (N-1) m.
Row order: dynamics defects ((N-1) n rows), x0 equality (n rows), then each
constraint block knot-major. Everything is static-shaped and built with pure
jnp ops, so transcription itself can be jitted and vmapped over problem
batches, and MPC steps can refresh q / bounds / b in place without re-jit.

Masked (inactive) knots contribute all-zero rows with zero rhs — trivially
feasible for every cone — preserving static shapes.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from .utils import struct

from .cones import Cone
from .dynamics import LTVDynamics
from .problem import Problem


@struct.dataclass
class BatchQP:
    """OSQP-form dense QP: min 0.5 z'Pz + q'z  s.t.  l <= Az <= u."""

    P: jnp.ndarray
    q: jnp.ndarray
    A: jnp.ndarray
    l: jnp.ndarray
    u: jnp.ndarray
    n: int = struct.field(pytree_node=False)
    m: int = struct.field(pytree_node=False)
    N: int = struct.field(pytree_node=False)

    @property
    def num_vars(self) -> int:
        return self.P.shape[-1]


@struct.dataclass
class BatchConic:
    """SCS/COSMO-form conic program: min 0.5 z'Pz + q'z  s.t.  Az + s = b,
    s in K, where K is the product of ``segments`` = ((cone, length), ...)
    in row order (zero cone rows mean Az = b)."""

    P: jnp.ndarray
    q: jnp.ndarray
    A: jnp.ndarray
    b: jnp.ndarray
    segments: Tuple[Tuple[Cone, int], ...] = struct.field(pytree_node=False)
    n: int = struct.field(pytree_node=False)
    m: int = struct.field(pytree_node=False)
    N: int = struct.field(pytree_node=False)

    @property
    def num_vars(self) -> int:
        return self.P.shape[-1]


# ----------------------------------------------------------------------------
# Shared pieces
# ----------------------------------------------------------------------------

def _cost_blocks(prob: Problem):
    """(P, q) from the (already dt-scaled) cost stacks."""
    c = prob.cost
    N, n, m = prob.N, prob.n, prob.m
    NN = N * n + (N - 1) * m
    dtype = c.Q.dtype
    P = jnp.zeros((NN, NN), dtype)
    q = jnp.zeros(NN, dtype)

    base = jnp.arange(N) * (n + m)
    # x blocks (all N knots)
    rx = base[:, None, None] + jnp.arange(n)[None, :, None]
    cx = base[:, None, None] + jnp.arange(n)[None, None, :]
    P = P.at[rx, cx].set(c.Q)
    q = q.at[base[:, None] + jnp.arange(n)[None, :]].set(c.q)
    # u blocks (first N-1 knots)
    baseu = base[:-1] + n
    ru = baseu[:, None, None] + jnp.arange(m)[None, :, None]
    cu = baseu[:, None, None] + jnp.arange(m)[None, None, :]
    P = P.at[ru, cu].set(c.R[:-1])
    q = q.at[baseu[:, None] + jnp.arange(m)[None, :]].set(c.r[:-1])
    return P, q


def _dynamics_rows(prob: Problem):
    """Dynamics defect rows: A_k x_k + B_k u_k - x_{k+1} = -d_k, then the
    x0 row block x_0 = x0 (reference row order; the x0 rows sit at
    (N-1)n..(N-1)n+n as in random_linear_problem.jl:98-99)."""
    dyn = prob.dynamics
    if not isinstance(dyn, LTVDynamics):
        raise TypeError("batch transcription requires LTVDynamics; "
                        "relinearize nonlinear models first (the reference "
                        "does the same: OSQP/ECOS always receive the "
                        "linearized model)")
    A_s, B_s, d_s = dyn.A, dyn.B, dyn.d
    N, n, m = prob.N, prob.n, prob.m
    NN = N * n + (N - 1) * m
    dtype = prob.x0.dtype

    rows = jnp.zeros(((N - 1) * n + n, NN), dtype)
    rhs = jnp.zeros((N - 1) * n + n, dtype)

    k = jnp.arange(N - 1)
    r = k[:, None, None] * n + jnp.arange(n)[None, :, None]
    cxk = k[:, None, None] * (n + m) + jnp.arange(n)[None, None, :]
    cuk = k[:, None, None] * (n + m) + n + jnp.arange(m)[None, None, :]
    cxk1 = (k + 1)[:, None, None] * (n + m) + jnp.arange(n)[None, None, :]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (N - 1, n, n))

    rows = rows.at[r, cxk].set(A_s)
    rows = rows.at[r, jnp.broadcast_to(cuk, (N - 1, n, m))].set(B_s)
    rows = rows.at[r, cxk1].set(-eye)
    rhs = rhs.at[: (N - 1) * n].set((-d_s).reshape(-1))

    # x0 rows
    r0 = (N - 1) * n + jnp.arange(n)
    rows = rows.at[r0[:, None], jnp.arange(n)[None, :]].set(jnp.eye(n, dtype=dtype))
    rhs = rhs.at[r0].set(prob.x0)
    return rows, rhs


def _constraint_rows(con, N, n, m):
    """Stack one block's rows knot-major: M [N*p, NN], v [N*p] such that the
    residual is M z + v, with masked knots zeroed."""
    if not getattr(con, "is_affine", True):
        raise TypeError(f"constraint block {con.name!r} is nonlinear; batch "
                        "QP/conic transcription requires affine blocks")
    p = con.p
    NN = N * n + (N - 1) * m
    dtype = con.b.dtype
    M = jnp.zeros((N * p, NN), dtype)

    mask = con.mask
    Cx = con.Cx * mask[:, None, None]
    Cu = con.Cu * mask[:, None, None]
    v = (con.b * mask[:, None]).reshape(-1)

    k = jnp.arange(N)
    r = k[:, None, None] * p + jnp.arange(p)[None, :, None]
    cx = k[:, None, None] * (n + m) + jnp.arange(n)[None, None, :]
    M = M.at[r, jnp.broadcast_to(cx, (N, p, n))].set(Cx)
    # control columns only exist for knots < N-1; the mask already zeroes
    # knot N-1 for control constraints, so clamp the column index there.
    ku = jnp.minimum(k, N - 2)
    cu = ku[:, None, None] * (n + m) + n + jnp.arange(m)[None, None, :]
    Cu_safe = Cu.at[N - 1].set(0.0)
    M = M.at[r, jnp.broadcast_to(cu, (N, p, m))].set(Cu_safe)
    return M, v


# ----------------------------------------------------------------------------
# Builders
# ----------------------------------------------------------------------------

def to_batch_qp(prob: Problem) -> BatchQP:
    """Problem -> OSQP-form QP. Requires no SOC blocks (use
    :func:`to_batch_conic` for conic problems)."""
    N, n, m = prob.N, prob.n, prob.m
    dtype = prob.x0.dtype
    P, q = _cost_blocks(prob)
    Adyn, rhs = _dynamics_rows(prob)
    A_list = [Adyn]
    l_list = [rhs]
    u_list = [rhs]
    big = jnp.asarray(jnp.inf, dtype)
    for con in prob.constraints:
        if con.cone == Cone.SOC:
            raise ValueError("SOC constraint in QP transcription; use to_batch_conic")
        M, v = _constraint_rows(con, N, n, m)
        A_list.append(M)
        if con.cone == Cone.ZERO:
            l_list.append(-v)
            u_list.append(-v)
        else:  # NONPOS: M z + v <= 0  ->  M z <= -v
            l_list.append(jnp.full_like(v, -big))
            u_list.append(-v)
    return BatchQP(P=P, q=q, A=jnp.concatenate(A_list, axis=0),
                   l=jnp.concatenate(l_list), u=jnp.concatenate(u_list),
                   n=n, m=m, N=N)


def to_batch_conic(prob: Problem) -> BatchConic:
    """Problem -> conic program Az + s = b, s in K.

    Mapping per block residual c = Mz + v:
      ZERO:   A=M, b=-v, zero segment      (Az = b)
      NONPOS: A=M, b=-v, nonneg segment    (Az <= b)
      SOC:    A=-M, b=v, SOC segment       (b - Az in SOC)
    Dynamics + x0 rows form the leading zero segment.
    """
    N, n, m = prob.N, prob.n, prob.m
    P, q = _cost_blocks(prob)
    Adyn, rhs = _dynamics_rows(prob)
    A_list = [Adyn]
    b_list = [rhs]
    segments = [(Cone.ZERO, Adyn.shape[0])]
    for con in prob.constraints:
        M, v = _constraint_rows(con, N, n, m)
        if con.cone == Cone.SOC:
            A_list.append(-M)
            b_list.append(v)
            # SOC product structure is per knot: N cones of size p
            for _ in range(N):
                segments.append((Cone.SOC, con.p))
        elif con.cone == Cone.ZERO:
            A_list.append(M)
            b_list.append(-v)
            segments.append((Cone.ZERO, N * con.p))
        else:
            A_list.append(M)
            b_list.append(-v)
            segments.append((Cone.NONPOS, N * con.p))
    return BatchConic(P=P, q=q, A=jnp.concatenate(A_list, axis=0),
                      b=jnp.concatenate(b_list), segments=tuple(segments),
                      n=n, m=m, N=N)


# ----------------------------------------------------------------------------
# MPC in-place refreshers (shapes constant; jit-safe)
# ----------------------------------------------------------------------------

def qp_set_x0(qp: BatchQP, x0) -> BatchQP:
    """Refresh the x0 equality rows (parity with the l/u view updates at
    random_linear_problem.jl:142-143)."""
    r0 = (qp.N - 1) * qp.n
    l = jax.lax.dynamic_update_slice(qp.l, x0, (r0,))
    u = jax.lax.dynamic_update_slice(qp.u, x0, (r0,))
    return qp.replace(l=l, u=u)


def qp_set_cost(qp: BatchQP, prob: Problem) -> BatchQP:
    """Refresh the linear cost after a tracking-objective window advance
    (parity with the q update at random_linear_problem.jl:144-148)."""
    _, q = _cost_blocks(prob)
    return qp.replace(q=q)


def conic_set_x0(con: BatchConic, x0) -> BatchConic:
    r0 = (con.N - 1) * con.n
    b = jax.lax.dynamic_update_slice(con.b, x0, (r0,))
    return con.replace(b=b)


def conic_set_cost(con: BatchConic, prob: Problem) -> BatchConic:
    _, q = _cost_blocks(prob)
    return con.replace(q=q)
