"""ALTRO-style augmented-Lagrangian iLQR solver for batched accelerators.

This is the core deliverable: the equivalent of Altro.jl's `socp`-branch
solver consumed by every reference benchmark (SURVEY.md section 3.5), rebuilt
for XLA:

- backward Riccati pass as a single ``lax.scan`` over the horizon; under
  ``vmap`` on the GPU it runs as one kernel over the batch (ops/riccati.py)
- parallel line search: the whole backtracking ladder of step sizes is
  rolled out at once (the ladder kernel on the GPU, ops/rollout.py) and
  the largest admissible alpha selected — no sequential backtracking loop
- conic AL outer loop (dual update by polar-cone projection, geometric
  penalty scaling) as a ``lax.while_loop``
- every update masked on a ``done`` flag so the solve is ``vmap``-safe:
  converged lanes are fixed points of the loop bodies

Algorithm parity: outer AL loop (dual update lam <- proj_polar(lam + rho c),
penalty rho <- rho * penalty_scaling from penalty_initial) around an inner
iLQR loop (backward Riccati with regularization, line-searched rollout,
cost/gradient convergence), terminated by max_violation <
constraint_tolerance. ``projected_newton`` polish is disabled in every
reference benchmark (run_random_linear.jl:48) and is not replicated.
"""
from __future__ import annotations

import functools
import os as _os_mod
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from ..utils import struct


def _scan_unroll() -> int:
    """Horizon-scan unroll factor, read at TRACE time (env knob
    ALTRO_UNROLL). Unrolling the backward/rollout scans turns the
    per-knot XLA:CPU dispatch chain into straight-line code — the
    single-instance CPU latency lever (the knot ADMM's UNROLL=16 bought 3x
    there). Batched GPU solves bypass these scans in the kernels."""
    return int(_os_mod.environ.get("ALTRO_UNROLL", "1"))

from ..constraints import (ConicConstraint, DualState, al_cost, al_terms,
                           al_terms_structured)
from ..cones import project_polar
from ..dynamics import LTVDynamics
from ..problem import Problem
from .options import SolverOptions


@struct.dataclass
class Stats:
    iterations: jnp.ndarray        # total inner (iLQR) iterations
    outer_iterations: jnp.ndarray  # AL iterations
    cost: jnp.ndarray              # final true (un-penalized) cost
    viol: jnp.ndarray              # final max constraint violation
    gradient: jnp.ndarray
    status: jnp.ndarray            # 1 = SOLVE_SUCCEEDED, 0 = MAX_ITERATIONS


@struct.dataclass
class Solution:
    X: jnp.ndarray                 # [N, n]
    U: jnp.ndarray                 # [N-1, m]
    K: jnp.ndarray                 # [N-1, m, n] final feedback gains
    duals: Tuple[DualState, ...]
    stats: Stats


def print_summary(sol: Solution) -> None:
    """Host-side solve summary (parity with Altro's show_summary/verbose,
    run_simple_rocket.jl:66)."""
    s = sol.stats
    status = "SOLVE_SUCCEEDED" if int(s.status) == 1 else "MAX_ITERATIONS"
    print(f"[altro_mpc] {status}: {int(s.iterations)} iLQR iterations in "
          f"{int(s.outer_iterations)} AL rounds | cost {float(s.cost):.6g} | "
          f"max violation {float(s.viol):.3e} | gradient "
          f"{float(s.gradient):.3e}")


def check_status(stats: Stats, context: str = "") -> bool:
    """Warn on non-success (the reference MPC loops' status guard,
    random_linear_problem.jl:166-170 / altro_solver.jl:81-85)."""
    import warnings

    ok = bool(jnp.all(stats.status == 1))
    if not ok:
        n_fail = int(jnp.sum(stats.status == 0))
        warnings.warn(f"solver status: {n_fail} unsuccessful solve(s)"
                      + (f" in {context}" if context else ""))
    return ok


# ----------------------------------------------------------------------------
# AL cost and expansion
# ----------------------------------------------------------------------------

def total_al_cost(prob: Problem, duals, X, U):
    J = prob.cost.total(X, U)
    for con, dual in zip(prob.constraints, duals):
        J = J + al_cost(con, dual, X, U)
    return J


def total_al_cost_res(prob: Problem, duals, X, U):
    """AL cost plus the per-block residuals c and projected duals
    ctilde = proj_polar(lam + rho c) it computes along the way.

    The line-search ladder evaluates this per rung; the solver reuses the
    accepted rung's (c, ctilde) for the AL round-end violation check and
    dual update instead of re-evaluating every constraint block — one
    constraint pass per iteration instead of two."""
    J = prob.cost.total(X, U)
    cs, cts = [], []
    for con, dual in zip(prob.constraints, duals):
        c = con.evaluate(X, U)
        z = dual.lam + dual.rho[:, None] * c
        ct = project_polar(con.cone, z)
        J = J + jnp.sum(
            con.mask * (jnp.sum(ct * ct, axis=-1)
                        - jnp.sum(dual.lam ** 2, axis=-1))
            / (2.0 * dual.rho))
        cs.append(c)
        cts.append(ct)
    return J, (tuple(cs), tuple(cts))


def al_expansion(prob: Problem, duals, X, U):
    """Quadratic expansion of the AL objective along (X, U).

    Returns lx [N,n], lu [N,m], lxx [N,n,n], luu [N,m,m], lux [N,m,n].
    All constraint blocks are affine, so the Gauss-Newton AL curvature
    C^T (rho * Jpolar) C is exact up to the projection kink.
    """
    return _al_expansion_cd(prob.cost, prob.constraints, duals, X, U)


def _al_expansion_cd(cost, constraints, duals, X, U):
    lx, lu, lxx, luu, lux = cost.expansion(X, U)
    for con, dual in zip(constraints, duals):
        g, (kind, H) = al_terms_structured(con, dual, X, U)
        Cx, Cu = con.jacobians(X, U)  # constants for affine blocks
        lx = lx + jnp.einsum("kpn,kp->kn", Cx, g)
        lu = lu + jnp.einsum("kpm,kp->km", Cu, g)
        if kind == "dense":
            # small cones: the [N, p, p] contraction is tiny — fewer
            # dispatched ops beat the factored form (al_terms_structured)
            lxx = lxx + jnp.einsum("kpi,kpq,kqj->kij", Cx, H, Cx)
            luu = luu + jnp.einsum("kpi,kpq,kqj->kij", Cu, H, Cu)
            lux = lux + jnp.einsum("kpi,kpq,kqj->kij", Cu, H, Cx)
        else:
            if kind == "diag":
                w, ranks = H, ()
            else:
                w, ranks = H  # 'diag_lr': SOC diag + rank-2 factorization
            # curvature is diag(w) (+ rank-1 terms) — contract C' diag(w) C
            # without materializing [N, p, p] Jacobians
            WCx = w[:, :, None] * Cx
            WCu = w[:, :, None] * Cu
            lxx = lxx + jnp.einsum("kpi,kpj->kij", Cx, WCx)
            luu = luu + jnp.einsum("kpi,kpj->kij", Cu, WCu)
            lux = lux + jnp.einsum("kpi,kpj->kij", Cu, WCx)
            for coef, u in ranks:
                # coef_k * (C' u)(C' u)' — rank-1 outer products of
                # [N, n]/[N, m] vectors (the SOC Jacobian eigenstructure)
                ax = jnp.einsum("kpn,kp->kn", Cx, u)
                au = jnp.einsum("kpm,kp->km", Cu, u)
                lxx = lxx + coef[:, None, None] * (ax[:, :, None]
                                                   * ax[:, None, :])
                luu = luu + coef[:, None, None] * (au[:, :, None]
                                                   * au[:, None, :])
                lux = lux + coef[:, None, None] * (au[:, :, None]
                                                   * ax[:, None, :])
        if not con.is_affine:
            # exact multiplier-weighted constraint curvature (full Newton on
            # the AL for nonlinear blocks; affine blocks contribute none)
            Hxx, Huu, Hux = con.second_order(X, U, g)
            lxx = lxx + Hxx
            luu = luu + Huu
            lux = lux + Hux
    return lx, lu, lxx, luu, lux


# ----------------------------------------------------------------------------
# Backward Riccati pass (lax.scan over the horizon, reverse)
# ----------------------------------------------------------------------------

def backward_pass(A, B, lx, lu, lxx, luu, lux, reg):
    """Riccati recursion. A,B: [N-1,...]; expansions: [N,...].

    Returns K [N-1,m,n], d [N-1,m], dV1, dV2 where the expected cost change
    of a step of size alpha is alpha*dV1 + alpha^2*dV2 (dV1 <= 0).
    """
    m = B.shape[-1]
    eye_m = jnp.eye(m, dtype=B.dtype)
    VxT = lx[-1]
    VxxT = lxx[-1]

    def body(carry, inp):
        Vx, Vxx, dV1, dV2 = carry
        A_k, B_k, lx_k, lu_k, lxx_k, luu_k, lux_k = inp
        VA = Vxx @ A_k
        Qx = lx_k + A_k.T @ Vx
        Qu = lu_k + B_k.T @ Vx
        Qxx = lxx_k + A_k.T @ VA
        Quu = luu_k + B_k.T @ (Vxx @ B_k)
        Qux = lux_k + B_k.T @ VA
        Quu_reg = Quu + reg * eye_m

        # Quu is SPD (R > 0 plus PSD curvature): Cholesky solve, cheaper
        # and smaller to compile than LU with pivoting inside a scan.
        rhs = jnp.concatenate([Qux, Qu[:, None]], axis=1)
        L = jax.lax.linalg.cholesky(Quu_reg)
        sol = jax.lax.linalg.triangular_solve(
            L, jax.lax.linalg.triangular_solve(
                L, rhs, left_side=True, lower=True),
            left_side=True, lower=True, transpose_a=True)
        K_k = -sol[:, :-1]
        d_k = -sol[:, -1]

        Vx_n = Qx + K_k.T @ (Quu @ d_k) + K_k.T @ Qu + Qux.T @ d_k
        Vxx_n = Qxx + K_k.T @ (Quu @ K_k) + K_k.T @ Qux + Qux.T @ K_k
        Vxx_n = 0.5 * (Vxx_n + Vxx_n.T)
        dV1 = dV1 + d_k @ Qu
        dV2 = dV2 + 0.5 * d_k @ (Quu @ d_k)
        return (Vx_n, Vxx_n, dV1, dV2), (K_k, d_k)

    zero = jnp.zeros((), A.dtype)
    xs = (A, B, lx[:-1], lu[:-1], lxx[:-1], luu[:-1], lux[:-1])
    (Vx, Vxx, dV1, dV2), (K, d) = jax.lax.scan(
        body, (VxT, VxxT, zero, zero), xs, reverse=True,
        unroll=_scan_unroll())
    return K, d, dV1, dV2


def _bcast(axis_size, tree, flags):
    """Broadcast the unbatched leaves of ``tree`` (``flags`` False) to the
    batch, for a custom_vmap rule that falls back to ``jax.vmap``."""
    return jax.tree_util.tree_map(
        lambda a, b: a if b else jnp.broadcast_to(
            a, (axis_size,) + jnp.shape(a)),
        tree, flags)


# ----------------------------------------------------------------------------
# Expansion + backward pass (LTV fast path with a kernel-batched rule)
# ----------------------------------------------------------------------------

def expand_lane(cost, blocks, X, U, lams, rhos):
    """One lane's AL expansion (lx, lu, lxx, luu, lux) from multipliers and
    penalties given as arrays."""
    duals = tuple(DualState(lam=l, rho=r) for l, r in zip(lams, rhos))
    return _al_expansion_cd(cost, blocks, duals, X, U)


def _expand_backward_base(cost, dynA, dynB, blocks, X, U, lams, rhos, reg):
    return backward_pass(dynA, dynB,
                         *expand_lane(cost, blocks, X, U, lams, rhos), reg)


@jax.custom_batching.custom_vmap
def expand_backward(cost, dynA, dynB, blocks, X, U, lams, rhos, reg):
    """AL expansion + Riccati backward pass as one boundary. A single solve
    composes the XLA pieces. A vmapped solve computes the expansion with
    XLA and runs the backward pass in the Triton kernel (ops/riccati.py)
    where :func:`ops.use_kernel` picks it, and the vmapped XLA composition
    otherwise."""
    return _expand_backward_base(cost, dynA, dynB, blocks, X, U, lams, rhos,
                                 reg)


@expand_backward.def_vmap
def _expand_backward_vmap(axis_size, in_batched, cost, dynA, dynB, blocks,
                          X, U, lams, rhos, reg):
    from ..ops import batched_backward, use_kernel

    shared = not any(jax.tree_util.tree_leaves(in_batched[1:3]))
    cost, blocks, X, U, lams, rhos, reg = (
        _bcast(axis_size, a, b) for a, b in zip(
            (cost, blocks, X, U, lams, rhos, reg),
            (in_batched[0], in_batched[3]) + tuple(in_batched[4:])))
    if use_kernel("backward", X.dtype, X.shape[-1], U.shape[-1], shared):
        exp = jax.vmap(expand_lane)(cost, blocks, X, U, lams, rhos)
        out = batched_backward(dynA, dynB, *exp, reg)
    else:
        dynA, dynB = (_bcast(axis_size, a, b)
                      for a, b in zip((dynA, dynB), in_batched[1:3]))
        out = jax.vmap(_expand_backward_base)(cost, dynA, dynB, blocks, X,
                                              U, lams, rhos, reg)
    return out, (True, True, True, True)


# ----------------------------------------------------------------------------
# Line-search ladder rollouts (LTV fast path with a kernel-batched rule)
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _ls_rollouts_fn(alphas: tuple):
    """custom_vmap'd ladder rollout for LTV dynamics, keyed by the static
    alpha ladder. Single solve: scan rollout vmapped over alphas; vmapped:
    the ladder kernel (ops/rollout.py) where :func:`ops.use_kernel` picks
    it, and the vmapped scans otherwise."""

    def base_impl(alphas_arr, A, B, dd, Xb, Ub, K, dff):
        def one(alpha):
            def body(x, inp):
                xb, ub, K_k, d_k, A_k, B_k, dd_k = inp
                u = ub + alpha * d_k + K_k @ (x - xb)
                x1 = A_k @ x + B_k @ u + dd_k
                return x1, (x, u)

            xN, (Xh, U) = jax.lax.scan(
                body, Xb[0], (Xb[:-1], Ub, K, dff, A, B, dd),
                unroll=_scan_unroll())
            return jnp.concatenate([Xh, xN[None]], axis=0), U

        return jax.vmap(one)(alphas_arr)

    # The ladder rides along as an explicit argument: custom_vmap stages the
    # function out and cannot capture array constants from the closure.
    @jax.custom_batching.custom_vmap
    def ls_rollouts(alphas_arr, A, B, dd, Xb, Ub, K, dff):
        return base_impl(alphas_arr, A, B, dd, Xb, Ub, K, dff)

    @ls_rollouts.def_vmap
    def _rule(axis_size, in_batched, alphas_arr, A, B, dd, Xb, Ub, K, dff):
        from ..ops import batched_ls_rollout, use_kernel

        shared = not any(in_batched[:4])
        Xb, Ub, K, dff = (_bcast(axis_size, a, b)
                          for a, b in zip((Xb, Ub, K, dff), in_batched[4:]))
        if use_kernel("rollout", Xb.dtype, Xb.shape[-1], Ub.shape[-1],
                      shared):
            out = batched_ls_rollout(A, B, dd, Xb, Ub, K, dff, alphas)
        else:
            A, B, dd = (_bcast(axis_size, a, b)
                        for a, b in zip((A, B, dd), in_batched[1:4]))
            out = jax.vmap(base_impl, in_axes=(None,) + (0,) * 7)(
                alphas_arr, A, B, dd, Xb, Ub, K, dff)
        return out, (True, True)

    def wrapper(A, B, dd, Xb, Ub, K, dff):
        return ls_rollouts(jnp.asarray(alphas, A.dtype), A, B, dd, Xb, Ub,
                           K, dff)

    return wrapper


# ----------------------------------------------------------------------------
# Forward closed-loop rollout
# ----------------------------------------------------------------------------

def rollout_closed_loop(dynamics, Xbar, Ubar, K, d, alpha):
    """x+ = f(x, ubar + alpha d + K (x - xbar)). Returns (X, U)."""
    Nm1 = Ubar.shape[0]
    if isinstance(dynamics, LTVDynamics):
        xs = (Xbar[:-1], Ubar, K, d, dynamics.A, dynamics.B, dynamics.d)

        def body(x, inp):
            xb, ub, K_k, d_k, A_k, B_k, dd_k = inp
            u = ub + alpha * d_k + K_k @ (x - xb)
            x1 = A_k @ x + B_k @ u + dd_k
            return x1, (x, u)
    else:
        xs = (Xbar[:-1], Ubar, K, d, jnp.arange(Nm1))

        def body(x, inp):
            xb, ub, K_k, d_k, k = inp
            u = ub + alpha * d_k + K_k @ (x - xb)
            x1 = dynamics.step(x, u, k)
            return x1, (x, u)

    xN, (Xh, U) = jax.lax.scan(body, Xbar[0], xs, unroll=_scan_unroll())
    X = jnp.concatenate([Xh, xN[None]], axis=0)
    return X, U


# ----------------------------------------------------------------------------
# Solve
# ----------------------------------------------------------------------------

def _where_tree(pred, a, b):
    return jax.tree_util.tree_map(lambda x, y: jnp.where(pred, x, y), a, b)


def solve(prob: Problem, opts: SolverOptions,
          U0: Optional[jnp.ndarray] = None,
          duals: Optional[Tuple[DualState, ...]] = None,
          X0: Optional[jnp.ndarray] = None) -> Solution:
    """Solve the trajectory-optimization problem. Fully jittable/vmappable.

    Warm start: pass ``U0`` (shifted controls) and ``duals`` (shifted
    multipliers) from the previous MPC solve; states are re-derived by an
    open-loop rollout from ``prob.x0`` (parity with Altro's ``rollout!`` on
    warm-started solves). Passing ``X0`` (e.g. the previous solve's shifted
    states) SKIPS that init rollout and linearizes iteration 1 around
    (X0, U0) directly — X0[0] is overwritten with ``prob.x0``. X0 need not
    be dynamically consistent: every line-search rung (including the
    trailing alpha=0 rung) rolls out the true dynamics from ``prob.x0``, so
    the first accepted trajectory is feasible regardless and an eps-level
    seam error in X0 only perturbs the first linearization point. The init
    rollout is a large share of a warm 1-iteration solve, so MPC steps pass
    the shifted X by default (mpc.make_mpc_step).

    All matmuls run at HIGHEST precision: the accelerator's reduced default
    precision (TF32 on H100) keeps ~3 decimal digits in products, which
    offsets f32 iterates against a 1e-4 tolerance.
    """
    with jax.default_matmul_precision("highest"):
        return _solve(prob, opts, U0, duals, X0)


def solve_partial(prob: Problem, opts: SolverOptions,
                  U0: Optional[jnp.ndarray] = None,
                  duals: Optional[Tuple[DualState, ...]] = None,
                  X0: Optional[jnp.ndarray] = None,
                  *, it_cap: int):
    """Run the solver for at most ``it_cap`` iLQR iterations and return the
    raw loop state (an opaque tuple; pass to :func:`solve_resume`).

    The split exists for batched straggler compaction: a vmapped batch's
    while-loop runs until its SLOWEST lane converges, so wall time follows
    the lane-max iteration count (3-4x the mean on the conic configs). The
    host can run the full batch to ``it_cap``, gather the few unconverged
    lanes into a small compacted batch, and :func:`solve_resume` just those
    — per-lane iterate sequences are unchanged (every lane freezes on its
    own convergence), so the results are identical to a single uncapped
    solve."""
    with jax.default_matmul_precision("highest"):
        s0 = _warmstart_state(prob, opts, U0, duals, X0)
        return _flat_while(prob, opts, s0, it_cap)


def solve_resume(prob: Problem, opts: SolverOptions, state) -> Solution:
    """Continue a :func:`solve_partial` state to completion. Resuming an
    already-converged state is a no-op (the loop condition is false), so
    compacted batches may be padded with converged lanes. ``prob.x0`` is
    not read (the state carries the trajectory)."""
    with jax.default_matmul_precision("highest"):
        return _finalize(prob, _flat_while(prob, opts, state, None))


def _solve(prob: Problem, opts: SolverOptions,
           U0: Optional[jnp.ndarray],
           duals: Optional[Tuple[DualState, ...]],
           X0: Optional[jnp.ndarray] = None) -> Solution:
    s0 = _warmstart_state(prob, opts, U0, duals, X0)
    return _finalize(prob, _flat_while(prob, opts, s0, None))


def _warmstart_state(prob: Problem, opts: SolverOptions,
                     U0: Optional[jnp.ndarray],
                     duals: Optional[Tuple[DualState, ...]],
                     X0: Optional[jnp.ndarray] = None):
    """Initial flat-loop state: warm-start rollout + dual init. A caller-
    provided ``X0`` replaces the init rollout (see :func:`solve`)."""
    dtype = prob.x0.dtype
    N, n, m = prob.N, prob.n, prob.m
    if U0 is None:
        U0 = jnp.zeros((N - 1, m), dtype)
    if X0 is not None:
        X0 = X0.at[0].set(prob.x0)
    elif isinstance(prob.dynamics, LTVDynamics):
        # Open-loop warm-start rollout through the ladder-rollout boundary:
        # with K = 0, d = 0 the closed-loop ladder (L=1, alpha=1) reduces to
        # x+ = A x + B u0 + d, so under vmap it takes the ladder kernel
        # where ops.use_kernel picks it.
        dyn = prob.dynamics
        Xb0 = jnp.zeros((N, n), dtype).at[0].set(prob.x0)
        Xts, _ = _ls_rollouts_fn((1.0,))(
            dyn.A, dyn.B, dyn.d, Xb0, U0,
            jnp.zeros((N - 1, m, n), dtype), jnp.zeros((N - 1, m), dtype))
        X0 = Xts[0]
    else:
        X0 = prob.dynamics.rollout(prob.x0, U0)

    if duals is None:
        duals = prob.init_duals(opts.penalty_initial)
    else:
        if opts.reset_duals:
            duals = tuple(d.replace(lam=jnp.zeros_like(d.lam)) for d in duals)
        if opts.reset_penalties:
            duals = tuple(
                d.replace(rho=jnp.full_like(d.rho, opts.penalty_initial))
                for d in duals)

    K0 = jnp.zeros((N - 1, m, n), dtype)
    return (X0, U0, K0, duals, jnp.asarray(opts.reg_initial, dtype),
            jnp.asarray(jnp.inf, dtype), jnp.asarray(jnp.inf, dtype),
            jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32), jnp.zeros((), bool))


def loop_fns(prob: Problem, opts: SolverOptions, s0,
             it_cap: Optional[int] = None):
    """(cond, body) of the flat AL+iLQR loop for state ``s0`` — exposed for
    diagnostics: scanning ``body`` a fixed number of times and recording the
    state per iteration yields a convergence trace.
    ``body`` freezes a lane once its own ``cond`` is false, so over-scanning
    past convergence is a no-op (the compaction resume relies on this).

    The returned functions pin matmul precision to "highest" at their own
    trace time (like :func:`solve`/:func:`solve_partial`), so callers on an
    accelerator can trace them directly without the reduced default
    precision (TF32 on H100) offsetting the iterates."""
    cond, body = _loop_fns(prob, opts, s0, it_cap)

    def cond_pinned(s):
        with jax.default_matmul_precision("highest"):
            return cond(s)

    def body_pinned(s):
        with jax.default_matmul_precision("highest"):
            return body(s)

    return cond_pinned, body_pinned


def _flat_while(prob: Problem, opts: SolverOptions, s0,
                it_cap: Optional[int]):
    """The flat AL + iLQR ``lax.while_loop`` from state ``s0``; stops early
    at ``it_cap`` total iLQR iterations when given (straggler compaction —
    see :func:`solve_partial`)."""
    cond, body = _loop_fns(prob, opts, s0, it_cap)
    return jax.lax.while_loop(cond, body, s0)


def _loop_fns(prob: Problem, opts: SolverOptions, s0,
              it_cap: Optional[int]):
    dtype = s0[0].dtype

    # ---------------- flat AL + iLQR loop ----------------
    # One while_loop instead of outer-AL-around-inner-iLQR. Each iteration is
    # one iLQR step; when a lane's inner phase converges (or hits the inner
    # cap) the AL round bookkeeping — dual update, penalty scaling, violation
    # check — is applied inline under a mask. Three wins on an accelerator:
    #   * no synchronized round barriers under vmap: wall iterations are the
    #     max over lanes of TOTAL iterations, not the sum over rounds of the
    #     slowest lane's count per round (the SOC batches diverge hard);
    #   * the per-round J0 re-evaluation disappears — the line-search ladder
    #     carries a trailing alpha=0 rung whose rollout reproduces the
    #     current trajectory exactly, so Jts[-1] IS the current AL cost
    #     under the current duals;
    #   * one constraint evaluation per round end drives both the violation
    #     metric and the dual/penalty update (they were separate passes).
    def round_end_update(cs, cts, duals, lam_ok):
        """AL round bookkeeping from the line search's precomputed residuals
        (cs) and projected duals (cts) — no constraint re-evaluation.

        The multipliers are updated only when ``lam_ok`` — the round ended
        with an ACCEPTED rung (residuals come from exactly the trajectory
        the solver adopts) or at an inner optimum (``pre_done``: gradient
        below tolerance, the alpha=0 rung re-rolls the kept trajectory and
        this is the classical AL update point). On a STUCK round (rejected
        rung with regularization maxed, gradient not small) the only
        available residuals are the alpha=0 re-roll of a non-stationary
        trajectory whose f32 kernel-arithmetic epsilon the update would
        amplify by rho (up to penalty_max) — the round-1 residual-reuse
        change updated duals unconditionally there and the injected rho*eps
        noise snowballed the carried multipliers into NaN on ~0.5% of
        batched rocket lanes (repeatedly: stuck lanes end a round EVERY
        iteration). Stuck rounds keep lam and make progress through penalty
        scaling alone; the violation metric still uses the rung residuals
        (eps-level error, ~1e-5 against a 1e-4 tolerance)."""
        from ..cones import violation as cone_violation

        viol_r = jnp.zeros((), dtype)
        lams = []
        for con, c, ct in zip(prob.constraints, cs, cts):
            v = cone_violation(con.cone, c)
            # mask via where (not multiply): masked knots can carry inf/NaN
            # residuals on diverged lanes and 0 * inf = NaN would poison the
            # max-violation metric
            v = jnp.where(con.mask[:, None] > 0, v, 0.0)
            viol_r = jnp.maximum(viol_r, jnp.max(jnp.abs(v)))
            lams.append(ct * con.mask[:, None])
        converged = viol_r < opts.constraint_tolerance
        new_duals = tuple(
            DualState(lam=jnp.where(lam_ok, lam, dual.lam),
                      rho=jnp.where(converged, dual.rho,
                                    jnp.minimum(dual.rho * opts.penalty_scaling,
                                                opts.penalty_max)))
            for lam, dual in zip(lams, duals))
        return viol_r, converged, new_duals

    def flat_solve(s0):
        def cond(s):
            X, U, K, duals, reg, grad, viol, it_rd, it, rounds, done = s
            live = (~done) & (rounds < opts.iterations_outer)
            if it_cap is not None:
                live = live & (it < it_cap)
            return live

        def body(s):
            X, U, K, duals, reg, grad, viol, it_rd, it, rounds, done = s
            # LTV dynamics with affine constraints take the
            # expansion+backward boundary and the ladder-rollout boundary;
            # their custom_vmap rules pick a kernel or XLA per batch
            # (ops.use_kernel).
            ltv_affine = (isinstance(prob.dynamics, LTVDynamics)
                          and all(getattr(c, "is_affine", False)
                                  for c in prob.constraints))
            if ltv_affine:
                lams = tuple(d.lam for d in duals)
                rhos = tuple(d.rho for d in duals)
                Knew, dff, dV1, dV2 = expand_backward(
                    prob.cost, prob.dynamics.A, prob.dynamics.B,
                    prob.constraints, X, U, lams, rhos, reg)
            else:
                A, B, _ = prob.dynamics.linearize(X, U)
                lx, lu, lxx, luu, lux = al_expansion(prob, duals, X, U)
                Knew, dff, dV1, dV2 = backward_pass(
                    A, B, lx, lu, lxx, luu, lux, reg)

            # Gradient metric (parity with Altro's d-based gradient check).
            grad_new = jnp.max(
                jnp.max(jnp.abs(dff), axis=-1)
                / (jnp.max(jnp.abs(U), axis=-1) + 1.0))
            pre_done = grad_new < opts.gradient_tolerance

            # Parallel line search: evaluate the whole backtracking ladder of
            # step sizes at once and take the largest admissible alpha. One
            # pass, no sequential while_loop — the L rollouts vectorize
            # (LTV dynamics dispatch to the ladder kernel under vmap) and
            # it is far cheaper to compile than a third nested while. The
            # trailing alpha = 0 rung
            # reproduces the current trajectory (x starts on Xbar and the
            # feedback term vanishes), so Jts[-1] is the current AL cost —
            # no separate J0 evaluation anywhere in the solve.
            alphas_t = tuple(opts.ls_decrease ** i
                             for i in range(opts.iterations_linesearch)) \
                + (0.0,)
            alphas = jnp.asarray(alphas_t, dtype)
            if isinstance(prob.dynamics, LTVDynamics):
                dyn = prob.dynamics
                Xts, Uts = _ls_rollouts_fn(alphas_t)(
                    dyn.A, dyn.B, dyn.d, X, U, Knew, dff)
                Jts, (Cts, CTts) = jax.vmap(
                    lambda Xt, Ut: total_al_cost_res(prob, duals, Xt, Ut))(
                    Xts, Uts)
            else:
                def try_alpha(alpha):
                    Xt, Ut = rollout_closed_loop(prob.dynamics, X, U, Knew,
                                                 dff, alpha)
                    Jt, res = total_al_cost_res(prob, duals, Xt, Ut)
                    return Xt, Ut, Jt, res

                Xts, Uts, Jts, (Cts, CTts) = jax.vmap(try_alpha)(alphas)
            J = Jts[-1]
            expected = -(alphas * dV1 + alphas * alphas * dV2)
            ratio = (J - Jts) / jnp.maximum(expected, 1e-12)
            oks = jnp.where(expected > 1e-12, ratio > opts.ls_min_ratio,
                            Jts < J) & jnp.isfinite(Jts)
            idx = jnp.argmax(oks)          # first True = largest alpha
            accepted = jnp.any(oks)
            Xn = jnp.where(accepted, Xts[idx], X)
            Un = jnp.where(accepted, Uts[idx], U)
            Jn = jnp.where(accepted, Jts[idx], J)
            # accepted rung's constraint residuals / projected duals (the
            # alpha=0 rung IS the current trajectory, so the rejected case
            # selects rung -1)
            cs_acc = tuple(jnp.where(accepted, Ct[idx], Ct[-1])
                           for Ct in Cts)
            cts_acc = tuple(jnp.where(accepted, Ct[idx], Ct[-1])
                            for Ct in CTts)

            # Regularization schedule.
            reg_fail = jnp.clip(jnp.maximum(reg, opts.reg_min) * opts.reg_increase,
                                opts.reg_min, opts.reg_max)
            reg_ok = jnp.where(reg * opts.reg_decrease < opts.reg_min,
                               0.0, reg * opts.reg_decrease)
            reg_new = jnp.where(accepted, reg_ok, reg_fail)

            dJ = J - Jn
            stuck = (~accepted) & (reg >= opts.reg_max)
            # Exact-model early stop (options.early_exact_tol): a FULL
            # Newton step (rung 0, alpha=1) whose achieved/predicted
            # decrease ratio is ~1 means the quadratic model was exact
            # along the step, so the post-step inner gradient is ~0 — skip
            # the dJ-confirmation iteration (halves warm MPC iterations).
            eet = jnp.asarray(opts.early_exact_tol, dtype)
            exact_full = (accepted & (idx == 0) & (eet > 0)
                          & (expected[0] > 1e-12)
                          & (jnp.abs(ratio[0] - 1.0) <= eet))
            inner_done = (pre_done | (accepted & (dJ < opts.cost_tolerance))
                          | stuck | exact_full)
            round_end = inner_done | (it_rd + 1 >= opts.iterations_inner)

            # masked AL round bookkeeping
            viol_r, converged_r, duals_r = round_end_update(
                cs_acc, cts_acc, duals, accepted | pre_done)
            duals_new = _where_tree(round_end, duals_r, duals)
            viol_new = jnp.where(round_end, viol_r, viol)
            it_rd_new = jnp.where(round_end, 0, it_rd + 1)
            rounds_new = rounds + round_end.astype(jnp.int32)
            done_new = round_end & converged_r

            out = (Xn, Un, Knew, duals_new, reg_new, grad_new, viol_new,
                   it_rd_new, it + 1, rounds_new, done_new)
            keep = s
            # Freeze a lane as soon as ITS OWN cond is false — not just
            # `done` but also the outer-round cap. Under vmap the while_loop
            # keeps executing the body while ANY lane is live; a lane that
            # exhausted iterations_outer without converging must stop
            # updating or the batched solve diverges from the single solve
            # (caught by test_vmap_solve: a capped lane kept polishing in
            # the batch context and landed 2e-6 away).
            active = (~done) & (rounds < opts.iterations_outer)
            return _where_tree(active, out, keep)

        return cond, body

    return flat_solve(s0)


def _finalize(prob: Problem, s) -> Solution:
    X, U, K, duals, reg, grad, viol, it_rd, it, rounds, done = s

    if len(prob.constraints) == 0:
        # unconstrained: round_end_update reports zero violation, so the
        # first inner convergence (or inner cap) ends the solve; status is
        # unconditional success (parity with the nested unconstrained path)
        viol = jnp.zeros((), X.dtype)

    stats = Stats(
        iterations=it,
        outer_iterations=rounds,
        cost=prob.cost.total(X, U),
        viol=viol,
        gradient=grad,
        status=done.astype(jnp.int32),
    )
    return Solution(X=X, U=U, K=K, duals=duals, stats=stats)
