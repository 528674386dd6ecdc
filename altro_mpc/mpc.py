"""Warm-started receding-horizon MPC engine.

Accelerator-native rebuild of the reference's MPC loops (``run_MPC``
random_linear_problem.jl:85-189 and analogs): the whole receding-horizon run
is one ``lax.scan`` over steps, each step being

    propagate x0 through the first control (+ noise)
    advance the tracking-cost window          (TO.update_trajectory!)
    shift primal warm starts                  (RD.shift_fill!)
    shift duals, reset penalties              (Altro.shift_fill!)
    solve (warm-started)

so the entire closed loop jits once and ``vmap``s over scenario batches —
the headline capability the single-threaded reference lacks
(SURVEY.md section 2.8).

The lockstep variant solves the same QP with the in-framework ADMM solver
each step and records inf-norm trajectory differences — the reference's
cross-solver equivalence oracle (err_traj / err_x0, SURVEY.md section 4.1).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from .utils import struct

from .costs import retarget_tracking, tracking_objective
from .dynamics import LTVDynamics
from .problem import Problem
from .solver import admm_conic, admm_qp
from .solver.altro import Solution, solve
from .solver.options import SolverOptions
from .transcribe import to_batch_conic, to_batch_qp


def default_noise_model(x_prop, noise_i):
    """1% inf-norm process noise (random_linear_problem.jl:129)."""
    return x_prop + noise_i * jnp.max(jnp.abs(x_prop)) / 100.0


def gen_tracking_mpc(prob: Problem, X_track, U_track, N_mpc: int,
                     Qk: float = 10.0, Rk: float = 0.1,
                     Qfk: Optional[float] = None, dt: float = 0.1) -> Problem:
    """Long-horizon problem + reference -> N_mpc-step tracking MPC problem.

    Parity with ``gen_tracking_problem`` (benchmarks/mpc.jl:11-47): diagonal
    tracking weights, same constraints minus any goal constraint, index
    ranges clipped to the window (stop=N-1 maps to N_mpc-1, so the window's
    terminal knot is inactive for every surviving block)."""
    Qfk = Qk if Qfk is None else Qfk
    n, m = prob.n, prob.m
    dtype = prob.x0.dtype
    Q = jnp.eye(n, dtype=dtype) * Qk
    R = jnp.eye(m, dtype=dtype) * Rk
    Qf = jnp.eye(n, dtype=dtype) * Qfk
    cost = tracking_objective(Q, R, Qf, X_track[:N_mpc], U_track[:N_mpc - 1],
                              dt=dt)
    dyn = prob.dynamics
    dyn_mpc = LTVDynamics(A=dyn.A[:N_mpc - 1], B=dyn.B[:N_mpc - 1],
                          d=dyn.d[:N_mpc - 1])
    cons = tuple(
        c.replace(Cx=c.Cx[:N_mpc], Cu=c.Cu[:N_mpc], b=c.b[:N_mpc],
                  mask=c.mask[:N_mpc].at[N_mpc - 1].set(0.0))
        for c in prob.constraints if c.name != "goal")
    return Problem(dynamics=dyn_mpc, cost=cost, constraints=cons,
                   x0=X_track[0])


def shift_fill(arr):
    """Shift one knot forward, repeating the last entry
    (parity with RD.shift_fill!)."""
    return jnp.concatenate([arr[1:], arr[-1:]], axis=0)


def track_window(X_track, U_track, k0, N):
    """Extract the [k0, k0+N) tracking window (clamped at the tail like
    dynamic_slice; callers keep k0 <= len - N as the reference does)."""
    n = X_track.shape[-1]
    m = U_track.shape[-1]
    k0 = jnp.asarray(k0)
    z = jnp.zeros((), k0.dtype)
    Xw = jax.lax.dynamic_slice(X_track, (k0, z), (N, n))
    Uw = jax.lax.dynamic_slice(U_track, (k0, z), (N - 1, m))
    return Xw, Uw


@struct.dataclass
class MPCResults:
    """Per-step records (leading axis = MPC step)."""

    X: jnp.ndarray           # [T, N, n] ALTRO solutions
    U: jnp.ndarray           # [T, N-1, m]
    iters: jnp.ndarray       # [T]
    status: jnp.ndarray      # [T]
    viol: jnp.ndarray        # [T]
    x0: jnp.ndarray          # [T, n] noisy initial states


def _xws_corrector(dyn):
    """Build-time exact warm-start state corrector for LTI dynamics.

    The previous solve's states, shifted one knot, ARE the warm-start init
    rollout except for the x0 seam: with knot-constant stacks (A, B, d) the
    true rollout of the shifted controls from the new x0 satisfies
    ``x_k = X_shift[k] + A^k e0`` with ``e0 = x0_new - X_shift[0]`` (the
    process noise of one step), because the B/d terms cancel knot-by-knot.
    So the exact init rollout is the shifted trajectory plus one einsum
    against the build-time constants ``Phi_k = A^k`` — no per-step rollout
    dispatch, a large share of a warm 1-iteration solve.

    The tail knot uses a one-step extension of the old trajectory under the
    repeated last control (matching ``shift_fill``) so the recursion holds
    through k = N-1. Returns ``None`` (caller falls back to the solver's
    internal init rollout) for nonlinear dynamics, genuinely time-varying
    stacks, or tracer-stage construction.
    """
    if not isinstance(dyn, LTVDynamics):
        return None
    try:
        A = np.asarray(dyn.A)
        Bm = np.asarray(dyn.B)
        d = np.asarray(dyn.d)
    except Exception:
        return None  # traced construction: no concrete stacks to inspect
    if not (np.allclose(A, A[:1]) and np.allclose(Bm, Bm[:1])
            and np.allclose(d, d[:1])):
        return None
    N, n = A.shape[0] + 1, A.shape[-1]
    Phis = np.empty((N, n, n), np.float64)
    Phis[0] = np.eye(n)
    for k in range(1, N):
        Phis[k] = A[0].astype(np.float64) @ Phis[k - 1]
    Phis = jnp.asarray(Phis, dyn.A.dtype)
    A_l, B_l, d_l = dyn.A[-1], dyn.B[-1], dyn.d[-1]

    def correct(X, U_ws, x0_new):
        with jax.default_matmul_precision("highest"):
            x_ext = A_l @ X[-1] + B_l @ U_ws[-1] + d_l
            Xs = jnp.concatenate([X[1:], x_ext[None]], axis=0)
            e0 = x0_new - Xs[0]
            return Xs + jnp.einsum("kij,j->ki", Phis, e0)

    return correct


def make_mpc_step(prob_mpc: Problem, opts: SolverOptions, X_track, U_track,
                  noise_model=default_noise_model, constraints_fn=None,
                  shared_k: bool = False, warm_start: str = "shift"):
    """Build the single warm-started MPC step as a jittable function
    ``step(carry, noise_i) -> (carry, MPCResults)``.

    Exposed separately from :func:`run_mpc` because driving the step from the
    host (jit the step, loop in Python) keeps the compiled program small
    and lets a caller drive one step per control period.

    ``shared_k=True`` returns the batched-driver variant
    ``step(carry, noise_i, k) -> (carry, MPCResults)`` with the window index
    ``k`` a SEPARATE argument (vmap it with ``in_axes=(0, 0, None)``) and
    carry = (x0, X, U, duals). Every scenario of a batched MPC run sits at
    the same step index, so the tracking-window slice, the cost retarget,
    and the ``constraints_fn`` window are computed once per step instead of
    per lane — and stay unbatched through the solve (shared constraint /
    cost data in the expansion and line-search cost evaluations).

    The carry holds the previous solution's STATES as well as its controls:
    for LTI windows the solver is seeded with the shifted states plus the
    exact seam correction (:func:`_xws_corrector`), which skips the
    open-loop init rollout inside :func:`altro_mpc.solve` while linearizing
    iteration 1 at exactly the trajectory that rollout would produce.

    ``warm_start``: "shift" (default) carries the previous solution —
    controls shifted one knot, duals shifted, states seam-corrected.
    "track" seeds every solve from the TRACKING WINDOW's controls instead
    (duals still shift; set ``opts.reset_duals=True`` for a fully cold
    start). Measured motivation (round 5, rocket_warmtrap_r5.json): on
    knife-edge SOC lanes the shifted-control seed can trap the solve at a
    feasible point up to 38% above the optimum — at ANY tolerance, even
    the tight config's 23-mean-iteration chain — while the same instance
    solved from the tracking controls reaches it; the trap is the
    shifted-control seed specifically (fresh duals alone don't fix it).
    """
    N = prob_mpc.N
    dyn = prob_mpc.dynamics
    xws = _xws_corrector(dyn)
    if warm_start not in ("shift", "track"):
        raise ValueError(f"warm_start must be 'shift' or 'track', got "
                         f"{warm_start!r}")

    def _solve_at(k_new, x0_new, X, U, duals):
        Xw, Uw = track_window(X_track, U_track, k_new, N)
        cost_new = retarget_tracking(prob_mpc.cost, Xw, Uw)
        prob_k = prob_mpc.replace(cost=cost_new, x0=x0_new)
        if constraints_fn is not None:
            # time-varying constraint window (grasp/quadruped pattern:
            # constraint data as pytree leaves, refreshed without re-jit)
            prob_k = prob_k.replace(constraints=constraints_fn(k_new))

        U_ws = shift_fill(U) if warm_start == "shift" else Uw
        duals_ws = tuple(d.shift() for d in duals)
        X_ws = (None if (xws is None or warm_start != "shift")
                else xws(X, U_ws, x0_new))
        return solve(prob_k, opts, U0=U_ws, duals=duals_ws, X0=X_ws)

    def step(carry, noise_i):
        x0, X, U, duals, k = carry
        x_prop = dyn.step(x0, U[0], 0)
        x0_new = noise_model(x_prop, noise_i)
        k_new = k + 1
        sol = _solve_at(k_new, x0_new, X, U, duals)
        out = MPCResults(X=sol.X, U=sol.U, iters=sol.stats.iterations,
                         status=sol.stats.status, viol=sol.stats.viol,
                         x0=x0_new)
        return (x0_new, sol.X, sol.U, sol.duals, k_new), out

    def step_shared(carry, noise_i, k):
        x0, X, U, duals = carry
        x_prop = dyn.step(x0, U[0], 0)
        x0_new = noise_model(x_prop, noise_i)
        sol = _solve_at(k + 1, x0_new, X, U, duals)
        out = MPCResults(X=sol.X, U=sol.U, iters=sol.stats.iterations,
                         status=sol.stats.status, viol=sol.stats.viol,
                         x0=x0_new)
        return (x0_new, sol.X, sol.U, sol.duals), out

    def init_carry(start_k: int = 0):
        sol0 = solve(prob_mpc, opts)
        if shared_k:
            return (prob_mpc.x0, sol0.X, sol0.U, sol0.duals)
        return (prob_mpc.x0, sol0.X, sol0.U, sol0.duals,
                jnp.asarray(start_k))

    return (step_shared if shared_k else step), init_carry


def make_mpc_step_compacted(prob_mpc: Problem, opts: SolverOptions,
                            X_track, U_track,
                            noise_model=default_noise_model,
                            constraints_fn=None, it_cap: int = 24,
                            warm_start: str = "shift"):
    """Batched-driver MPC step with STRAGGLER COMPACTION.

    A vmapped batch's solve runs until its slowest lane converges, so wall
    time follows the lane-MAX iteration count — 3-4x the lane mean on the
    conic configs. This variant splits the step in three jittable pieces
    so the host can compact the tail:

      ``partial(carry, noise_i, k) -> (state, x0_new)``
          propagate + shift + run the solve for at most ``it_cap``
          iterations (vmap with ``in_axes=(0, 0, None)``);
      ``resume(state_block, k) -> state_block``
          continue a GATHERED block of unconverged lanes to completion
          (vmap over the block; resuming converged lanes is a no-op);
      ``extract(state, x0_new) -> (carry, MPCResults)``
          build the next warm-start carry + per-step records.

    Per-lane iterate sequences are identical to the plain step (every lane
    freezes on its own convergence), so results match
    ``make_mpc_step(shared_k=True)`` exactly; only the batch scheduling
    changes. Use :func:`run_compacted_step` for the host orchestration.
    """
    from .solver import altro as _alt

    N = prob_mpc.N
    dyn = prob_mpc.dynamics
    xws = _xws_corrector(dyn)
    if warm_start not in ("shift", "track"):
        raise ValueError(f"warm_start must be 'shift' or 'track', got "
                         f"{warm_start!r}")

    def _prob_at(k_new, x0_new):
        Xw, Uw = track_window(X_track, U_track, k_new, N)
        prob_k = prob_mpc.replace(
            cost=retarget_tracking(prob_mpc.cost, Xw, Uw), x0=x0_new)
        if constraints_fn is not None:
            prob_k = prob_k.replace(constraints=constraints_fn(k_new))
        return prob_k, Uw

    def partial(carry, noise_i, k):
        x0, X, U, duals = carry
        x_prop = dyn.step(x0, U[0], 0)
        x0_new = noise_model(x_prop, noise_i)
        prob_k, Uw = _prob_at(k + 1, x0_new)
        U_ws = shift_fill(U) if warm_start == "shift" else Uw
        duals_ws = tuple(d.shift() for d in duals)
        X_ws = (None if (xws is None or warm_start != "shift")
                else xws(X, U_ws, x0_new))
        state = _alt.solve_partial(prob_k, opts, U_ws, duals_ws, X_ws,
                                   it_cap=it_cap)
        return state, x0_new

    def resume(state, k, it_cap=None):
        # prob.x0 is not read on resume (the state carries the trajectory).
        # ``it_cap`` (static) continues to an ABSOLUTE iteration count
        # instead of completion — the solver state carries the global
        # iteration counter, so capped resumes compose exactly (multi-level
        # compaction in make_mpc_step_device_compacted).
        prob_k, _ = _prob_at(k + 1, prob_mpc.x0)
        with jax.default_matmul_precision("highest"):
            return _alt._flat_while(prob_k, opts, state, it_cap)

    def extract(state, x0_new, k):
        prob_k, _ = _prob_at(k + 1, prob_mpc.x0)
        sol = _alt._finalize(prob_k, state)
        out = MPCResults(X=sol.X, U=sol.U, iters=sol.stats.iterations,
                         status=sol.stats.status, viol=sol.stats.viol,
                         x0=x0_new)
        return (x0_new, sol.X, sol.U, sol.duals), out

    def init_carry(start_k: int = 0):
        sol0 = solve(prob_mpc, opts)
        return (prob_mpc.x0, sol0.X, sol0.U, sol0.duals)

    return partial, resume, extract, init_carry


def make_mpc_step_device_compacted(prob_mpc: Problem, opts: SolverOptions,
                                   X_track, U_track,
                                   noise_model=default_noise_model,
                                   constraints_fn=None, it_cap: int = 24,
                                   block: int = 128,
                                   levels: tuple = (),
                                   warm_start: str = "shift"):
    """Batch-level MPC step with DEVICE-SIDE straggler compaction — one
    jitted program per step, so pipelined dispatch is preserved, unlike
    the host-orchestrated
    :func:`run_compacted_step`.

    The program: run every lane's solve to ``it_cap`` iterations, gather
    the ``block`` unconverged-first lanes (stable argsort of the done
    flags), resume just those to completion at 1/8th the per-iteration
    cost, scatter back, then run a full-batch catch-all resume — a no-op
    (one loop-condition evaluation) unless more than ``block`` lanes were
    still unconverged at the cap, so results are ALWAYS identical to the
    plain step; only the scheduling changes.

    Returns ``(step_batch, init_carry)`` where
    ``step_batch(carry_B, noise_B, k) -> (carry_B, MPCResults_B)`` operates
    on whole-batch pytrees (do NOT vmap it; jit it directly) and
    ``init_carry()`` builds one lane's carry (vmap it over the batch).
    Rocket SOC tail at B=1024: mean 15.4 iterations/solve but the per-step
    lane max averages 100.8 — wall time follows the max, so capping the
    full-batch phase at ~p90 and finishing ~10 stragglers in a 128-lane
    block cuts most of the straggler tax.

    ``levels`` adds FURTHER compaction stages inside the straggler block:
    each ``(extra_cap, sub_block)`` entry runs the current block for
    ``extra_cap`` more iterations (the solver's iteration counter is
    absolute, so capped resumes compose exactly), then gathers the
    ``sub_block`` unconverged-first lanes of THAT block for the next
    stage; the innermost stage runs to completion. Every stage ends with
    its own catch-all resume (free unless its gather overflowed), so
    results stay bit-identical to the plain step for any schedule."""
    partial, resume, extract, init_carry = make_mpc_step_compacted(
        prob_mpc, opts, X_track, U_track, noise_model, constraints_fn,
        it_cap=it_cap, warm_start=warm_start)
    sched = ((it_cap, block),) + tuple(levels)

    def compact(states, k, lvl, cum):
        # `states` has just run to the absolute iteration cap `cum`; gather
        # this level's block of stragglers, finish them (possibly through
        # deeper levels), scatter back, then catch-all to completion.
        blk = sched[lvl][1]
        done = states[10]
        take = jnp.argsort(done.astype(jnp.int32), stable=True)[:blk]
        sub = jax.tree_util.tree_map(lambda a: a[take], states)
        if lvl + 1 < len(sched):
            extra = sched[lvl + 1][0]
            sub = jax.vmap(
                lambda s: resume(s, k, it_cap=cum + extra))(sub)
            sub = compact(sub, k, lvl + 1, cum + extra)
        else:
            sub = jax.vmap(resume, (0, None))(sub, k)
        states = jax.tree_util.tree_map(
            lambda a, b: a.at[take].set(b), states, sub)
        # catch-all for >blk stragglers: exact, and free when none
        return jax.vmap(resume, (0, None))(states, k)

    def step_batch(carry, noise_i, k):
        states, x0n = jax.vmap(partial, (0, 0, None))(carry, noise_i, k)
        states = compact(states, k, 0, it_cap)
        return jax.vmap(extract, (0, 0, None))(states, x0n, k)

    return step_batch, init_carry


def run_compacted_step(jpartial, jresume, jextract, carry, noise_t, k,
                       block: int = 128):
    """One compacted MPC step, host-orchestrated.

    ``jpartial``/``jresume``/``jextract`` are the jitted vmapped pieces from
    :func:`make_mpc_step_compacted`:

        jpartial = jax.jit(jax.vmap(partial, in_axes=(0, 0, None)))
        jresume  = jax.jit(jax.vmap(resume, in_axes=(0, None)))
        jextract = jax.jit(jax.vmap(extract, in_axes=(0, 0, None)))

    After the capped full-batch pass, unconverged lane indices are gathered
    into ``block``-sized sub-batches (padded by cycling, which is safe:
    resuming a lane twice scatters the identical converged state) and
    resumed to completion. ``block`` must keep the Pallas lane-packing
    alignment (multiples of 128).
    """
    import numpy as np

    state, x0n = jpartial(carry, noise_t, k)
    done = np.asarray(state[10])
    idx = np.nonzero(~done)[0]
    while idx.size:
        take = np.resize(idx[:block], block)
        sub = jax.tree_util.tree_map(lambda a: a[take], state)
        sub = jresume(sub, k)
        state = jax.tree_util.tree_map(
            lambda a, b: a.at[jnp.asarray(take)].set(b), state, sub)
        idx = idx[block:]
    return jextract(state, x0n, k)


def run_mpc(prob_mpc: Problem, opts: SolverOptions, X_track, U_track,
            noise, start_k: int = 0, noise_model=default_noise_model,
            constraints_fn=None) -> MPCResults:
    """Closed-loop ALTRO MPC tracking (X_track, U_track).

    ``noise`` is [T, n] standard-normal; ``noise_model(x_prop, noise_i)``
    maps it to the perturbed initial state (default: 1% inf-norm noise).
    Returns stacked per-step results.
    """
    step, init_carry = make_mpc_step(prob_mpc, opts, X_track, U_track,
                                     noise_model, constraints_fn)
    _, results = jax.lax.scan(step, init_carry(start_k), noise)
    return results


# ----------------------------------------------------------------------------
# Lockstep ALTRO-vs-ADMM-QP oracle loop (the reference's run_MPC comparison)
# ----------------------------------------------------------------------------

@struct.dataclass
class LockstepResults:
    err_X: jnp.ndarray       # [T] inf-norm state-trajectory difference
    err_U: jnp.ndarray       # [T] inf-norm control difference
    err_x0: jnp.ndarray      # [T, 2] distance of each solution's x0 to true x0
    iters: jnp.ndarray       # [T, 2] (altro, qp)
    status: jnp.ndarray      # [T, 2]
    viol: jnp.ndarray        # [T]


def _qp_shift_warmstart(x, y, n, m, N, ps):
    """Shift QP primal/dual warm starts one knot (parity with the circshift
    warm start at random_linear_problem.jl:150-157). Layout: primal knots of
    (n+m); rows = dynamics (N-1)*n, x0 n, then constraint blocks, each
    contributing N*p contiguous knot-major rows. Each block's segment is
    shifted independently by its own p, tail filled by repeating the last
    knot (the rows are block-major, so a single roll of the concatenated
    tail would land duals in the wrong block)."""
    xf = x[-n:]
    x_s = jnp.roll(x, -(n + m))
    x_s = x_s.at[-n:].set(xf)

    lam_dyn = jnp.roll(y[:(N - 1) * n], -n)
    lam_x0 = y[(N - 1) * n:N * n]
    segs = [lam_dyn, lam_x0]
    off = N * n
    for p in ps:
        seg = y[off:off + N * p].reshape(N, p)
        segs.append(jnp.concatenate([seg[1:], seg[-1:]], axis=0).reshape(-1))
        off += N * p
    return x_s, jnp.concatenate(segs)


def run_mpc_lockstep(prob_mpc: Problem, opts: SolverOptions, X_track, U_track,
                     noise, qp_eps: Optional[float] = None,
                     qp_max_iter: int = 4000,
                     noise_model=default_noise_model,
                     constraints_fn=None) -> LockstepResults:
    """Run ALTRO and the in-framework ADMM QP in lockstep on the same MPC
    instances and record their agreement (reference run_MPC,
    random_linear_problem.jl:85-189)."""
    N, n, m = prob_mpc.N, prob_mpc.n, prob_mpc.m
    qp_eps = float(opts.cost_tolerance) if qp_eps is None else qp_eps
    dyn = prob_mpc.dynamics

    sol0 = solve(prob_mpc, opts)
    work0 = admm_qp.setup(to_batch_qp(prob_mpc))
    qsol0 = admm_qp.solve(work0, eps_abs=qp_eps, max_iter=qp_max_iter)

    def step(carry, noise_i):
        x0, U, duals, xq, yq, k = carry
        x_prop = dyn.step(x0, U[0], 0)
        x0_new = noise_model(x_prop, noise_i)
        k_new = k + 1

        Xw, Uw = track_window(X_track, U_track, k_new, N)
        cost_new = retarget_tracking(prob_mpc.cost, Xw, Uw)
        prob_k = prob_mpc.replace(cost=cost_new, x0=x0_new)
        if constraints_fn is not None:
            # time-varying constraint window (grasp/quadruped pattern:
            # constraint data as pytree leaves, refreshed without re-jit)
            prob_k = prob_k.replace(constraints=constraints_fn(k_new))

        # ALTRO side
        U_ws = shift_fill(U)
        duals_ws = tuple(d.shift() for d in duals)
        sol = solve(prob_k, opts, U0=U_ws, duals=duals_ws)

        # QP side: refresh q and the x0 rows, shift warm starts, solve.
        # With fixed constraints the one-time KKT factor stays valid (only
        # q/l/u change); time-varying constraints change A, so refactor.
        qp_k = to_batch_qp(prob_k)
        if constraints_fn is None:
            work = work0.replace(qp=qp_k)
        else:
            work = admm_qp.setup(qp_k)
        ps = tuple(c.p for c in prob_mpc.constraints)
        xw, yw = _qp_shift_warmstart(xq, yq, n, m, N, ps)
        qsol = admm_qp.solve(work, x0=xw, y0=yw, eps_abs=qp_eps,
                             max_iter=qp_max_iter)
        Xq, Uq = admm_qp.extract_traj(qp_k, qsol.x)

        out = LockstepResults(
            err_X=jnp.max(jnp.abs(sol.X - Xq)),
            err_U=jnp.max(jnp.abs(sol.U - Uq)),
            err_x0=jnp.stack([jnp.linalg.norm(sol.X[0] - x0_new),
                              jnp.linalg.norm(Xq[0] - x0_new)]),
            iters=jnp.stack([sol.stats.iterations, qsol.iterations]),
            status=jnp.stack([sol.stats.status, qsol.status]),
            viol=sol.stats.viol,
        )
        carry_new = (x0_new, sol.U, sol.duals, qsol.x, qsol.y, k_new)
        return carry_new, out

    carry0 = (prob_mpc.x0, sol0.U, sol0.duals, qsol0.x, qsol0.y,
              jnp.asarray(0))
    _, results = jax.lax.scan(step, carry0, noise)
    return results


def run_mpc_lockstep_conic(prob_mpc: Problem, opts: SolverOptions, X_track,
                           U_track, noise, conic_eps: Optional[float] = None,
                           conic_max_iter: int = 20000,
                           noise_model=default_noise_model,
                           constraints_fn=None) -> LockstepResults:
    """ALTRO vs the in-framework conic ADMM on SOC-constrained MPC problems
    (the ECOS/COSMO lockstep of the rocket/grasp loops, simple_rocket.jl:106,
    grasp_mpc.jl:7). The conic baseline is solved cold each step — parity
    with the reference's fresh-JuMP-model-per-step pattern — but with the
    factored KKT reused."""
    N, n, m = prob_mpc.N, prob_mpc.n, prob_mpc.m
    conic_eps = float(opts.cost_tolerance) if conic_eps is None else conic_eps
    dyn = prob_mpc.dynamics

    sol0 = solve(prob_mpc, opts)
    work0 = admm_conic.setup(to_batch_conic(prob_mpc))

    def step(carry, noise_i):
        x0, U, duals, xc, yc, k = carry
        x_prop = dyn.step(x0, U[0], 0)
        x0_new = noise_model(x_prop, noise_i)
        k_new = k + 1

        Xw, Uw = track_window(X_track, U_track, k_new, N)
        cost_new = retarget_tracking(prob_mpc.cost, Xw, Uw)
        prob_k = prob_mpc.replace(cost=cost_new, x0=x0_new)
        if constraints_fn is not None:
            # time-varying constraint window (grasp/quadruped pattern:
            # constraint data as pytree leaves, refreshed without re-jit)
            prob_k = prob_k.replace(constraints=constraints_fn(k_new))

        U_ws = shift_fill(U)
        duals_ws = tuple(d.shift() for d in duals)
        sol = solve(prob_k, opts, U0=U_ws, duals=duals_ws)

        # With fixed constraints the one-time KKT factor stays valid; a
        # time-varying A requires a per-step refactor.
        cp_k = to_batch_conic(prob_k)
        if constraints_fn is None:
            work = work0.replace(prob=cp_k)
        else:
            work = admm_conic.setup(cp_k)
        csol = admm_conic.solve(work, x0=xc, y0=yc, eps_abs=conic_eps,
                                max_iter=conic_max_iter)
        Xq, Uq = admm_conic.extract_traj(cp_k, csol.x)

        out = LockstepResults(
            err_X=jnp.max(jnp.abs(sol.X - Xq)),
            err_U=jnp.max(jnp.abs(sol.U - Uq)),
            err_x0=jnp.stack([jnp.linalg.norm(sol.X[0] - x0_new),
                              jnp.linalg.norm(Xq[0] - x0_new)]),
            iters=jnp.stack([sol.stats.iterations, csol.iterations]),
            status=jnp.stack([sol.stats.status, csol.status]),
            viol=sol.stats.viol,
        )
        carry_new = (x0_new, sol.U, sol.duals, csol.x, csol.y, k_new)
        return carry_new, out

    NNv = work0.prob.num_vars
    Mv = work0.prob.A.shape[0]
    dtype = prob_mpc.x0.dtype
    carry0 = (prob_mpc.x0, sol0.U, sol0.duals,
              jnp.zeros(NNv, dtype), jnp.zeros(Mv, dtype), jnp.asarray(0))
    _, results = jax.lax.scan(step, carry0, noise)
    return results
