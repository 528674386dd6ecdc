"""Solver options (parity with Altro.jl ``SolverOptions`` fields the
reference uses; see run_random_linear.jl:41-49, grasp_benchmark.jl:19-34).

Numeric tunings are pytree leaves so one compiled solve serves many option
sets; iteration caps are static (they size ``lax.while_loop`` guards).
"""
from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct


@struct.dataclass
class SolverOptions:
    # tolerances (reference: cost/constraint tolerance 1e-4 in every MPC loop)
    cost_tolerance: float = 1e-4
    gradient_tolerance: float = 1e-5
    constraint_tolerance: float = 1e-4

    # augmented-Lagrangian schedule
    penalty_initial: float = 1.0
    penalty_scaling: float = 10.0
    penalty_max: float = 1e8

    # backward-pass regularization
    reg_initial: float = 0.0
    reg_min: float = 1e-8
    reg_max: float = 1e8
    reg_increase: float = 10.0
    reg_decrease: float = 0.5

    # line search. ls_decrease is static: the alpha ladder is baked into the
    # compiled program (and into the fused rollout kernel as constants).
    ls_decrease: float = struct.field(pytree_node=False, default=0.5)
    ls_min_ratio: float = 1e-4   # Armijo-style acceptance on expected decrease

    # Exact-model early stop (0.0 disables). When an iteration accepts the
    # FULL Newton step (alpha=1) and the achieved/predicted cost decrease
    # ratio is within this tolerance of 1, the local quadratic model was
    # exact along the step, so the post-step gradient of the inner AL
    # problem is ~0 and the usual dJ-confirmation iteration is redundant —
    # the inner phase is declared converged immediately. Exact for
    # LTV dynamics + quadratic cost + AL penalties with an uncrossed
    # projection active set (kink crossings show up as ratio != 1); warm
    # MPC re-solves hit this every step, halving iterations from 2 to 1.
    early_exact_tol: float = 0.0

    # iteration caps (static: they bound the while loops)
    iterations_outer: int = struct.field(pytree_node=False, default=30)
    iterations_inner: int = struct.field(pytree_node=False, default=50)
    iterations_linesearch: int = struct.field(pytree_node=False, default=10)

    # warm-start semantics (parity with reference MPC loops:
    # reset_duals=false, penalties reset each solve)
    reset_duals: bool = struct.field(pytree_node=False, default=False)
    reset_penalties: bool = struct.field(pytree_node=False, default=True)

    # (An O(log N) associative-scan backward pass was built, measured, and
    # deleted: it lost at every (N, B) tried, B=1/N=1001 included, on an
    # earlier accelerator; docs/DESIGN.md 'Parallel-in-time Riccati'. The
    # reference's `static_bp` StaticArrays toggle has no analog — shapes
    # are always static under XLA.)
