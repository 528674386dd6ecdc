"""Trajectory-optimization problem container (parity with TO ``Problem``).

A Problem is a pure pytree: dynamics + quadratic objective + a tuple of
affine conic constraint blocks + initial state. All shapes static, so one
jitted solve serves an entire family of problems (every MPC step, every
scenario in a vmap batch).
"""
from __future__ import annotations

from typing import Tuple, Union

import jax.numpy as jnp
from .utils import struct

from .constraints import ConicConstraint, DualState
from .costs import QuadCost
from .dynamics import LTVDynamics, NonlinearDynamics

Dynamics = Union[LTVDynamics, NonlinearDynamics]


@struct.dataclass
class Problem:
    dynamics: Dynamics
    cost: QuadCost
    constraints: Tuple[ConicConstraint, ...]
    x0: jnp.ndarray  # [n]

    @property
    def N(self) -> int:
        return self.cost.N

    @property
    def n(self) -> int:
        return self.cost.n

    @property
    def m(self) -> int:
        return self.cost.m

    def init_duals(self, penalty_initial) -> Tuple[DualState, ...]:
        dtype = self.x0.dtype
        return tuple(DualState.init(c, penalty_initial, dtype) for c in self.constraints)

    def max_violation(self, X, U):
        viol = jnp.zeros((), X.dtype)
        for con in self.constraints:
            viol = jnp.maximum(viol, con.max_violation(X, U))
        return viol

    def rollout(self, U=None):
        """Open-loop rollout from x0 (parity with TO ``rollout!``)."""
        if U is None:
            U = jnp.zeros((self.N - 1, self.m), self.x0.dtype)
        return self.dynamics.rollout(self.x0, U)
