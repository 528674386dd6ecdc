"""Gait schedules: phase tables + branchless phase lookup.

Parity with Woofer/MPCControl/Structs/GaitParams.jl:1-105 (trot/stand/pronk/
pace/bound/flying-trot contact tables) and gait.jl:1-41 (phase lookup by
t mod phase_length) — reimplemented branchlessly (searchsorted over the
cumulative phase times) so the whole gait machinery jits.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from ...utils import struct


@struct.dataclass
class Gait:
    contact_phases: jnp.ndarray  # [num_phases, 4] {0,1}
    phase_times: jnp.ndarray     # [num_phases]
    alpha: float = struct.field(pytree_node=False, default=0.5)
    beta: float = struct.field(pytree_node=False, default=0.5)

    @property
    def num_phases(self) -> int:
        return self.contact_phases.shape[0]

    @property
    def phase_length(self):
        return jnp.sum(self.phase_times)

    def phase_at(self, t):
        """Phase index at time t (gait.jl get_phase, branchless)."""
        pt = jnp.mod(t, self.phase_length)
        ends = jnp.cumsum(self.phase_times)
        return jnp.searchsorted(ends, pt, side="right")

    def phase_time(self, t, phase):
        """Time elapsed within `phase` (gait.jl get_phase_time)."""
        pt = jnp.mod(t, self.phase_length)
        starts = jnp.concatenate([jnp.zeros(1, self.phase_times.dtype),
                                  jnp.cumsum(self.phase_times)[:-1]])
        return pt - starts[phase]

    def next_phase(self, phase):
        return jnp.mod(phase + 1, self.num_phases)

    def contacts_at(self, t):
        return self.contact_phases[self.phase_at(t)]


def _mk(table, times) -> Gait:
    return Gait(contact_phases=jnp.asarray(np.array(table).T, jnp.float64),
                phase_times=jnp.asarray(times, jnp.float64))


def trot(stance_time=0.6, swing_time=0.2) -> Gait:
    # rows of the Julia matrix are legs; columns are phases
    return _mk([[1, 1, 1, 0], [1, 0, 1, 1], [1, 0, 1, 1], [1, 1, 1, 0]],
               [stance_time, swing_time, stance_time, swing_time])


def stand() -> Gait:
    return _mk([[1, 1], [1, 1], [1, 1], [1, 1]], [1.0, 1.0])


def pronk(stance_time=0.2, flight_time=0.1) -> Gait:
    return _mk([[1, 0], [1, 0], [1, 0], [1, 0]], [stance_time, flight_time])


def pace(stance_time=0.6, swing_time=0.2) -> Gait:
    return _mk([[1, 1, 1, 0], [1, 0, 1, 1], [1, 1, 1, 0], [1, 0, 1, 1]],
               [stance_time, swing_time, stance_time, swing_time])


def bound(front_time=0.2, back_time=0.2, stance_time=0.1) -> Gait:
    return _mk([[1, 1, 1, 0], [1, 1, 1, 0], [1, 0, 1, 1], [1, 0, 1, 1]],
               [stance_time, front_time, stance_time, back_time])


def flying_trot(stance_time=0.2, flight_time=0.1) -> Gait:
    return _mk([[1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 1, 0], [1, 0, 0, 0]],
               [stance_time, flight_time, stance_time, flight_time])


GAITS = {"trot": trot, "stand": stand, "pronk": pronk, "pace": pace,
         "bound": bound, "flying_trot": flying_trot}
