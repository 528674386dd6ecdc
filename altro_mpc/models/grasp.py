"""Grasp-optimization benchmark (benchmark 3, time-varying SOC constraints).

Parity with benchmarks/grasp_optimization/src/grasp_model.jl:4-92,
src/grasp_problem.jl:1-107, and the in-place constraint rotation of
src/grasp_mpc_helpers.jl:46-55:

- 2-contact rigid square (n=6 pos/vel, m=6 two 3-D contact forces),
  mu=0.5, mass=0.2, f_max=3, exact double-integrator discrete dynamics
- cubic orientation trajectory theta(t), theta_dd(t)
- per-knot contact normals v_i(theta), torque skews B_i(theta)
- constraints per knot: torque balance [B1 B2]u = [thdd,0,0] (Equality),
  max normal force v_i'F_i <= f_max (Inequality), two SOC friction cones
  ||(I - v v')F|| <= mu v'F

The whole-horizon constraint data lives as stacked arrays; MPC steps take
windows by ``dynamic_slice`` — the accelerator-native version of the reference's
in-place constraint matrix rotation (no re-jit).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..constraints import (ConicConstraint, goal_constraint, linear_constraint,
                           norm_constraint2)
from ..cones import Cone
from ..costs import lqr_objective
from ..dynamics import lti_dynamics
from ..problem import Problem


@struct.dataclass
class GraspObject:
    """Square-object data with full-horizon contact stacks (length Nt)."""

    mu: float = struct.field(pytree_node=False, default=0.5)
    mass: float = struct.field(pytree_node=False, default=0.2)
    f_max: float = struct.field(pytree_node=False, default=3.0)
    theta: jnp.ndarray = None      # [Nt]
    thdd: jnp.ndarray = None       # [Nt]
    v1: jnp.ndarray = None         # [Nt, 3] inward normal, contact 1
    v2: jnp.ndarray = None         # [Nt, 3]
    B1: jnp.ndarray = None         # [Nt, 3, 3] torque skew, contact 1
    B2: jnp.ndarray = None         # [Nt, 3, 3]

    @property
    def g(self):
        return jnp.array([0.0, 0.0, -9.81], self.theta.dtype)


def _rot3(theta):
    """Rotation about the x axis (utils.jl rot3)."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    z, o = jnp.zeros_like(theta), jnp.ones_like(theta)
    return jnp.stack([
        jnp.stack([o, z, z], -1),
        jnp.stack([z, c, -s], -1),
        jnp.stack([z, s, c], -1),
    ], -2)


def _skew_batch(p):
    z = jnp.zeros_like(p[..., 0])
    return jnp.stack([
        jnp.stack([z, -p[..., 2], p[..., 1]], -1),
        jnp.stack([p[..., 2], z, -p[..., 0]], -1),
        jnp.stack([-p[..., 1], p[..., 0], z], -1),
    ], -2)


def make_grasp_object(N: int, tf: float, *, mu=0.5, mass=0.2, f_max=3.0,
                      theta0=0.0, thetaf=np.pi / 4, thetad0=0.0, thetadf=0.15,
                      dtype=jnp.float64) -> GraspObject:
    """Cubic orientation trajectory + rotating contact frames
    (set_orientation_traj!, grasp_model.jl:33-55; cubic coefficients from
    compute_rot_traj_coeffs, utils.jl:23-31)."""
    dt = tf / (N - 1)
    t0 = 0.0
    A = np.array([
        [t0**3, t0**2, t0, 1],
        [tf**3, tf**2, tf, 1],
        [3 * t0**2, 2 * t0, 1, 0],
        [3 * tf**2, 2 * tf, 1, 0],
    ])
    c = np.linalg.solve(A, np.array([theta0, thetaf, thetad0, thetadf]))
    ts = jnp.asarray(np.arange(N) * dt, dtype)
    theta = c[0] * ts**3 + c[1] * ts**2 + c[2] * ts + c[3]
    thdd = 6 * c[0] * ts + 2 * c[1]

    # contact geometry (grasp_model.jl:44-49 final values)
    p1_0 = jnp.asarray([0.0, -1.0, 0.0], dtype)
    v1_0 = jnp.asarray([0.0, 1.0, 0.0], dtype)
    p2_0 = jnp.asarray([0.0, 1.0, 0.0], dtype)
    v2_0 = jnp.asarray([0.0, -1.0, 0.0], dtype)
    R = _rot3(theta)                       # [Nt, 3, 3]
    p1 = jnp.einsum("kij,j->ki", R, p1_0)
    p2 = jnp.einsum("kij,j->ki", R, p2_0)
    v1 = jnp.einsum("kij,j->ki", R, v1_0)
    v2 = jnp.einsum("kij,j->ki", R, v2_0)
    return GraspObject(mu=mu, mass=mass, f_max=f_max, theta=theta, thdd=thdd,
                       v1=v1, v2=v2, B1=_skew_batch(p1), B2=_skew_batch(p2))


def grasp_dynamics(o: GraspObject, N: int, dt, dtype=jnp.float64):
    """Exact double-integrator discrete dynamics with both forces and gravity
    (grasp_model.jl:74-92)."""
    I3 = jnp.eye(3, dtype=dtype)
    Z3 = jnp.zeros((3, 3), dtype)
    Ad = jnp.block([[I3, I3 * dt], [Z3, I3]])
    Bhalf = jnp.concatenate([I3 * (0.5 * dt**2 / o.mass), I3 * (dt / o.mass)], 0)
    Bd = jnp.concatenate([Bhalf, Bhalf], axis=1)
    g = jnp.asarray([0.0, 0.0, -9.81], dtype)
    dd = jnp.concatenate([0.5 * g * dt**2, g * dt])
    return lti_dynamics(Ad, Bd, N, dd)


def grasp_constraints(o: GraspObject, N: int, k0=0,
                      include_goal: bool = False, xf=None,
                      dtype=jnp.float64) -> Tuple[ConicConstraint, ...]:
    """Constraint window [k0, k0+N) as four blocks (grasp_problem.jl:32-67).
    k0 may be traced -> the MPC refresh path (grasp_mpc_helpers.jl:46-55)."""
    n, m = 6, 6

    def win(stack, width):
        return jax.lax.dynamic_slice(stack, (k0,) + (0,) * (stack.ndim - 1),
                                     (N,) + stack.shape[1:])

    v1 = win(o.v1, 3)
    v2 = win(o.v2, 3)
    B1 = win(o.B1, 3)
    B2 = win(o.B2, 3)
    thdd = win(o.thdd, 0)

    # torque balance: [B1 B2] u = [thdd, 0, 0]
    Au_torque = jnp.concatenate([B1, B2], axis=2)              # [N, 3, 6]
    rhs = jnp.stack([thdd, jnp.zeros_like(thdd), jnp.zeros_like(thdd)], -1)
    torque = linear_constraint(N, n, m, jnp.zeros((N, 3, n), dtype),
                               Au_torque, rhs, Cone.ZERO, name="torque",
                               dtype=dtype)

    # max normal force: v1'F1 <= f_max, v2'F2 <= f_max
    z3 = jnp.zeros_like(v1)
    Au_force = jnp.stack([jnp.concatenate([v1, z3], -1),
                          jnp.concatenate([z3, v2], -1)], axis=1)  # [N, 2, 6]
    force = linear_constraint(N, n, m, jnp.zeros((N, 2, n), dtype), Au_force,
                              jnp.full((N, 2), o.f_max, dtype), Cone.NONPOS,
                              name="max_force", dtype=dtype)

    # SOC friction cones: ||(I - v v')F_i|| <= mu v'F_i on each force slice
    def cone_block(v, first):
        eye = jnp.eye(3, dtype=dtype)
        P = eye - jnp.einsum("ki,kj->kij", v, v)               # [N, 3, 3]
        zero = jnp.zeros_like(P)
        A_full = jnp.concatenate([P, zero] if first else [zero, P], axis=2)
        cvec = o.mu * v
        zv = jnp.zeros_like(cvec)
        c_full = jnp.concatenate([cvec, zv] if first else [zv, cvec], axis=1)
        return norm_constraint2(N, n, m, A_full, c_full, on="control",
                                dtype=dtype)

    cones_ = (cone_block(v1, True), cone_block(v2, False))

    blocks = (torque, force) + cones_
    if include_goal:
        blocks = (goal_constraint(N, n, m, xf, dtype=dtype),) + blocks
    return blocks


def grasp_problem(o: GraspObject, N: int = 61, tf: float = 6.0,
                  x0=(0.0, 3.0, 3.0, 0.0, 0.0, 0.0),
                  dtype=jnp.float64) -> Problem:
    """Cold-solve problem (grasp_problem.jl: Q=1e-3, R=1, Qf=10, goal at N)."""
    n, m = 6, 6
    dt = tf / (N - 1)
    x0 = jnp.asarray(x0, dtype)
    xf = jnp.zeros(n, dtype)
    dyn = grasp_dynamics(o, N, dt, dtype)
    cost = lqr_objective(1e-3 * jnp.eye(n, dtype=dtype),
                         1.0 * jnp.eye(m, dtype=dtype),
                         10.0 * jnp.eye(n, dtype=dtype), xf, N, dt=dt)
    cons = grasp_constraints(o, N, 0, include_goal=True, xf=xf, dtype=dtype)
    return Problem(dynamics=dyn, cost=cost, constraints=cons, x0=x0)


def hover_controls(o: GraspObject, N: int, dtype=jnp.float64):
    """U0 = [0, -1.5, mg/2, 0, 1.5, mg/2] (grasp_problem.jl:101-103)."""
    w = o.mass * 9.81 / 2
    u0 = jnp.asarray([0.0, -1.5, w, 0.0, 1.5, w], dtype)
    return jnp.tile(u0, (N - 1, 1))
