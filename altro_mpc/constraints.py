"""Affine conic constraint blocks.

Every constraint in the reference suite is affine in the knot variables
z_k = (x_k, u_k) combined with a cone membership, so the whole constraint
system reduces to one accelerator-friendly representation:

    c_k = Cx_k @ x_k + Cu_k @ u_k + b_k   in  K       (for knots with mask=1)

with K in {ZERO, NONPOS, SOC}. Stacks carry a leading knot axis; evaluation
over the horizon is one batched matmul. Time-varying constraints (the grasp
benchmark's AffineSOCTraj/LinearConstraintTraj, the quadruped contact
schedule) are just blocks whose stacks differ per knot and get refreshed as
pytree data each MPC step — no re-jit.

Reference parity map:
- BoundConstraint              -> :func:`bound_constraint`
- GoalConstraint               -> :func:`goal_constraint`
- NormConstraint (SOC)         -> :func:`norm_constraint`
- NormConstraint2 ||Az||<=c'z  -> :func:`norm_constraint2`
  (benchmarks/grasp_optimization/src/new_constraints.jl:72-120)
- AffineSOCTraj (time-varying) -> :func:`norm_constraint2` with per-knot stacks
  (new_constraints.jl:4-66)
- LinearConstraint(Traj/2)     -> :func:`linear_constraint`
  (new_constraints.jl:125-223)
- FrictionConstraint (SOC)     -> :func:`friction_cone`
  (quadruped Structs/FrictionConstraint.jl:10-38)
- LinearizedFrictionConstraint -> :func:`linearized_friction`
  (quadruped Structs/LinearizedFrictionConstraint.jl:1-26)
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
from .utils import struct

from .cones import (Cone, project, project_polar, project_polar_jacobian,
                    soc_polar_curvature_factors, violation)


@struct.dataclass
class ConicConstraint:
    """One block of p-row affine conic constraints applied along the horizon."""

    Cx: jnp.ndarray   # [N, p, n]
    Cu: jnp.ndarray   # [N, p, m]
    b: jnp.ndarray    # [N, p]
    mask: jnp.ndarray  # [N] float {0,1}: knots where the block is active
    cone: Cone = struct.field(pytree_node=False)
    name: str = struct.field(pytree_node=False, default="")

    @property
    def N(self) -> int:
        return self.Cx.shape[0]

    @property
    def p(self) -> int:
        return self.Cx.shape[1]

    def evaluate(self, X, U):
        """Residual stack c: [N, p]. U is [N-1, m]; u at the terminal knot is
        treated as zero (control rows must be masked out there, as the
        reference does by adding control constraints on 1:N-1 only)."""
        Upad = jnp.concatenate([U, jnp.zeros_like(U[:1])], axis=0)
        return (jnp.einsum("kpn,kn->kp", self.Cx, X)
                + jnp.einsum("kpm,km->kp", self.Cu, Upad) + self.b)

    def jacobians(self, X, U):
        """(Cx [N,p,n], Cu [N,p,m]) at the linearization point — constant
        for affine blocks. Part of the constraint-block protocol shared with
        nonlinear blocks like :class:`QuadNormConstraint`."""
        del X, U
        return self.Cx, self.Cu

    @property
    def is_affine(self) -> bool:
        return True

    def violations(self, X, U):
        """[N, p] infeasibility (c - proj_K(c)), zeroed at inactive knots."""
        c = self.evaluate(X, U)
        return violation(self.cone, c) * self.mask[:, None]

    def max_violation(self, X, U):
        return jnp.max(jnp.abs(self.violations(X, U)))


@struct.dataclass
class QuadNormConstraint:
    """Nonlinear (quadratic) norm constraint: ||A z||^2 <= (c'z + offset)^2,
    one NONPOS row per knot.

    The nonconvex "naive" counterpart of the SOC norm constraints, used for
    the reference's SOC-vs-Inequality rocket comparison (``contype`` switch,
    rocket_landing_problem.jl:61,123; run_simple_rocket.jl:72-102). The AL
    machinery consumes it through the same block protocol as
    :class:`ConicConstraint` (evaluate/jacobians re-evaluated at the current
    iterate), so the solver needs no special casing.
    """

    A: jnp.ndarray       # [N, p_rows, dim]
    c: jnp.ndarray       # [N, dim]
    offset: jnp.ndarray  # [N]
    mask: jnp.ndarray    # [N]
    on: str = struct.field(pytree_node=False, default="control")
    name: str = struct.field(pytree_node=False, default="quad_norm")

    cone: Cone = struct.field(pytree_node=False, default=Cone.NONPOS)

    @property
    def N(self) -> int:
        return self.A.shape[0]

    @property
    def p(self) -> int:
        return 1

    @property
    def is_affine(self) -> bool:
        return False

    def _z(self, X, U):
        Upad = jnp.concatenate([U, jnp.zeros_like(U[:1])], axis=0)
        return Upad if self.on == "control" else X

    def evaluate(self, X, U):
        z = self._z(X, U)
        Az = jnp.einsum("kpd,kd->kp", self.A, z)
        lin = jnp.einsum("kd,kd->k", self.c, z) + self.offset
        return (jnp.sum(Az * Az, axis=-1) - lin * lin)[:, None]

    def jacobians(self, X, U):
        z = self._z(X, U)
        Az = jnp.einsum("kpd,kd->kp", self.A, z)
        lin = jnp.einsum("kd,kd->k", self.c, z) + self.offset
        g = 2.0 * jnp.einsum("kp,kpd->kd", Az, self.A) \
            - 2.0 * lin[:, None] * self.c                     # [N, dim]
        N = self.N
        dim = self.A.shape[-1]
        zero_x = jnp.zeros((N, 1, X.shape[-1]), X.dtype)
        zero_u = jnp.zeros((N, 1, U.shape[-1]), U.dtype)
        if self.on == "control":
            return zero_x, g[:, None, :]
        return g[:, None, :], zero_u

    def violations(self, X, U):
        from .cones import violation as _viol
        return _viol(self.cone, self.evaluate(X, U)) * self.mask[:, None]

    def max_violation(self, X, U):
        return jnp.max(jnp.abs(self.violations(X, U)))

    def second_order(self, X, U, g):
        """Multiplier-weighted constraint Hessian g_k * d2c_k (exact; the
        Hessian is the constant 2 A'A - 2 c c', possibly indefinite — that is
        the nonconvexity the 'naive' comparison exists to exhibit).

        Returns (Hxx [N,n,n], Huu [N,m,m], Hux [N,m,n])."""
        H = 2.0 * jnp.einsum("kpi,kpj->kij", self.A, self.A) \
            - 2.0 * jnp.einsum("ki,kj->kij", self.c, self.c)
        Hw = g[:, 0, None, None] * H
        N = self.N
        n = X.shape[-1]
        m = U.shape[-1]
        zxx = jnp.zeros((N, n, n), X.dtype)
        zuu = jnp.zeros((N, m, m), X.dtype)
        zux = jnp.zeros((N, m, n), X.dtype)
        if self.on == "control":
            return zxx, Hw, zux
        return Hw, zuu, zux


def quad_norm_constraint(N: int, n: int, m: int, A, c=None, offset=0.0,
                         on: str = "control", start: int = 0,
                         stop: Optional[int] = None,
                         dtype=jnp.float64) -> QuadNormConstraint:
    """Builder for :class:`QuadNormConstraint`; A/c broadcast over knots."""
    A = jnp.asarray(A, dtype)
    if A.ndim == 2:
        A = jnp.broadcast_to(A, (N,) + A.shape)
    dim = A.shape[-1]
    c = jnp.zeros(dim, dtype) if c is None else jnp.asarray(c, dtype)
    if c.ndim == 1:
        c = jnp.broadcast_to(c, (N, dim))
    stop = N - 1 if stop is None else stop
    return QuadNormConstraint(
        A=A, c=c, offset=jnp.full((N,), offset, dtype),
        mask=_range_mask(N, start, stop, dtype), on=on)


# ----------------------------------------------------------------------------
# Dual / penalty state for the augmented Lagrangian
# ----------------------------------------------------------------------------

@struct.dataclass
class DualState:
    """AL multipliers and penalties for one constraint block."""

    lam: jnp.ndarray  # [N, p]
    rho: jnp.ndarray  # [N]  scalar penalty per knot

    @staticmethod
    def init(con: ConicConstraint, penalty_initial, dtype=jnp.float32) -> "DualState":
        return DualState(
            lam=jnp.zeros((con.N, con.p), dtype),
            rho=jnp.full((con.N,), penalty_initial, dtype),
        )

    def shift(self) -> "DualState":
        """Warm-start shift one knot forward, filling the tail with the last
        entry (parity with ``Altro.shift_fill!`` on the constraint set,
        random_linear_problem.jl:139)."""
        lam = jnp.concatenate([self.lam[1:], self.lam[-1:]], axis=0)
        return self.replace(lam=lam)



def al_terms(con: ConicConstraint, dual: DualState, X, U):
    """Per-block AL penalty value, gradient and Gauss-Newton curvature.

    With ctilde = proj_polar(lam + rho * c):
      value    = sum_k mask_k * (||ctilde_k||^2 - ||lam_k||^2) / (2 rho_k)
      grad_c   = ctilde                          [N, p]
      curv_c   = rho * Jac(proj_polar)(lam+rho c) [N, p, p]  (symmetric PSD)

    Derivation: AL of c in K via slack elimination gives
    (1/2rho)(||proj_polar(lam + rho c)||^2 - ||lam||^2); see cones.py.
    """
    c = con.evaluate(X, U)
    z = dual.lam + dual.rho[:, None] * c
    ct = project_polar(con.cone, z)
    value = jnp.sum(
        con.mask * (jnp.sum(ct * ct, axis=-1) - jnp.sum(dual.lam**2, axis=-1))
        / (2.0 * dual.rho)
    )
    grad_c = ct * con.mask[:, None]
    J = project_polar_jacobian(con.cone, z)
    curv_c = (dual.rho[:, None, None] * J) * con.mask[:, None, None]
    return value, grad_c, curv_c


def al_terms_structured(con, dual: DualState, X, U):
    """Like :func:`al_terms` but returns the curvature in the cheapest
    structured form per cone:

      ZERO:   ('diag', w [N,p])  with w = rho * mask        (J = I)
      NONPOS: ('diag', w [N,p])  with w = rho * active * mask
      SOC, p >= 12:  ('diag_lr', (w [N,p], ((c1 [N], u1 [N,p]),
                                            (c2 [N], u2 [N,p]))))
              with rho * J_polar = diag(w) + c1 u1 u1' + c2 u2 u2'
              (exact; cones.soc_polar_curvature_factors)
      SOC, p < 12:   ('dense', H [N,p,p])

    The structured forms let the solver's expansion contract C' J C as a
    weighted C'C plus (for SOC) two rank-1 outer products instead of
    materializing [N, p, p] Jacobians. The p threshold is empirical: at
    the benchmark cone widths (p=4..7) the dense [N, p, p] einsum is tiny
    and the factored form's extra dispatched ops cost more than they save;
    the factored path wins only when materializing p x p blocks is
    actually large (measured on an earlier accelerator; not re-measured on
    the GPU).
    """
    c = con.evaluate(X, U)
    z = dual.lam + dual.rho[:, None] * c
    ct = project_polar(con.cone, z)
    g = ct * con.mask[:, None]
    if con.cone == Cone.ZERO:
        w = jnp.broadcast_to((dual.rho * con.mask)[:, None], z.shape)
        return g, ("diag", w)
    if con.cone == Cone.NONPOS:
        active = (z > 0.0).astype(z.dtype)
        w = (dual.rho[:, None] * active) * con.mask[:, None]
        return g, ("diag", w)
    if z.shape[-1] < 12:
        J = project_polar_jacobian(con.cone, z)
        H = (dual.rho[:, None, None] * J) * con.mask[:, None, None]
        return g, ("dense", H)
    w, c1, u1, c2, u2 = soc_polar_curvature_factors(z)
    rm = dual.rho * con.mask
    return g, ("diag_lr", (w * rm[:, None],
                           ((c1 * rm, u1), (c2 * rm, u2))))


def al_cost(con: ConicConstraint, dual: DualState, X, U):
    """Penalty value only (cheap path for line search)."""
    c = con.evaluate(X, U)
    z = dual.lam + dual.rho[:, None] * c
    ct = project_polar(con.cone, z)
    return jnp.sum(
        con.mask * (jnp.sum(ct * ct, axis=-1) - jnp.sum(dual.lam**2, axis=-1))
        / (2.0 * dual.rho)
    )


def dual_update(con: ConicConstraint, dual: DualState, X, U,
                penalty_scaling, penalty_max) -> DualState:
    """AL outer-loop update: lam <- proj_polar(lam + rho c), rho <- rho * phi."""
    c = con.evaluate(X, U)
    z = dual.lam + dual.rho[:, None] * c
    lam = project_polar(con.cone, z) * con.mask[:, None]
    rho = jnp.minimum(dual.rho * penalty_scaling, penalty_max)
    return DualState(lam=lam, rho=rho)


# ----------------------------------------------------------------------------
# Constructors (parity with the reference constraint inventory)
# ----------------------------------------------------------------------------

def _range_mask(N: int, start: int, stop: int, dtype=jnp.float32):
    k = jnp.arange(N)
    return ((k >= start) & (k < stop)).astype(dtype)


def bound_constraint(N: int, n: int, m: int,
                     x_min=None, x_max=None, u_min=None, u_max=None,
                     start: int = 0, stop: Optional[int] = None,
                     dtype=jnp.float32) -> ConicConstraint:
    """Box bounds as NONPOS rows (TO ``BoundConstraint``; only finite bounds
    produce rows, matching the ``isfinite`` filter in
    random_linear_problem.jl:61). Scalar bounds broadcast."""
    stop = N - 1 if stop is None else stop
    rows_Cx, rows_Cu, rows_b = [], [], []

    def add(vec, sign, is_state):
        if vec is None:
            return
        import numpy as _np

        # finiteness is structural (decides which rows exist) and must be
        # resolved host-side so problem construction works under jit
        v_host = _np.broadcast_to(_np.asarray(vec, float),
                                  (n if is_state else m,))
        v = jnp.broadcast_to(jnp.asarray(vec, dtype), (n if is_state else m,))
        idxs = [i for i in range(v_host.shape[0]) if _np.isfinite(v_host[i])]
        for i in idxs:
            cx = jnp.zeros(n, dtype)
            cu = jnp.zeros(m, dtype)
            if is_state:
                cx = cx.at[i].set(sign)
            else:
                cu = cu.at[i].set(sign)
            rows_Cx.append(cx)
            rows_Cu.append(cu)
            rows_b.append(-sign * v[i])

    add(x_max, 1.0, True)    # x - x_max <= 0
    add(x_min, -1.0, True)   # x_min - x <= 0
    add(u_max, 1.0, False)
    add(u_min, -1.0, False)

    Cx = jnp.stack(rows_Cx)
    Cu = jnp.stack(rows_Cu)
    b = jnp.stack(rows_b)
    p = Cx.shape[0]
    return ConicConstraint(
        Cx=jnp.broadcast_to(Cx, (N, p, n)),
        Cu=jnp.broadcast_to(Cu, (N, p, m)),
        b=jnp.broadcast_to(b, (N, p)),
        mask=_range_mask(N, start, stop, dtype),
        cone=Cone.NONPOS,
        name="bound",
    )


def goal_constraint(N: int, n: int, m: int, xf, dtype=jnp.float32) -> ConicConstraint:
    """x_N = xf (TO ``GoalConstraint``, rocket_landing_problem.jl:96)."""
    xf = jnp.asarray(xf, dtype)
    Cx = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (N, n, n))
    Cu = jnp.zeros((N, n, m), dtype)
    b = jnp.broadcast_to(-xf, (N, n))
    mask = _range_mask(N, N - 1, N, dtype)
    return ConicConstraint(Cx=Cx, Cu=Cu, b=b, mask=mask, cone=Cone.ZERO, name="goal")


def norm_constraint(N: int, n: int, m: int, bound, on: str = "control",
                    start: int = 0, stop: Optional[int] = None,
                    dtype=jnp.float32) -> ConicConstraint:
    """||z|| <= bound as the SOC row (z, bound) (TO ``NormConstraint`` with
    SecondOrderCone sense — rocket max thrust, rocket_landing_problem.jl:123)."""
    dim = m if on == "control" else n
    A = jnp.eye(dim, dtype=dtype)
    c = jnp.zeros(dim, dtype)
    return norm_constraint2(N, n, m, A, c, on=on, offset=bound,
                            start=start, stop=stop, dtype=dtype)


def norm_constraint2(N: int, n: int, m: int, A, c, on: str = "control",
                     offset=0.0, start: int = 0, stop: Optional[int] = None,
                     mask=None, dtype=jnp.float32) -> ConicConstraint:
    """||A z|| <= c'z + offset, z = x or u, as an SOC block.

    Parity with ``NormConstraint2`` (new_constraints.jl:72-120). Pass per-knot
    stacks A: [N, p, dim], c: [N, dim] for the time-varying ``AffineSOCTraj``
    form (new_constraints.jl:4-66).
    """
    A = jnp.asarray(A, dtype)
    c = jnp.asarray(c, dtype)
    if A.ndim == 2:
        A = jnp.broadcast_to(A, (N,) + A.shape)
    if c.ndim == 1:
        c = jnp.broadcast_to(c, (N,) + c.shape)
    p_rows = A.shape[1]
    dim = A.shape[2]

    # Stack [A; c'] acting on the chosen variable, plus the cone offset.
    M = jnp.concatenate([A, c[:, None, :]], axis=1)       # [N, p+1, dim]
    if on == "control":
        assert dim == m
        Cx = jnp.zeros((N, p_rows + 1, n), dtype)
        Cu = M
    elif on == "state":
        assert dim == n
        Cx = M
        Cu = jnp.zeros((N, p_rows + 1, m), dtype)
    else:
        raise ValueError(on)
    b = jnp.zeros((N, p_rows + 1), dtype).at[:, -1].add(jnp.asarray(offset, dtype))
    if mask is None:
        stop = N - 1 if stop is None else stop
        mask = _range_mask(N, start, stop, dtype)
    return ConicConstraint(Cx=Cx, Cu=Cu, b=b, mask=mask, cone=Cone.SOC,
                           name="norm_soc")


def linear_constraint(N: int, n: int, m: int, Ax, Au, rhs, cone: Cone,
                      start: int = 0, stop: Optional[int] = None, mask=None,
                      name: str = "linear", dtype=jnp.float32) -> ConicConstraint:
    """General affine rows ``Ax x + Au u - rhs in K`` (K = ZERO or NONPOS).

    Parity with LinearConstraint2 / LinearConstraintTraj
    (new_constraints.jl:125-223): pass [N, ...] stacks for time-varying data.
    """
    Ax = jnp.asarray(Ax, dtype)
    Au = jnp.asarray(Au, dtype)
    rhs = jnp.asarray(rhs, dtype)
    if Ax.ndim == 2:
        Ax = jnp.broadcast_to(Ax, (N,) + Ax.shape)
    if Au.ndim == 2:
        Au = jnp.broadcast_to(Au, (N,) + Au.shape)
    if rhs.ndim == 1:
        rhs = jnp.broadcast_to(rhs, (N,) + rhs.shape)
    if mask is None:
        stop = N - 1 if stop is None else stop
        mask = _range_mask(N, start, stop, dtype)
    return ConicConstraint(Cx=Ax, Cu=Au, b=-rhs, mask=mask, cone=cone, name=name)


def friction_cone(N: int, n: int, m: int, mu, foot_inds: Sequence[int],
                  mask=None, dtype=jnp.float32) -> ConicConstraint:
    """||(f_x, f_y)|| <= mu f_z for one contact force in u.

    Parity with the quadruped ``FrictionConstraint``
    (Structs/FrictionConstraint.jl:10-38): A = diag(1,1,0), c = mu e3 on the
    force slice. ``foot_inds`` are the 3 control indices of the force.
    """
    ix, iy, iz = foot_inds
    A = jnp.zeros((2, m), dtype).at[0, ix].set(1.0).at[1, iy].set(1.0)
    c = jnp.zeros(m, dtype).at[iz].set(jnp.asarray(mu, dtype))
    return norm_constraint2(N, n, m, A, c, on="control", mask=mask, dtype=dtype)


def linearized_friction(N: int, n: int, m: int, mu, foot_inds: Sequence[int],
                        mask=None, dtype=jnp.float32) -> ConicConstraint:
    """Pyramid approximation: |f_x| <= mu f_z, |f_y| <= mu f_z (4 NONPOS rows;
    quadruped Structs/LinearizedFrictionConstraint.jl:1-26)."""
    ix, iy, iz = foot_inds
    mu = jnp.asarray(mu, dtype)
    rows = []
    for i, s in ((ix, 1.0), (ix, -1.0), (iy, 1.0), (iy, -1.0)):
        row = jnp.zeros(m, dtype).at[i].set(s).at[iz].add(-mu)
        rows.append(row)
    Au = jnp.stack(rows)
    if mask is None:
        mask = _range_mask(N, 0, N - 1, dtype)
    return ConicConstraint(
        Cx=jnp.zeros((N, 4, n), dtype),
        Cu=jnp.broadcast_to(Au, (N, 4, m)),
        b=jnp.zeros((N, 4), dtype),
        mask=mask,
        cone=Cone.NONPOS,
        name="linearized_friction",
    )
