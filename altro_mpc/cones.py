"""Convex cone projections and their Jacobians.

Accelerator-native core of the conic augmented-Lagrangian machinery. Every function is
branchless (``jnp.where`` / ``lax.select``), fully batched over leading axes,
and safe under ``jit``/``vmap``/``grad``.

Cone conventions (constraint residual ``c`` of length ``p``):

- ``ZERO``   : c == 0                       (Equality sense in the reference,
               TrajectoryOptimization ``Equality``)
- ``NONPOS`` : c <= 0 elementwise           (reference ``Inequality``)
- ``SOC``    : ||c[:-1]|| <= c[-1]          (reference ``SecondOrderCone``;
               cf. NormConstraint2 "norm(Ay) <= c'y" in
               benchmarks/grasp_optimization/src/new_constraints.jl:68-120)

The augmented-Lagrangian penalty uses the *polar* cone projection. By the
Moreau decomposition ``z = proj_K(z) + proj_polar(K)(z)`` with the two parts
orthogonal, so ``proj_polar(z) = z - proj_K(z)`` for every cone here.

References: ALTRO-C (ICRA'21) conic AL; reference repo consumes it via
Altro.jl's `socp` branch (see SURVEY.md section 3.5).
"""
from __future__ import annotations

import enum

import jax.numpy as jnp


class Cone(str, enum.Enum):
    """Static cone tag attached to each constraint block."""

    ZERO = "zero"        # equality: c == 0
    NONPOS = "nonpos"    # inequality: c <= 0
    SOC = "soc"          # second-order cone: ||c[:-1]|| <= c[-1]

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


def _soc_parts(z):
    """Split z into (v, s, ||v||, safe ||v|| for division).

    The norm is exact; divisions use a guarded denominator. The boundary
    branch (the only one that divides) is selected only when a > |s| >= 0, so
    the guard value never leaks into a selected output.
    """
    v = z[..., :-1]
    s = z[..., -1]
    a = jnp.sqrt(jnp.sum(v * v, axis=-1))
    a_safe = jnp.where(a > 0, a, 1.0)
    return v, s, a, a_safe


def project_soc(z):
    """Euclidean projection onto the second-order cone.

    z = (v, s); a = ||v||:
      a <= s        -> z                       (inside)
      a <= -s       -> 0                       (inside the polar)
      otherwise     -> ((a + s) / (2a)) (v, a) (boundary ray)
    """
    v, s, a, a_safe = _soc_parts(z)
    scale = (a + s) / (2.0 * a_safe)
    proj_v = scale[..., None] * v
    proj_s = scale * a
    boundary = jnp.concatenate([proj_v, proj_s[..., None]], axis=-1)

    inside = (a <= s)[..., None]
    in_polar = (a <= -s)[..., None]
    return jnp.where(inside, z, jnp.where(in_polar, jnp.zeros_like(z), boundary))


def project_soc_jacobian(z):
    """Jacobian of ``project_soc`` at z, shape [..., p, p]. Branchless.

    Boundary-case closed form with w = v/a (unit), a = ||v||:
      d proj_v / dv = ((a+s)/(2a)) I - (s/(2a)) w w^T
      d proj_v / ds = w / 2
      d proj_s / dv = w^T / 2
      d proj_s / ds = 1/2

    Every factor is a RATIO of same-scale quantities (the boundary branch
    is selected only when a > |s|, so (a+s)/(2a) in (0,1) and s/(2a) in
    (-1/2,1/2)). The earlier unnormalized form divided by a^3, which
    UNDERFLOWS to 0 for denormal-scale near-apex residuals (a ~ 1e-116 in
    f64 -> a^3 = 0 -> inf) — hit by quadruped swing-foot friction cones
    whose carried controls decay to denormals over a closed loop, and the
    inf then poisoned the whole AL expansion (solver NaN at iteration 1).
    """
    v, s, a, a_safe = _soc_parts(z)
    p = z.shape[-1]
    d = p - 1
    eye_d = jnp.eye(d, dtype=z.dtype)

    w = v / a_safe[..., None]
    wwT = w[..., :, None] * w[..., None, :]
    coef = (a + s) / (2.0 * a_safe)
    Jvv = (coef[..., None, None] * eye_d
           - (s / (2.0 * a_safe))[..., None, None] * wwT)
    Jvs = w / 2.0  # [..., d]

    top = jnp.concatenate([Jvv, Jvs[..., :, None]], axis=-1)           # [..., d, p]
    bot = jnp.concatenate([Jvs, jnp.full_like(s[..., None], 0.5)], axis=-1)
    J_boundary = jnp.concatenate([top, bot[..., None, :]], axis=-2)    # [..., p, p]

    eye_p = jnp.broadcast_to(jnp.eye(p, dtype=z.dtype), J_boundary.shape)
    inside = (a <= s)[..., None, None]
    in_polar = (a <= -s)[..., None, None]
    return jnp.where(inside, eye_p, jnp.where(in_polar, jnp.zeros_like(J_boundary), J_boundary))


def project(cone: Cone, z):
    """Projection onto cone K."""
    if cone == Cone.ZERO:
        return jnp.zeros_like(z)
    if cone == Cone.NONPOS:
        return jnp.minimum(z, 0.0)
    if cone == Cone.SOC:
        return project_soc(z)
    raise ValueError(f"unknown cone {cone!r}")


def project_polar(cone: Cone, z):
    """Projection onto the polar cone K^o = {y : <y, x> <= 0 for all x in K}.

    Used for the AL dual update ``lambda <- proj_polar(lambda + rho * c)``.
    """
    if cone == Cone.ZERO:
        return z                      # polar of {0} is R^p
    if cone == Cone.NONPOS:
        return jnp.maximum(z, 0.0)    # polar of R^p_- is R^p_+
    if cone == Cone.SOC:
        return z - project_soc(z)     # Moreau
    raise ValueError(f"unknown cone {cone!r}")


def project_polar_jacobian(cone: Cone, z):
    """Jacobian of ``project_polar`` at z, shape [..., p, p] (symmetric PSD).

    This is the Gauss-Newton curvature of the conic AL penalty.
    """
    p = z.shape[-1]
    eye = jnp.eye(p, dtype=z.dtype)
    if cone == Cone.ZERO:
        return jnp.broadcast_to(eye, z.shape + (p,))
    if cone == Cone.NONPOS:
        active = (z > 0.0).astype(z.dtype)
        return active[..., :, None] * eye
    if cone == Cone.SOC:
        return jnp.broadcast_to(eye, z.shape[:-1] + (p, p)) - project_soc_jacobian(z)
    raise ValueError(f"unknown cone {cone!r}")


def soc_polar_curvature_factors(z):
    """Exact diag + rank-2 factorization of the SOC polar-projection
    Jacobian: J_polar(z) = diag(w) + c1 * u1 u1' + c2 * u2 u2'.

    With z = (v, s), a = ||v||, v_hat = v / a, gamma = (a - s) / (2a):

      inside  (a <= s):  J = 0          -> w = 0,            c1 = c2 = 0
      polar   (a <= -s): J = I          -> w = 1,            c1 = c2 = 0
      boundary:          w = (gamma,...,gamma,0),
                         c1 = -gamma, u1 = (v_hat, 0),
                         c2 = 1/2,    u2 = (-v_hat, 1)

    (Derivation: J_polar = I - J_soc with the closed-form boundary blocks of
    :func:`project_soc_jacobian`; the vv block (a-s)/(2a) I + s/(2a) vh vh'
    splits as gamma I + (1/2 - gamma) vh vh'.) This lets the AL expansion
    contract C' J C as a weighted C'C plus two rank-1 outer products instead
    of materializing [N, p, p] Jacobians — the dominant cost of the
    XLA-side SOC expansion at batch width. Shapes: z [..., p] ->
    w [..., p], c1/c2 [...], u1/u2 [..., p].
    """
    v, s, a, a_safe = _soc_parts(z)
    p = z.shape[-1]
    dtype = z.dtype
    vh = v / a_safe[..., None]
    gamma = (a - s) / (2.0 * a_safe)

    inside = a <= s
    in_polar = a <= -s
    boundary = ~(inside | in_polar)
    bnd = boundary.astype(dtype)

    last = jnp.zeros((p,), dtype).at[-1].set(1.0)
    head = 1.0 - last
    w = (bnd * gamma)[..., None] * head \
        + in_polar.astype(dtype)[..., None] * jnp.ones((p,), dtype)
    c1 = -(bnd * gamma)
    c2 = 0.5 * bnd
    zeros_s = jnp.zeros_like(s)
    ones_s = jnp.ones_like(s)
    u1 = jnp.concatenate([vh, zeros_s[..., None]], axis=-1)
    u2 = jnp.concatenate([-vh, ones_s[..., None]], axis=-1)
    return w, c1, u1, c2, u2


def violation(cone: Cone, c):
    """Elementwise infeasibility vector: c - proj_K(c).

    Its inf-norm is the constraint violation used for AL termination
    (reference: `max_violation < constraint_tolerance`, SURVEY.md section 3.5).
    """
    return c - project(cone, c)


def in_cone(cone: Cone, c, tol: float = 0.0):
    """Boolean [...,] — is c within `tol` (inf-norm) of K membership."""
    return jnp.max(jnp.abs(violation(cone, c)), axis=-1) <= tol
