"""Cone projection unit tests: closed-form cases + autodiff cross-checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_mpc import cones
from altro_mpc.cones import Cone


def test_soc_projection_cases():
    # inside the cone -> identity
    z = jnp.array([1.0, 0.5, 3.0])
    np.testing.assert_allclose(cones.project_soc(z), z, atol=1e-12)

    # inside the polar (negative) cone -> zero
    z = jnp.array([1.0, 0.5, -3.0])
    np.testing.assert_allclose(cones.project_soc(z), jnp.zeros(3), atol=1e-12)

    # boundary case: projection lands on the cone boundary
    z = jnp.array([3.0, 4.0, 1.0])  # ||v|| = 5 > |s|
    p = cones.project_soc(z)
    v, s = p[:2], p[2]
    np.testing.assert_allclose(jnp.linalg.norm(v), s, rtol=1e-12)
    # projection is the closest point: check against cvx-style known formula
    scale = (5.0 + 1.0) / (2 * 5.0)
    np.testing.assert_allclose(p, jnp.array([3.0 * scale, 4.0 * scale, 5.0 * scale]),
                               rtol=1e-12)


def test_soc_projection_idempotent_and_batched():
    key = jax.random.PRNGKey(0)
    z = jax.random.normal(key, (64, 5))
    p = cones.project_soc(z)
    pp = cones.project_soc(p)
    np.testing.assert_allclose(p, pp, atol=1e-10)
    # membership
    v = p[:, :-1]
    assert bool(jnp.all(jnp.linalg.norm(v, axis=-1) <= p[:, -1] + 1e-9))


def test_soc_jacobian_matches_autodiff():
    key = jax.random.PRNGKey(1)
    zs = jax.random.normal(key, (32, 4)) * 2.0
    J_closed = cones.project_soc_jacobian(zs)
    J_ad = jax.vmap(jax.jacfwd(cones.project_soc))(zs)
    np.testing.assert_allclose(J_closed, J_ad, atol=1e-8)


@pytest.mark.parametrize("cone", [Cone.ZERO, Cone.NONPOS, Cone.SOC])
def test_moreau_decomposition(cone):
    key = jax.random.PRNGKey(2)
    z = jax.random.normal(key, (16, 6))
    pk = cones.project(cone, z)
    pp = cones.project_polar(cone, z)
    np.testing.assert_allclose(pk + pp, z, atol=1e-10)
    # orthogonality of the parts
    np.testing.assert_allclose(jnp.sum(pk * pp, axis=-1), jnp.zeros(16), atol=1e-9)


@pytest.mark.parametrize("cone", [Cone.NONPOS, Cone.SOC])
def test_polar_jacobian_matches_autodiff(cone):
    key = jax.random.PRNGKey(3)
    zs = jax.random.normal(key, (32, 4)) * 1.5
    J_closed = cones.project_polar_jacobian(cone, zs)
    J_ad = jax.vmap(jax.jacfwd(lambda z: cones.project_polar(cone, z)))(zs)
    np.testing.assert_allclose(J_closed, J_ad, atol=1e-8)


def test_violation_semantics():
    # feasible points have zero violation
    assert float(jnp.max(jnp.abs(cones.violation(Cone.NONPOS, jnp.array([-1.0, -2.0]))))) == 0.0
    assert float(jnp.max(jnp.abs(cones.violation(Cone.SOC, jnp.array([1.0, 0.0, 2.0]))))) == 0.0
    # infeasible equality: violation is the residual itself
    c = jnp.array([0.3, -0.2])
    np.testing.assert_allclose(cones.violation(Cone.ZERO, c), c, atol=1e-12)


def test_soc_curvature_factors_reconstruct_jacobian():
    # diag + rank-2 factorization must reproduce the closed-form polar
    # Jacobian in all three regions (inside / polar / boundary)
    key = jax.random.PRNGKey(3)
    zs = jax.random.normal(key, (256, 13))
    # force some rows into each region
    zs = zs.at[0, -1].set(100.0).at[1, -1].set(-100.0)
    w, c1, u1, c2, u2 = jax.vmap(cones.soc_polar_curvature_factors)(zs)
    J_fac = (jax.vmap(jnp.diag)(w)
             + c1[:, None, None] * u1[:, :, None] * u1[:, None, :]
             + c2[:, None, None] * u2[:, :, None] * u2[:, None, :])
    J_closed = cones.project_polar_jacobian(Cone.SOC, zs)
    np.testing.assert_allclose(J_fac, J_closed, atol=1e-10)


def test_al_terms_structured_factored_soc_matches_dense():
    # a wide SOC block (p >= 12) takes the 'diag_lr' path; its contracted
    # curvature must equal the dense al_terms curvature
    from altro_mpc import constraints as CN

    key = jax.random.PRNGKey(7)
    N, n, m, p = 5, 4, 3, 13
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    con = CN.ConicConstraint(
        Cx=jax.random.normal(k1, (N, p, n)),
        Cu=jax.random.normal(k2, (N, p, m)),
        b=jax.random.normal(k3, (N, p)),
        cone=Cone.SOC, mask=jnp.ones((N,)), name="wide_soc")
    dual = CN.DualState(lam=0.1 * jax.random.normal(k4, (N, p)),
                        rho=jnp.full((N,), 2.5))
    X = jax.random.normal(k5, (N, n))
    U = jax.random.normal(k1, (N - 1, m))
    g, (kind, H) = CN.al_terms_structured(con, dual, X, U)
    assert kind == "diag_lr"
    w, ((c1, u1), (c2, u2)) = H
    Cx = con.Cx
    J_fac = (jax.vmap(jax.vmap(jnp.diag))(w[None])[0]
             + c1[:, None, None] * u1[:, :, None] * u1[:, None, :]
             + c2[:, None, None] * u2[:, :, None] * u2[:, None, :])
    lxx_fac = jnp.einsum("kpi,kpq,kqj->kij", Cx, J_fac, Cx)
    _, _, Hd = CN.al_terms(con, dual, X, U)
    lxx_dense = jnp.einsum("kpi,kpq,kqj->kij", Cx, Hd, Cx)
    np.testing.assert_allclose(lxx_fac, lxx_dense, atol=1e-9)


def test_soc_jacobian_denormal_apex():
    """Near-apex residuals at DENORMAL scale must not overflow the
    boundary-branch Jacobian (the unnormalized form divided by a^3, which
    underflows to 0 for a ~ 1e-116 and returned inf — hit by quadruped
    swing-foot friction cones whose carried controls decay to denormals
    over a closed loop; solver NaN'd at iteration 1 in f64)."""
    for scale in (1e-116, 1e-300, 1e-40, 1e-20):
        z = jnp.asarray([0.0, -scale, 0.0], jnp.float64)
        J = cones.project_soc_jacobian(z)
        assert bool(jnp.all(jnp.isfinite(J))), scale
        zf = jnp.asarray([0.0, -1e-30, 0.0], jnp.float32)
        Jf = cones.project_soc_jacobian(zf)
        assert bool(jnp.all(jnp.isfinite(Jf)))
    # exact apex stays the inside-branch identity
    J0 = cones.project_soc_jacobian(jnp.zeros(3, jnp.float64))
    assert bool(jnp.all(jnp.isfinite(J0)))
    # boundary-branch values are unchanged at normal scales
    z = jnp.asarray([0.3, -0.4, 0.2], jnp.float64)
    J = cones.project_soc_jacobian(z)
    eps = 1e-7
    for i in range(3):
        fd = (cones.project_soc(z.at[i].add(eps))
              - cones.project_soc(z.at[i].add(-eps))) / (2 * eps)
        np.testing.assert_allclose(J[:, i], fd, atol=1e-6)
