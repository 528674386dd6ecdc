"""OSQP-reference oracle (solver/osqp_ref.py) correctness.

The oracle reimplements the published OSQP algorithm (the reference's
timed QP solver, OSQPParams.jl:127-128) for the trot-QP floor study;
these tests pin it against the repo's two independent QP solvers.
"""
import numpy as np
import pytest

from altro_mpc.solver.osqp_ref import OSQPRef


def _box_qp(seed=0, n=24, m=40, n_eq=8):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    P = M @ M.T + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    l = -rng.random(m) - 0.1
    u = rng.random(m) + 0.1
    l[:n_eq] = u[:n_eq] = 0.1 * rng.standard_normal(n_eq)
    return P, q, A, l, u


def test_matches_native_admm_oracle():
    native = pytest.importorskip("altro_mpc.native")
    if not native.available():
        pytest.skip("native oracle unavailable")
    P, q, A, l, u = _box_qp()
    r = OSQPRef(P, q, A, l, u, eps_abs=1e-7, eps_rel=1e-7,
                max_iter=50000).solve()
    rn = native.solve_qp(P, q, A, l, u, eps_abs=1e-8, max_iter=200000)
    assert r.status == 1 and rn.status == 1
    assert np.max(np.abs(r.x - rn.x)) < 1e-4


def test_update_retains_warm_state():
    P, q, A, l, u = _box_qp(seed=3)
    o = OSQPRef(P, q, A, l, u, eps_abs=1e-6, eps_rel=1e-6, max_iter=50000)
    r1 = o.solve()
    assert r1.status == 1
    # tiny perturbation: the warm resume must converge far faster than a
    # cold solve of the same perturbed problem
    rng = np.random.default_rng(9)
    q2 = q + 1e-3 * rng.standard_normal(q.shape)
    o.update(q=q2)
    r2 = o.solve()
    cold = OSQPRef(P, q2, A, l, u, eps_abs=1e-6, eps_rel=1e-6,
                   max_iter=50000).solve()
    assert r2.status == 1 and cold.status == 1
    assert r2.iterations <= cold.iterations
    assert np.max(np.abs(r2.x - cold.x)) < 1e-3


def test_infeasible_bounds_loose_rows():
    # rows with l=-inf, u=+inf must be inert
    P, q, A, l, u = _box_qp(seed=5)
    l2, u2 = l.copy(), u.copy()
    l2[-5:] = -np.inf
    u2[-5:] = np.inf
    r = OSQPRef(P, q, A, l2, u2, eps_abs=1e-6, eps_rel=1e-6,
                max_iter=50000).solve()
    assert r.status == 1
