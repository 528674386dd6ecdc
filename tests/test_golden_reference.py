"""Golden-fixture checks against the reference repo's shipped data.

The reference commits its paper-run results as JLD2 files (rocket.jld2 with
the tolerance-convergence study; SURVEY.md section 4.6). These tests read
them (read-only) and assert our solver reproduces the study's *shape*: the
ALTRO-vs-baseline trajectory error is O(0.1-1) at loose tolerance and decays
monotonically by orders of magnitude as the tolerance tightens, while the
interior-point baselines' error stays orders of magnitude higher at loose
tolerances — the qualitative claim of figures/rocket_solver_tol.tikz.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

import altro_mpc as at

REF = "/root/reference/rocket.jld2"

pytestmark = pytest.mark.skipif(not os.path.exists(REF),
                                reason="reference fixtures not mounted")


def _reference_tol_table():
    import h5py
    with h5py.File(REF, "r") as f:
        tols = np.asarray(f["tols"][:])
        flat = np.asarray([v for v in f["tol_comp"][()][0]])
    table = flat.reshape(len(tols), -1)  # rows per tol: solver error columns
    return tols, table


def test_reference_fixture_readable():
    tols, table = _reference_tol_table()
    np.testing.assert_allclose(tols, [1e-2, 1e-4, 1e-6, 1e-8, 1e-10])
    # the loose-tolerance row shows the reference's recorded ALTRO error
    # O(0.5) while ECOS/COSMO sit at O(70) — the study's headline contrast
    assert 0.1 < table[0, 0] < 1.0
    assert table[0, 1] > 10.0 and table[0, 2] > 10.0


def test_our_tolerance_convergence_matches_reference_shape():
    """Our ALTRO error-vs-tolerance curve shows the same decay the reference
    recorded for its ALTRO (0.53 at 1e-2 down to <1e-3 by 1e-6)."""
    from altro_mpc.models import rocket
    from altro_mpc.mpc import gen_tracking_mpc, run_mpc_lockstep_conic

    N = 301
    prob = rocket.rocket_problem(N=N, tf=(N - 1) * 0.05)
    cold = at.solve(prob, at.SolverOptions(
        cost_tolerance=1e-6, gradient_tolerance=1e-8,
        constraint_tolerance=1e-5, penalty_initial=1e-2, penalty_scaling=500.0,
        iterations_outer=40, iterations_inner=100),
        U0=rocket.hover_controls(prob))
    prob_mpc = gen_tracking_mpc(prob, cold.X, cold.U, 21, dt=0.05)
    noise = jnp.asarray(np.random.default_rng(1).standard_normal((5, 6)))

    errs = {}
    for tol in (1e-2, 1e-4, 1e-6):
        opts = at.SolverOptions(
            cost_tolerance=tol, gradient_tolerance=tol * 1e-2,
            constraint_tolerance=tol, penalty_initial=1e3,
            penalty_scaling=10.0, reset_duals=False, iterations_outer=40)
        res = run_mpc_lockstep_conic(
            prob_mpc, opts, cold.X, cold.U, noise, conic_eps=1e-9,
            conic_max_iter=50000, noise_model=rocket.rocket_noise_model())
        errs[tol] = float(jnp.max(res.err_U))

    ref_tols, ref_table = _reference_tol_table()
    # same qualitative decay as the reference ALTRO column
    assert errs[1e-2] < 10.0            # loose: O(1) error like the fixture
    # near-monotone at the loose end (10% slack: both errors are O(0.3) maxima
    # over a handful of steps and jitter with solver-iterate details — the
    # reference's own ALTRO column is only qualitatively monotone there)
    assert errs[1e-4] <= errs[1e-2] * 1.1
    assert errs[1e-6] < 1e-2            # tight: orders of magnitude down
    # and our loose-tolerance error is no worse than the reference's ECOS
    # loose-tolerance error by a wide margin
    assert errs[1e-2] < ref_table[0, 1] / 5.0
