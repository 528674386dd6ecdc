"""End-to-end random-linear MPC benchmark slice (the reference's benchmark 1).

Reproduces the structure of run_MPC (random_linear_problem.jl:85-189):
warm-started receding-horizon tracking with 1% noise, ALTRO vs the
in-framework ADMM QP in lockstep, inf-norm agreement at tolerance level.
"""
import jax
import jax.numpy as jnp
import numpy as np

import altro_mpc as at
from altro_mpc.models import random_linear as rl
from altro_mpc.mpc import run_mpc, run_mpc_lockstep

OPTS = at.SolverOptions(
    cost_tolerance=1e-4,
    constraint_tolerance=1e-4,
    penalty_initial=1e3,
    penalty_scaling=100.0,
    reset_duals=False,
)


def _make_setup(seed=1, n=12, m=6, N_track=121, N_mpc=21):
    rng = np.random.default_rng(seed)
    prob = rl.gen_random_linear(rng, n, m, N_track)
    X_track, U_track = rl.gen_trajectory(rng, prob, N_track)
    prob_mpc = rl.gen_tracking_mpc(prob, X_track, U_track, N_mpc)
    return prob, prob_mpc, X_track, U_track


def test_mpc_tracks_reference():
    prob, prob_mpc, X_track, U_track = _make_setup()
    T = 30
    rng = np.random.default_rng(2)
    noise = jnp.asarray(rng.standard_normal((T, prob.n)))
    results = jax.jit(run_mpc, static_argnames=())(
        prob_mpc, OPTS, X_track, U_track, noise)
    # Every step solved successfully within constraint tolerance
    assert int(jnp.sum(results.status)) == T
    assert float(jnp.max(results.viol)) < 1e-4
    # Controls respect the +-3 bound
    assert float(jnp.max(jnp.abs(results.U))) <= 3.0 + 1e-4
    # The closed loop actually tracks: state stays near the reference window
    errs = jnp.array([
        jnp.max(jnp.abs(results.x0[t] - X_track[t + 1]))
        for t in range(T)])
    assert float(jnp.median(errs)) < 2.0  # bounded tracking error


def test_lockstep_altro_vs_admm_qp():
    """The reference's core equivalence oracle: ALTRO and the QP baseline
    agree to ~tolerance on every MPC step (err_traj at 1e-4-ish level,
    random_linear_problem.jl:176-186)."""
    prob, prob_mpc, X_track, U_track = _make_setup()
    T = 15
    rng = np.random.default_rng(3)
    noise = jnp.asarray(rng.standard_normal((T, prob.n)))
    res = run_mpc_lockstep(prob_mpc, OPTS, X_track, U_track, noise,
                           qp_eps=1e-7)
    assert int(jnp.sum(res.status[:, 0])) == T  # ALTRO succeeded every step
    assert int(jnp.sum(res.status[:, 1])) == T  # ADMM converged every step
    # Solution agreement at tolerance level
    assert float(jnp.max(res.err_X)) < 5e-3
    assert float(jnp.max(res.err_U)) < 5e-3
    # Both solutions honor the initial condition
    assert float(jnp.max(res.err_x0)) < 1e-5


def test_shared_k_step_matches_per_lane_k():
    """The batched-driver step variant (shared_k=True: window index as an
    unbatched argument, so the tracking retarget is computed once per step)
    must reproduce the per-lane-k step exactly."""
    from altro_mpc.mpc import make_mpc_step

    prob, prob_mpc, X_track, U_track = _make_setup()
    B, T = 4, 5
    rng = np.random.default_rng(4)
    noise = jnp.asarray(rng.standard_normal((T, B, prob.n)))

    step_a, init_a = make_mpc_step(prob_mpc, OPTS, X_track, U_track)
    step_b, init_b = make_mpc_step(prob_mpc, OPTS, X_track, U_track,
                                   shared_k=True)
    va = jax.jit(jax.vmap(step_a, in_axes=(0, 0)))
    vb = jax.jit(jax.vmap(step_b, in_axes=(0, 0, None)))
    ca = jax.vmap(lambda _: init_a())(jnp.arange(B))
    cb = jax.vmap(lambda _: init_b())(jnp.arange(B))
    for t in range(T):
        ca, outa = va(ca, noise[t])
        cb, outb = vb(cb, noise[t], jnp.asarray(t, jnp.int32))
        # not bitwise: the shared-path retarget is computed unbatched, so
        # reduction order differs at machine-epsilon level
        assert float(jnp.max(jnp.abs(outa.U - outb.U))) < 1e-9
        assert float(jnp.max(jnp.abs(outa.x0 - outb.x0))) < 1e-9
        assert int(jnp.sum(jnp.abs(outa.iters - outb.iters))) == 0


def test_early_exact_stop_matches_default():
    """early_exact_tol (skip the dJ-confirmation iteration after an exact
    full Newton step) must keep tolerance-level solutions while cutting
    warm-solve iteration counts."""
    prob, prob_mpc, X_track, U_track = _make_setup()
    T = 15
    rng = np.random.default_rng(5)
    noise = jnp.asarray(rng.standard_normal((T, prob.n)))
    res_a = run_mpc(prob_mpc, OPTS, X_track, U_track, noise)
    res_b = run_mpc(prob_mpc, OPTS.replace(early_exact_tol=1e-3),
                    X_track, U_track, noise)
    assert int(jnp.sum(res_b.status)) == T
    assert float(jnp.max(res_b.viol)) < 1e-4
    # both are tolerance-level optimal on identical instances
    assert float(jnp.max(jnp.abs(res_a.U[:, 0] - res_b.U[:, 0]))) < 5e-3
    # and the early stop actually removes iterations
    assert float(jnp.mean(res_b.iters)) < float(jnp.mean(res_a.iters))


def test_mpc_warm_start_reduces_iterations():
    """Warm-started steps should take far fewer iLQR iterations than the
    cold initial solve (the whole point of the MPC warm-start machinery)."""
    prob, prob_mpc, X_track, U_track = _make_setup()
    T = 20
    noise = jnp.zeros((T, prob.n))  # noise-free: warm starts near-exact
    results = run_mpc(prob_mpc, OPTS, X_track, U_track, noise)
    assert float(jnp.mean(results.iters)) <= 8.0


def test_xws_corrector_is_exact_rollout():
    """The shifted-X seam correction must reproduce the warm-start init
    rollout exactly (up to f64 matmul reassociation) for LTI windows, and
    decline (return None) for genuinely time-varying stacks."""
    from altro_mpc.dynamics import LTVDynamics
    from altro_mpc.mpc import _xws_corrector, shift_fill

    prob, prob_mpc, X_track, U_track = _make_setup(seed=3)
    dyn = prob_mpc.dynamics
    corrector = _xws_corrector(dyn)
    assert corrector is not None

    rng = np.random.default_rng(7)
    # a genuine previous solution: any dynamically consistent trajectory
    x0_old = jnp.asarray(rng.standard_normal(prob.n))
    U_old = jnp.asarray(0.1 * rng.standard_normal((prob_mpc.N - 1, prob.m)))
    X_old = dyn.rollout(x0_old, U_old)
    # next step's true initial state = propagated + noise seam
    x0_new = X_old[1] + jnp.asarray(0.01 * rng.standard_normal(prob.n))
    U_ws = shift_fill(U_old)
    X_ws = corrector(X_old, U_ws, x0_new)
    X_exact = dyn.rollout(x0_new, U_ws)
    np.testing.assert_allclose(np.asarray(X_ws), np.asarray(X_exact),
                               atol=1e-10)

    # time-varying stacks: refuse (fall back to the in-solver rollout)
    A_tv = dyn.A.at[0].mul(1.5)
    assert _xws_corrector(LTVDynamics(A=A_tv, B=dyn.B, d=dyn.d)) is None
