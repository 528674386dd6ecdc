"""Quadruped stack tests: kinematics, gait, SRB dynamics, MPC backends in
lockstep (the reference's test_same_solution pattern, mujoco_test.jl:95-183),
and the closed-loop trot simulation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import altro_mpc as at
from altro_mpc.models.quadruped import (config, controller, gait, kinematics,
                                        planner, srb)

OPTS = at.SolverOptions(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                        penalty_initial=10.0, penalty_scaling=100.0,
                        reset_duals=False)


# ---------------------------------------------------------------- kinematics

def test_fk_ik_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(10):
        alpha = jnp.asarray(rng.uniform(-0.4, 0.4, 12))
        feet = kinematics.forward_kinematics_all(alpha)
        alpha_rt = kinematics.inverse_kinematics_all(feet)
        feet_rt = kinematics.forward_kinematics_all(alpha_rt)
        np.testing.assert_allclose(feet_rt, feet, atol=1e-8)


def test_leg_jacobian_matches_fd():
    alpha = jnp.asarray([0.1, 0.2, -0.1])
    J = kinematics.leg_jacobian(alpha, 0)
    eps = 1e-6
    for k in range(3):
        d = jnp.zeros(3).at[k].set(eps)
        fd = (kinematics.forward_kinematics(alpha + d, 0)
              - kinematics.forward_kinematics(alpha - d, 0)) / (2 * eps)
        np.testing.assert_allclose(J[:, k], fd, atol=1e-6)


def test_force_to_torque_is_jt_f():
    alpha = jnp.asarray(np.random.default_rng(1).uniform(-0.3, 0.3, 12))
    f = jnp.asarray(np.random.default_rng(2).standard_normal(12))
    tau = kinematics.force_to_torque(f, alpha)
    for i in range(4):
        J = kinematics.leg_jacobian(alpha[3 * i:3 * i + 3], i)
        np.testing.assert_allclose(tau[3 * i:3 * i + 3],
                                   J.T @ f[3 * i:3 * i + 3], atol=1e-10)


# ---------------------------------------------------------------------- gait

def test_trot_phases():
    g = gait.trot(stance_time=0.2, swing_time=0.2)
    assert g.num_phases == 4
    assert float(g.phase_length) == pytest.approx(0.8)
    # phase 0 = all-stance, phase 1 = legs 1,2 (0-indexed) swinging
    np.testing.assert_array_equal(g.contacts_at(0.1), [1, 1, 1, 1])
    np.testing.assert_array_equal(g.contacts_at(0.3), [1, 0, 0, 1])
    np.testing.assert_array_equal(g.contacts_at(0.5), [1, 1, 1, 1])
    np.testing.assert_array_equal(g.contacts_at(0.7), [0, 1, 1, 0])
    # periodicity
    np.testing.assert_array_equal(g.contacts_at(0.9), g.contacts_at(0.1))


# ----------------------------------------------------------------- dynamics

def test_srb_hover_equilibrium():
    """Equal vertical forces summing to weight at nominal stance => zero
    acceleration (the physics sanity check behind the MPC model)."""
    x = jnp.zeros(12).at[2].set(0.28)
    feet = planner.nominal_foot_locations() + x[0:3][None, :]
    w = srb.SPRUNG_MASS * 9.81 / 4
    u = jnp.tile(jnp.asarray([0.0, 0.0, w]), 4)
    xdot = srb.continuous_dynamics(x, u, feet, jnp.ones(4))
    np.testing.assert_allclose(xdot[6:9], np.zeros(3), atol=1e-10)
    # nominal feet are symmetric about the COM x/y => no net torque
    np.testing.assert_allclose(xdot[9:12], np.zeros(3), atol=1e-8)


def test_mrp_rotation_orthonormal():
    phi = jnp.asarray([0.1, -0.2, 0.3])
    R = srb.mrp_rotation(phi)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-12)


# ------------------------------------------------- MPC backends in lockstep

@pytest.fixture(scope="module")
def mpc_scenario():
    cfg = config.MPCConfig()
    g = gait.trot(cfg.stance_time, cfg.swing_time)
    prob, x_des = controller.build_mpc_problem(cfg)
    x_curr = x_des + jnp.asarray(
        np.random.default_rng(3).standard_normal(12)) * 0.01
    x_ref = jnp.tile(x_des, (cfg.N, 1))
    feet_w = planner.nominal_foot_locations() + x_des[0:3][None, :]
    contacts, foot_locs, _ = planner.foot_history(
        0.05, x_ref, feet_w, feet_w, g, x_des, cfg.N,
        cfg.dynamics_discretization)
    return cfg, prob, x_des, x_curr, x_ref, contacts, foot_locs


def test_altro_vs_admm_qp_same_forces(mpc_scenario):
    """test_same_solution analog (mujoco_test.jl:95-183): ALTRO with
    linearized friction vs the OSQP-role ADMM QP on the same instance."""
    cfg, prob, x_des, x_curr, x_ref, contacts, foot_locs = mpc_scenario
    u0 = jnp.tile(jnp.asarray([0.0, 0.0, srb.SPRUNG_MASS * 9.81 / 4]), 4)
    U0 = jnp.tile(u0, (cfg.N - 1, 1))
    duals = prob.init_duals(OPTS.penalty_initial)

    opts_tight = OPTS.replace(cost_tolerance=1e-6, constraint_tolerance=1e-6,
                              gradient_tolerance=1e-8)
    f_altro, U_a, _, it_a, st_a, _ = controller.mpc_solve_forces(
        "altro", prob, opts_tight, x_curr, x_ref, contacts, foot_locs,
        cfg.dynamics_discretization, U0, duals)
    f_qp, U_q, _, it_q, st_q, _ = controller.mpc_solve_forces(
        "admm_qp", prob, opts_tight.replace(cost_tolerance=1e-8), x_curr,
        x_ref, contacts, foot_locs, cfg.dynamics_discretization, U0, duals)
    assert int(st_a) == 1 and int(st_q) == 1
    np.testing.assert_allclose(f_altro, f_qp, atol=2e-3, rtol=1e-3)

    # remaining test_same_solution assertions (mujoco_test.jl:138-210):
    # friction-pyramid feasibility of both solutions + cost parity
    mu = cfg.mu
    for U_sol in (U_a, U_q):
        F = np.asarray(U_sol).reshape(-1, 4, 3)
        fz = np.maximum(F[:, :, 2], 0.0)
        assert np.all(np.abs(F[:, :, 0]) <= mu * fz + 1e-3)
        assert np.all(np.abs(F[:, :, 1]) <= mu * fz + 1e-3)
    from altro_mpc.models.quadruped.srb import linearize_horizon
    dyn = linearize_horizon(x_ref, jnp.zeros((cfg.N, 12)), foot_locs,
                            contacts, cfg.dynamics_discretization)
    prob_k = prob.replace(dynamics=dyn, x0=x_curr)

    def rollout_cost(U_sol):
        X_sol = prob_k.dynamics.rollout(x_curr, U_sol)
        return float(prob_k.cost.total(X_sol, U_sol))

    ca, cq = rollout_cost(U_a), rollout_cost(U_q)
    assert abs(ca - cq) / max(abs(ca), 1.0) < 1e-3  # cost parity


def test_altro_soc_vs_admm_conic_same_forces(mpc_scenario):
    """Full friction-cone (SOCP) configs: ALTRO vs the ECOS-role conic ADMM."""
    cfg, _, x_des, x_curr, x_ref, contacts, foot_locs = mpc_scenario
    cfg_soc = config.MPCConfig(linearized_friction=False)
    prob_soc, _ = controller.build_mpc_problem(cfg_soc)
    u0 = jnp.tile(jnp.asarray([0.0, 0.0, srb.SPRUNG_MASS * 9.81 / 4]), 4)
    U0 = jnp.tile(u0, (cfg.N - 1, 1))
    duals = prob_soc.init_duals(OPTS.penalty_initial)

    opts_tight = OPTS.replace(cost_tolerance=1e-6, constraint_tolerance=1e-6,
                              gradient_tolerance=1e-8)
    f_altro, _, _, _, st_a, _ = controller.mpc_solve_forces(
        "altro", prob_soc, opts_tight, x_curr, x_ref, contacts, foot_locs,
        cfg.dynamics_discretization, U0, duals)
    f_con, _, _, _, st_c, _ = controller.mpc_solve_forces(
        "admm_conic", prob_soc, opts_tight.replace(cost_tolerance=1e-8),
        x_curr, x_ref, contacts, foot_locs, cfg.dynamics_discretization, U0,
        duals)
    assert int(st_a) == 1 and int(st_c) == 1
    # agreement floor is the conic ADMM baseline's absolute-residual
    # precision (~1e-8 on a 133 N force scale => ~5e-3-level primals)
    np.testing.assert_allclose(f_altro, f_con, atol=5e-3, rtol=5e-3)


# --------------------------------------------------------------- closed loop

def test_closed_loop_trot():
    """1 s closed-loop trot on the SRB plant: solver succeeds every period,
    body stays near stance height, forces feasible."""
    cfg = config.MPCConfig()
    res = controller.simulate(cfg, OPTS, tf=1.0, backend="altro")
    status = np.asarray(res["status"])
    assert status.min() == 1, f"solver failures: {status}"
    xs = np.asarray(res["x"])
    assert abs(xs[-1, 2] - cfg.stance_height) < 0.05   # height hold
    assert np.max(np.abs(xs[:, 3:5])) < 0.2            # roll/pitch bounded
    fz = np.asarray(res["forces"]).reshape(-1, 4, 3)[:, :, 2]
    assert fz.min() >= -1e-6 and fz.max() <= cfg.max_vert_force + 1e-4


def test_closed_loop_trot_model_mismatch():
    """Model-mismatch closed loop (the role MuJoCo's independent contact
    physics plays in mujoco_test.jl:20-89): the plant runs with +10% mass,
    -10% inertia, 1 cm foot-position error, and a 0.1 m/s lateral velocity
    kick at t=0.9 s while the MPC keeps nominal parameters. The trot must
    survive 2 s with bounded attitude/height error. (A persistent >5 mm
    all-feet horizontal bias is equivalent to an unmodeled CoM offset;
    without integral action no MPC of this architecture rejects it — the
    reference's included.)"""
    cfg = config.MPCConfig()
    plant = controller.PlantParams.nominal().replace(
        mass_scale=jnp.asarray(1.10),
        inertia_scale=jnp.asarray(0.90),
        foot_offset=jnp.asarray([0.003, 0.0015, 0.0]),
        kick_impulse=jnp.asarray([0.0, 0.1, 0.0]),
        kick_t=jnp.asarray(0.9))
    res = controller.simulate(cfg, OPTS, tf=2.0, backend="altro", plant=plant)
    status = np.asarray(res["status"])
    assert status.min() == 1, f"solver failures: {status}"
    xs = np.asarray(res["x"])
    assert abs(xs[-1, 2] - cfg.stance_height) < 0.07    # height hold
    assert np.max(np.abs(xs[:, 3:5])) < 0.15            # roll/pitch bounded
    # the kick must actually perturb the plant, and the controller recover:
    # lateral velocity bounded at the end
    assert abs(xs[-1, 7]) < 0.15
