"""Quadruped MPC controller + closed-loop SRB simulation.

Accelerator-native rebuild of Woofer/MPCControl/control.jl:1-112 (the 1 kHz control
loop), altro_solver.jl / osqp_solver.jl / ecos_solver.jl (the three MPC
backends), and mujoco_test.jl's simulation harness with the framework's own
RK4 nonlinear-SRB plant in place of MuJoCo (SURVEY.md section 2.7: the
published numbers only need the MPC solve loop, not contact-accurate sim).

Design notes vs the reference:
- the whole closed loop is a hierarchical ``lax.scan``: outer over MPC
  periods (30 ms), inner over 1 kHz control ticks — the MPC trigger is
  structural, the footstep/swing state machine is branchless (where-masked)
- the plant's swing feet follow their splines kinematically (massless-leg
  assumption already implicit in the reference's SRB model); swing PD forces
  and J^T torques are still computed for parity and recorded
- backends: 'altro' with linearized-friction (QP) or SOC friction cones,
  'admm_qp' (the OSQP-role baseline), 'admm_conic' (the ECOS-role baseline)
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from ...utils import struct

from ... import constraints as C
from ...costs import lqr_objective
from ...problem import Problem
from ...native import qp as native_qp
from ...solver import admm_conic, admm_qp, knot_admm
from ...solver.altro import solve
from ...solver.options import SolverOptions
from ...transcribe import to_batch_conic, to_batch_qp
from ...mpc import shift_fill
from .config import MPCConfig, woofer as _w
from .gait import GAITS, Gait
from . import kinematics, planner, swing
from .srb import linearize_horizon, mrp_rotation, rk4_plant

SPRUNG_MASS = _w.inertial.sprung_mass
DT_SIM = 0.001


def build_mpc_problem(cfg: MPCConfig, dtype=jnp.float64):
    """Static parts of the MPC problem (ALTROParams.jl:32-108): LQR tracking
    objective around x_des, per-foot friction constraints, vertical-force
    bounds. Dynamics stacks are placeholders, relinearized each solve."""
    N, n, m = cfg.N, 12, 12
    Q = jnp.diag(jnp.asarray(cfg.q, dtype))
    R = jnp.diag(jnp.asarray(cfg.r, dtype))
    x_des = jnp.asarray(
        [0.0, 0.0, cfg.stance_height, 0.0, 0.0, cfg.yaw_angle,
         cfg.xy_vel[0], cfg.xy_vel[1], 0.0, 0.0, 0.0, cfg.omega_z], dtype)
    cost = lqr_objective(Q, R, Q, x_des, N, dt=cfg.dynamics_discretization)

    cons = []
    for leg in range(4):
        inds = (3 * leg, 3 * leg + 1, 3 * leg + 2)
        if cfg.linearized_friction:
            cons.append(C.linearized_friction(N, n, m, cfg.mu, inds,
                                              dtype=dtype))
        else:
            cons.append(C.friction_cone(N, n, m, cfg.mu, inds, dtype=dtype))
    import numpy as _np
    # bounds are structural (row selection by finiteness) -> host-side numpy
    u_min = _np.full(m, -_np.inf)
    u_min[2::3] = cfg.min_vert_force
    u_max = _np.full(m, _np.inf)
    u_max[2::3] = cfg.max_vert_force
    cons.append(C.bound_constraint(N, n, m, u_min=u_min, u_max=u_max,
                                   dtype=dtype))

    import numpy as np
    dynA = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (N - 1, n, n))
    dynB = jnp.zeros((N - 1, n, m), dtype)
    dynd = jnp.zeros((N - 1, n), dtype)
    from ...dynamics import LTVDynamics
    prob = Problem(dynamics=LTVDynamics(A=dynA, B=dynB, d=dynd), cost=cost,
                   constraints=tuple(cons), x0=x_des)
    return prob, x_des


def _linearized_problem(prob: Problem, x_curr, x_ref, contacts, foot_locs,
                        dt_mpc) -> Problem:
    """Per-step problem instance with the horizon contact schedule.

    Deviation from altro_solver.jl:56 (u_ref = 0): linearize about the
    gravity-distributing stance forces (m g / n_stance vertical per stance
    foot). At u_ref = 0 the Jacobians lose the force-position coupling
    d(torque)/d(p) entirely, so the MPC cannot see the tipping moment a
    lateral CoM offset creates — invisible under MuJoCo's compliant legs,
    but destabilizing against the rigid pinned-feet SRB plant. The affine
    residual d = f(xbar, ubar) - A xbar - B ubar keeps the model exact at
    the linearization point either way."""
    nst = jnp.maximum(jnp.sum(contacts, axis=1, keepdims=True), 1.0)
    fz_ref = SPRUNG_MASS * 9.81 / nst * contacts            # [N, 4]
    u_ref = jnp.zeros((prob.N, 12), x_curr.dtype).at[:, 2::3].set(fz_ref)
    dyn = linearize_horizon(x_ref, u_ref, foot_locs, contacts, dt_mpc)
    return prob.replace(dynamics=dyn, x0=x_curr)


def mpc_solve_forces(backend: str, prob: Problem, opts: SolverOptions,
                     x_curr, x_ref, contacts, foot_locs, dt_mpc,
                     U_prev, duals, baseline=None):
    """One MPC solve (foot_forces! dispatch, altro_solver.jl:44-88 /
    osqp_solver.jl / ecos_solver.jl). Relinearizes with the horizon contact
    schedule, warm-starts, solves, returns
    (forces [12], U, duals, iters, status, baseline).

    ``baseline`` carries the ADMM backends' setup-once structured workspace
    (a knot_admm.KnotADMMWork) — the reference's OSQP setup-once +
    in-place-update pattern (OSQPParams.jl:127-162, osqp_solver.jl:70-97).
    Without it the ADMM backends cold-start the dense oracles every solve
    (oracle-grade, not timing-grade)."""
    prob_k = _linearized_problem(prob, x_curr, x_ref, contacts, foot_locs,
                                 dt_mpc)

    N, n, m = prob.N, 12, 12
    if backend == "altro":
        sol = solve(prob_k, opts, U0=shift_fill(U_prev),
                    duals=tuple(d.shift() for d in duals))
        return (sol.U[0], sol.U, sol.duals, sol.stats.iterations,
                sol.stats.status, baseline)
    # ADMM baseline backends (OSQP/ECOS roles). With ``baseline`` they run
    # the reference's timing-grade pattern — setup-once scalings + per-solve
    # banded KKT refactor via the MPC-structured knot ADMM (knot_admm.py;
    # OSQPParams.jl:127-162's sparse setup-once + update! equivalent).
    # Without it they fall back to the dense oracles, cold each solve.
    # (A shifted primal/dual warm start was measured to HURT here: each MPC
    # period rolls a stance transition through the horizon, flipping
    # equality rows at rho * 1e3, and the adaptive-rho transient that causes
    # costs more than the zero start.)
    if backend in ("admm_qp", "admm_conic"):
        if baseline is not None and isinstance(baseline,
                                               native_qp.NativeKnotWork):
            # timing-grade NATIVE backend (native/knot_solver.cpp): the
            # reference times native C solvers (OSQP/ECOS), so the honest
            # CPU-latency comparison is C-vs-C. Same update!+solve pattern:
            # in-place value update + banded refactor (adapted rho is
            # RETAINED across updates, OSQP behavior), zero-start solve.
            kqp = _to_knot_qp_jit(prob_k)
            baseline.update(kqp)
            # warm=True (OSQP warm_start=true): measured 79 -> 42 mean
            # iters over the trot sequence — the round-2 "iterate carries
            # hurt" finding applied to the JAX solver with rho RESET per
            # solve; with retained rho the carry wins
            nsol = baseline.solve(eps_abs=float(opts.cost_tolerance),
                                  check_every=10, warm=True)
            U_n = jnp.asarray(nsol.U, prob_k.x0.dtype)
            return (U_n[0], U_n, duals, nsol.iterations, nsol.status,
                    baseline)
        if baseline is not None:
            kqp = knot_admm.to_knot_qp(prob_k)
            ksol = knot_admm.solve(knot_admm.refactor(baseline, kqp),
                                   eps_abs=float(opts.cost_tolerance))
            return (ksol.U[0], ksol.U, duals, ksol.iterations, ksol.status,
                    baseline)
        if backend == "admm_qp":
            qp = to_batch_qp(prob_k)
            qsol = admm_qp.solve(admm_qp.setup(qp),
                                 eps_abs=float(opts.cost_tolerance))
            _, Uq = admm_qp.extract_traj(qp, qsol.x)
            return Uq[0], Uq, duals, qsol.iterations, qsol.status, None
        cp = to_batch_conic(prob_k)
        csol = admm_conic.solve(admm_conic.setup(cp),
                                eps_abs=float(opts.cost_tolerance))
        _, Uc = admm_conic.extract_traj(cp, csol.x)
        return Uc[0], Uc, duals, csol.iterations, csol.status, None
    raise ValueError(backend)


def make_baseline_state(backend: str, prob: Problem, cfg: MPCConfig, x_des,
                        dtype=jnp.float64, native: bool = True):
    """Setup-once structured-ADMM workspace from a representative
    all-stance linearization at x_des — the reference's OSQP setup phase
    (OSQPParams.jl:60-125). Scalings are a preconditioner; reusing them
    across per-step relinearizations is safe and is what makes the
    baselines timing-grade (only the banded KKT refactors per solve).

    With ``native=True`` (default) and the C++ toolchain available, returns
    a native knot-ADMM workspace (native/knot_solver.cpp) — the C twin of
    solver/knot_admm.py and the honest CPU-latency counterpart of the
    reference's native OSQP/ECOS; ``native=False`` forces the JAX solver."""
    if backend == "altro":
        return None
    N = cfg.N
    contacts0 = jnp.ones((N, 4), dtype)
    feet0 = jnp.tile(
        (x_des[0:3][None, :] +
         planner.nominal_foot_locations()).at[:, 2].set(
             _w.geometry.foot_radius)[None], (N, 1, 1))
    fz = SPRUNG_MASS * 9.81 / 4.0
    u_ref = jnp.zeros((N, 12), dtype).at[:, 2::3].set(fz)
    dyn0 = linearize_horizon(jnp.tile(x_des, (N, 1)), u_ref, feet0,
                             contacts0, cfg.dynamics_discretization)
    prob0 = prob.replace(dynamics=dyn0, x0=x_des)
    if backend in ("admm_qp", "admm_conic"):
        # rho = 0.1: measured best over the trot sequence for both the
        # linearized-friction QP (192 vs 276/358 mean iters at 1.0/3.0)
        # and the friction-cone SOCP (~157 iters)
        kqp = knot_admm.to_knot_qp(prob0)
        if native and native_qp.available():
            return native_qp.knot_setup(kqp, rho=0.1)
        return knot_admm.setup(kqp, rho=0.1)
    raise ValueError(backend)


# jit the Problem -> KnotQP transcription used by the native backend: the
# structure is fixed across MPC steps, so this compiles once and keeps the
# per-step host cost at array-copy level
_to_knot_qp_jit = jax.jit(knot_admm.to_knot_qp)


@struct.dataclass
class PlantParams:
    """True-plant parameters for model-mismatch closed loops (the role of
    MuJoCo's independent contact physics, mujoco_test.jl:20-89). The MPC
    always linearizes the nominal model; the plant integrates with these.

    ``foot_offset`` [3] shifts the world foot positions the plant's force
    model sees (foot-position estimation error); ``kick_impulse`` [3] is a
    one-shot body-frame velocity impulse applied at ``kick_t`` seconds."""

    mass_scale: jnp.ndarray = struct.field(default=None)
    inertia_scale: jnp.ndarray = struct.field(default=None)
    foot_offset: jnp.ndarray = struct.field(default=None)
    kick_impulse: jnp.ndarray = struct.field(default=None)
    kick_t: jnp.ndarray = struct.field(default=None)

    @staticmethod
    def nominal(dtype=jnp.float64) -> "PlantParams":
        return PlantParams(
            mass_scale=jnp.ones((), dtype),
            inertia_scale=jnp.ones((), dtype),
            foot_offset=jnp.zeros(3, dtype),
            kick_impulse=jnp.zeros(3, dtype),
            kick_t=jnp.full((), -1.0, dtype))


@struct.dataclass
class SimState:
    x: jnp.ndarray               # [12] SRB state
    feet_w: jnp.ndarray          # [4, 3] world foot positions
    prev_feet_b: jnp.ndarray     # [4, 3] body-frame feet (velocity estimate)
    swing_coeffs: jnp.ndarray    # [4, 12] spline coefficients
    planner_foot_loc: jnp.ndarray  # [4, 3]
    next_foot_loc: jnp.ndarray   # [4, 3]
    swing_tf: jnp.ndarray        # [4] spline end times
    last_replan_t: jnp.ndarray
    prev_phase: jnp.ndarray
    forces: jnp.ndarray          # [12] current MPC forces
    U_prev: jnp.ndarray          # [N-1, 12]
    duals: Tuple


def initial_state(prob: Problem, x_des, opts, dtype=jnp.float64) -> SimState:
    nom = planner.nominal_foot_locations()
    feet_w = (x_des[0:3][None, :] + nom).at[:, 2].set(
        _w.geometry.foot_radius)
    feet_b = feet_w - x_des[0:3][None, :]
    u0 = jnp.tile(jnp.asarray([0.0, 0.0, SPRUNG_MASS * 9.81 / 4], dtype), 4)
    return SimState(
        x=x_des, feet_w=feet_w, prev_feet_b=feet_b,
        swing_coeffs=jnp.zeros((4, 12), dtype),
        planner_foot_loc=feet_w, next_foot_loc=feet_w,
        swing_tf=jnp.zeros(4, dtype),
        last_replan_t=jnp.zeros((), dtype),
        prev_phase=jnp.zeros((), jnp.int32),
        forces=u0,
        U_prev=jnp.tile(u0, (prob.N - 1, 1)),
        duals=prob.init_duals(opts.penalty_initial),
    )


def control_tick(state: SimState, t, gait: Gait, cfg: MPCConfig, x_des,
                 plant: Optional[PlantParams] = None):
    """One 1 kHz tick: swing state machine + plant integration
    (control!, control.jl:1-112, branchless)."""
    x = state.x
    p = x[0:3]
    rot = mrp_rotation(x[3:6])
    feet_b = jnp.einsum("ji,kj->ki", rot, state.feet_w - p[None, :])
    feet_vel_b = (feet_b - state.prev_feet_b) / DT_SIM

    cur_phase = gait.phase_at(t)
    cur_phase_time = gait.phase_time(t, cur_phase)
    active = gait.contact_phases[cur_phase]
    prev_active = gait.contact_phases[state.prev_phase]

    # stance -> swing transition: plan footstep + regenerate full spline
    released = (prev_active == 1) & (active == 0)
    do_replan = (t - state.last_replan_t) > cfg.footstep_replan
    replanning = (active == 0) & do_replan

    planned = jax.vmap(lambda leg: planner.footstep_location(
        x, rot, cur_phase, leg, gait, x_des))(jnp.arange(4))
    upd = released | replanning
    next_fl = jnp.where(upd[:, None], planned, state.next_foot_loc)
    planner_fl = jnp.where(upd[:, None], planned, state.planner_foot_loc)

    tf_release = t + gait.phase_times[cur_phase]
    tf_replan = (t - cur_phase_time) + gait.phase_times[cur_phase]
    swing_tf = jnp.where(released, tf_release,
                         jnp.where(replanning, tf_replan, state.swing_tf))

    def regen(leg, regen_z, tf):
        return swing.foot_trajectory_coeffs(
            x, rot, feet_b[leg], feet_vel_b[leg], next_fl[leg], t, tf,
            cfg.step_height,
            prev_z_coeffs=state.swing_coeffs[leg, 8:12],
            regen_z=regen_z)

    coeffs_full = jax.vmap(lambda l: regen(l, True, swing_tf[l]))(jnp.arange(4))
    coeffs_xy = jax.vmap(lambda l: regen(l, False, swing_tf[l]))(jnp.arange(4))
    coeffs = jnp.where(released[:, None], coeffs_full,
                       jnp.where(replanning[:, None], coeffs_xy,
                                 state.swing_coeffs))

    # swing PD forces (parity path; recorded, legs are massless in the plant)
    pd = jax.vmap(lambda l: swing.swing_pd_force(
        x, rot, coeffs[l], feet_b[l], feet_vel_b[l], t,
        omega=cfg.swing_omega, zeta=cfg.swing_zeta))(jnp.arange(4))

    # plant step: stance feet pinned, swing feet track their splines
    if plant is None:
        x_new = rk4_plant(x, state.forces, state.feet_w, active, DT_SIM)
    else:
        x_new = rk4_plant(x, state.forces,
                          state.feet_w + plant.foot_offset[None, :], active,
                          DT_SIM, plant.mass_scale, plant.inertia_scale)
        # one-shot velocity impulse (contact-kick disturbance): applied on
        # the single tick containing kick_t
        kicked = (t <= plant.kick_t) & (plant.kick_t < t + DT_SIM)
        x_new = x_new.at[6:9].add(
            jnp.where(kicked, plant.kick_impulse, 0.0))
    spline_pos = jax.vmap(
        lambda l: swing.swing_foot_target(coeffs[l], t + DT_SIM)[0]
    )(jnp.arange(4))
    feet_w_new = jnp.where(active[:, None] == 1, state.feet_w, spline_pos)

    # joint torques (records; tau = J^T f blend, control.jl:107-111)
    alpha = kinematics.inverse_kinematics_all(feet_b.reshape(-1))
    tau_mpc = kinematics.force_to_torque(-state.forces, alpha)
    tau_swing = kinematics.force_to_torque(pd.reshape(-1), alpha)
    active12 = jnp.repeat(active, 3)
    torques = active12 * tau_mpc + (1 - active12) * tau_swing

    state = state.replace(
        x=x_new, feet_w=feet_w_new, prev_feet_b=feet_b,
        swing_coeffs=coeffs, planner_foot_loc=planner_fl,
        next_foot_loc=next_fl, swing_tf=swing_tf,
        last_replan_t=jnp.where(jnp.any(upd), t, state.last_replan_t),
        prev_phase=cur_phase)
    return state, torques


def simulate(cfg: MPCConfig, opts: SolverOptions, tf: float = 2.0,
             backend: str = "altro", dtype=jnp.float64,
             plant: Optional[PlantParams] = None):
    """Closed-loop trot (quadruped_benchmark.jl:1-55 / mujoco_simulate).

    Hierarchical scan: outer over MPC periods (cfg.update_dt), inner over
    1 kHz ticks. Returns per-period records (body state, forces, iterations,
    solver status). Pass ``plant`` to run the true plant with perturbed
    parameters while the MPC keeps the nominal model (model-mismatch
    validation; mujoco_test.jl:20-89 role).
    """
    gait = GAITS[cfg.gait_type](cfg.stance_time, cfg.swing_time)
    prob, x_des = build_mpc_problem(cfg, dtype)
    ticks_per_mpc = int(round(cfg.update_dt / DT_SIM))
    n_periods = int(round(tf / cfg.update_dt))

    state0 = initial_state(prob, x_des, opts, dtype)
    # the whole loop is one lax.scan: the ctypes-backed native baseline
    # cannot run under trace, so this path always uses the JAX knot ADMM
    baseline0 = make_baseline_state(backend, prob, cfg, x_des, dtype,
                                    native=False)

    def period(carry, k):
        state, baseline = carry
        t = k.astype(dtype) * cfg.update_dt

        # MPC: reference, horizon schedule, solve
        x_ref = jnp.tile(x_des, (cfg.N, 1))  # reference_trajectory!
        contacts, foot_locs, planner_fl = planner.foot_history(
            t, x_ref, state.feet_w, state.planner_foot_loc, gait, x_des,
            cfg.N, cfg.dynamics_discretization)
        forces, U_new, duals, iters, status, baseline = mpc_solve_forces(
            backend, prob, opts, state.x, x_ref, contacts, foot_locs,
            cfg.dynamics_discretization, state.U_prev, state.duals, baseline)
        state = state.replace(forces=forces, U_prev=U_new, duals=duals,
                              planner_foot_loc=planner_fl)

        def tick(s, j):
            tj = t + j.astype(dtype) * DT_SIM
            s, torques = control_tick(s, tj, gait, cfg, x_des, plant)
            return s, None

        state, _ = jax.lax.scan(tick, state, jnp.arange(ticks_per_mpc))
        rec = (state.x, forces, iters, status)
        return (state, baseline), rec

    (state, _), (xs, forces, iters, status) = jax.lax.scan(
        period, (state0, baseline0), jnp.arange(n_periods))
    return dict(x=xs, forces=forces, iters=iters, status=status)


def simulate_host(cfg: MPCConfig, opts: SolverOptions, tf: float = 2.0,
                  backend: str = "altro", dtype=jnp.float64,
                  plant: Optional[PlantParams] = None, native: bool = True,
                  probe=None):
    """Host-driven closed loop timing the MPC SOLVE separately from the
    1 kHz sim ticks, with the reference's solver-internal accounting:
    the quadruped table records ONLY ``stats.tsolve`` (ALTRO,
    altro_solver.jl:75) / ``results.info.solve_time`` (OSQP,
    osqp_solver.jl:84-88) — the relinearization, the in-place matrix
    update, and OSQP's KKT refactor inside ``OSQP.update!`` are all
    untimed. Here ``mpc_ms`` is the equivalent solver-internal wall
    (native solve call / jitted solve-only program) and ``prep_ms`` is
    everything else in the MPC period (foot schedule, relinearization,
    transcription, workspace update+refactor) so the honest end-to-end
    number is their sum.

    With ``native=True`` both race entrants are C++: the ALTRO backend
    runs native/ilqr_solver.cpp and the ADMM backends run
    native/knot_solver.cpp — C-vs-C, like the reference's compiled-Julia
    ALTRO vs C OSQP/ECOS. The OSQP-role runs eps 1e-3 + active-set POLISH
    (measured on the trot QP: half the iterations of plain eps 1e-4 with
    residuals 1e-7 vs 1e-3 — strictly better on both axes; stock OSQP's
    high-accuracy mechanism)."""
    import time as _time

    gait = GAITS[cfg.gait_type](cfg.stance_time, cfg.swing_time)
    prob, x_des = build_mpc_problem(cfg, dtype)
    ticks_per_mpc = int(round(cfg.update_dt / DT_SIM))
    n_periods = int(round(tf / cfg.update_dt))

    state0 = initial_state(prob, x_des, opts, dtype)
    baseline0 = make_baseline_state(backend, prob, cfg, x_des, dtype,
                                    native=native)

    def ticks_part(state, t):
        def tick(s, j):
            tj = t + j.astype(dtype) * DT_SIM
            s, _torques = control_tick(s, tj, gait, cfg, x_des, plant)
            return s, None

        state, _ = jax.lax.scan(tick, state, jnp.arange(ticks_per_mpc))
        return state

    jticks = jax.jit(ticks_part)

    def prep_fn(state, t):
        x_ref = jnp.tile(x_des, (cfg.N, 1))
        contacts, foot_locs, planner_fl = planner.foot_history(
            t, x_ref, state.feet_w, state.planner_foot_loc, gait, x_des,
            cfg.N, cfg.dynamics_discretization)
        prob_k = _linearized_problem(
            prob, state.x, x_ref, contacts, foot_locs,
            cfg.dynamics_discretization)
        return prob_k, planner_fl

    jprep = jax.jit(prep_fn)
    if probe is not None:
        # stash each period's linearized problem for the probe callback
        # (probe(k, prob_k, U_new) runs OUTSIDE the timed sections; it lets
        # a caller replay the identical QP sequence through the
        # OSQP-reference oracle)
        _probe_pk = {}
        _jprep0 = jprep

        def jprep(state, t):
            pk, fl = _jprep0(state, t)
            _probe_pk["pk"] = pk
            return pk, fl

    native_knot = isinstance(baseline0, native_qp.NativeKnotWork)
    native_ilqr = (backend == "altro" and native and native_qp.available())

    # per-backend (prep -> timed-solve -> state) host closures -------------
    if native_ilqr:
        # C++ AL-iLQR (the reference's compiled-native-ALTRO role). The
        # workspace is built lazily from the first concrete prob_k; per
        # step: update values (prep), solve with shifted warm starts
        # (timed). lam rows are the concatenated constraint blocks.
        ilqr_w = []

        def do_prep(state, t):
            pk, planner_fl = jprep(state, t)
            jax.block_until_ready(pk.x0)
            if not ilqr_w:
                ilqr_w.append(native_qp.ilqr_setup(pk))
            else:
                ilqr_w[0].update(pk)
            return None, planner_fl

        import numpy as _np
        warm = {"U": None, "lam": None}

        def do_solve(state, _pk):
            U0 = lam0 = None
            if warm["U"] is not None:
                U0 = _np.concatenate([warm["U"][1:], warm["U"][-1:]], 0)
                lam0 = _np.concatenate([warm["lam"][1:], warm["lam"][-1:]],
                                       0)
            ns = ilqr_w[0].solve(opts, U0=U0, lam0=lam0)
            warm["U"], warm["lam"] = ns.U, ns.lam
            U_n = jnp.asarray(ns.U, dtype)
            return U_n, ns.iterations, ns.status
    elif native_knot:
        def do_prep(state, t):
            pk, planner_fl = jprep(state, t)
            kqp = _to_knot_qp_jit(pk)
            jax.block_until_ready(kqp.Q)
            baseline0.update(kqp)
            return None, planner_fl

        # OSQP-role (box QP): eps 1e-3 + polish — measured on this QP to
        # halve iterations vs plain eps 1e-4 AND land residuals at 1e-7
        # (see docstring). ECOS-role (SOC cones): polish is box-only, keep
        # the plain tolerance.
        qp_mode = backend == "admm_qp"
        eps_n = 1e-3 if qp_mode else float(opts.cost_tolerance)

        def do_solve(state, _pk):
            nsol = baseline0.solve(eps_abs=eps_n, check_every=5, warm=True,
                                   polish=qp_mode)
            return (jnp.asarray(nsol.U, dtype), nsol.iterations,
                    nsol.status)
    else:
        # JAX fallbacks: solve-only jitted program (prep jitted separately)
        def jax_solve(prob_k, U_prev, duals):
            if backend == "altro":
                sol = solve(prob_k, opts, U0=shift_fill(U_prev),
                            duals=tuple(d.shift() for d in duals))
                return sol.U, sol.duals, sol.stats.iterations, \
                    sol.stats.status
            kqp = knot_admm.to_knot_qp(prob_k)
            ksol = knot_admm.solve(
                knot_admm.refactor(baseline0, kqp)
                if baseline0 is not None else knot_admm.setup(kqp),
                eps_abs=float(opts.cost_tolerance))
            return ksol.U, duals, ksol.iterations, ksol.status

        jsolve = jax.jit(jax_solve)
        jax_duals = {"d": state0.duals}

        def do_prep(state, t):
            pk, planner_fl = jprep(state, t)
            jax.block_until_ready(pk.x0)
            return pk, planner_fl

        def do_solve(state, pk):
            U_new, duals, iters, status = jsolve(pk, state.U_prev,
                                                 jax_duals["d"])
            jax.block_until_ready(U_new)
            jax_duals["d"] = duals
            return U_new, iters, status

    # compile / build outside the timed loop (functional up to the native
    # workspaces, whose adapted-rho warm-up IS the setup-once pattern)
    t_w = jnp.asarray(0.0, dtype)
    pk_w, _ = do_prep(state0, t_w)
    do_solve(state0, pk_w)
    jax.block_until_ready(jticks(state0, t_w).x)
    if native_knot:
        # the warm-up just SOLVED the t=0 instance; drop its converged
        # iterate (keep the adapted rho — the setup-once carryover) so the
        # first timed solve isn't a warm resume of an identical instance
        baseline0.reset_iterate()
    if native_ilqr:
        warm["U"] = warm["lam"] = None

    state = state0
    xs, forces, iters_l, status_l = [], [], [], []
    mpc_ms, prep_ms, tick_ms = [], [], []
    for k in range(n_periods):
        t = jnp.asarray(k * cfg.update_dt, dtype)
        t0 = _time.perf_counter()
        pk, planner_fl = do_prep(state, t)
        t1 = _time.perf_counter()
        U_new, iters, status = do_solve(state, pk)
        jax.block_until_ready(U_new)
        t2 = _time.perf_counter()
        prep_ms.append((t1 - t0) * 1e3)
        mpc_ms.append((t2 - t1) * 1e3)
        state = state.replace(forces=U_new[0], U_prev=U_new,
                              planner_foot_loc=planner_fl)
        if probe is not None:
            probe(k, _probe_pk.get("pk"), U_new)
        f = state.forces
        t0 = _time.perf_counter()
        state = jticks(state, t)
        jax.block_until_ready(state.x)
        tick_ms.append((_time.perf_counter() - t0) * 1e3)
        xs.append(state.x)
        forces.append(f)
        iters_l.append(iters)
        status_l.append(status)
    return dict(x=jnp.stack(xs), forces=jnp.stack(forces),
                iters=jnp.stack(iters_l), status=jnp.stack(status_l),
                mpc_ms=mpc_ms, prep_ms=prep_ms, tick_ms=tick_ms)
