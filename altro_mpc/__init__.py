"""altro_mpc — a batched conic MPC framework for accelerators.

A from-scratch JAX/XLA/Pallas rebuild of the capability surface of
RoboticExplorationLab/altro-mpc-icra2021: an augmented-Lagrangian iLQR solver
with second-order-cone constraint support, in-framework QP/conic ADMM baseline
solvers for cross-checking, a warm-started receding-horizon MPC engine, the
five benchmark plants, and batched/sharded scale-out over device meshes.
"""

from .cones import Cone
from .constraints import (
    ConicConstraint,
    DualState,
    QuadNormConstraint,
    bound_constraint,
    friction_cone,
    goal_constraint,
    linear_constraint,
    linearized_friction,
    norm_constraint,
    norm_constraint2,
    quad_norm_constraint,
)
from .costs import QuadCost, lqr_objective, retarget_tracking, tracking_objective
from .dynamics import (
    LTVDynamics,
    NonlinearDynamics,
    euler_discretize,
    lti_dynamics,
    rk4,
    zoh_discretize,
)
from .problem import Problem
from .solver.altro import Solution, Stats, check_status, print_summary, solve
from .solver.options import SolverOptions

__version__ = "0.1.0"
