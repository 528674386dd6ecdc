"""Quadruped solver switching via a YAML controller config — the analog of
the reference's QuadrupedExample.ipynb workflow, which swaps MPC backends by
rewriting MPC.yaml. Run: python examples/quadruped_yaml.py
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import altro_mpc as at
from altro_mpc.models.quadruped import config, controller

YAML_TEMPLATE = """
N: 15
dynamics_discretization: 0.03
update_dt: 0.03
mu: 0.5
max_vert_force: 133.0
min_vert_force: 0.0
stance_height: 0.28
linearized_friction_constraint: {linearized}
solver: "{solver}"
gait:
  type: "trot"
  stance_time: 0.2
  swing_time: 0.2
swing:
  omega: 100.0
  zeta: 1.0
  step_height: 0.05
"""

BACKENDS = {"ALTRO": "altro", "OSQP": "admm_qp", "ECOS": "admm_conic"}


def run(solver: str, linearized: bool):
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        f.write(YAML_TEMPLATE.format(solver=solver,
                                     linearized=str(linearized).lower()))
        path = f.name
    cfg = config.mpc_config_from_yaml(path)
    os.unlink(path)

    opts = at.SolverOptions(penalty_initial=10.0, penalty_scaling=100.0,
                            reset_duals=False)
    res = controller.simulate(cfg, opts, tf=0.5,
                              backend=BACKENDS[cfg.solver])
    xs = np.asarray(res["x"])
    ok = bool(np.all(np.asarray(res["status"]) == 1))
    print(f"solver={cfg.solver:6s} linearized_friction={linearized}: "
          f"height {xs[-1, 2]:.3f} m, all solves ok: {ok}")


if __name__ == "__main__":
    run("ALTRO", True)
    run("OSQP", True)
    run("ALTRO", False)
    run("ECOS", False)
