"""Coupled shared-parameter solve: S scenarios jointly optimizing one
global θ, on the PyTorch + CUDA port (the port's counterpart of
examples/joint_theta_estimation.py; the distributed form of the
reference's θ/Schur path, helpers.cpp:376-407).

Each scenario is a double-integrator chain from its own initial state;
every node cost pulls toward the SHARED setpoint θ, so the joint optimum
balances θ across all scenarios: a consensus/estimation pattern (e.g.
fitting one physical parameter against many trajectories).  The scenarios
are the batch of one coupled solve: the θ Schur complement and every
scalar coupling are summed over them inside each interior-point iteration
(over the ranks too, when a scenario mesh is given: see
examples/torch_robust_mpc_sharded.py).

float64 throughout: the example asks for tol=1e-10 (float32 stalls near
1e-6 and the SOLVED assertion below would fail).

Run (GPU):  python examples/torch_joint_theta_estimation.py
Run (CPU):  python examples/torch_joint_theta_estimation.py --device cpu
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

import sip_optimal_control_tpu_torch as soc
from sip_optimal_control_tpu_torch.models import shared_theta_chain


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    spec, dims, topo, lower, upper = shared_theta_chain(
        horizon=20, dtype=torch.float64, device=args.device)
    S = 8
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(rng.standard_normal((S, 2)), device=args.device)
    settings = soc.Settings(max_iterations=60, tol=1e-10)

    res = soc.solve_joint_theta(spec, dims, topo, x0s, settings,
                                lower=lower, upper=upper)
    statuses = res.status.cpu().numpy()
    theta = res.vars.theta.cpu().numpy()
    print(f"statuses: {statuses} (0 = SOLVED)")
    print(f"shared theta* = {theta[0, 0]:.6f} (bit-identical on every "
          f"scenario: {bool(np.all(theta == theta[0]))})")
    # each scenario alone would prefer a different θ: the joint solve is a
    # genuine compromise
    for s in range(3):
        solo = soc.solve(soc.build_problem(spec, dims, topo, x0s[s:s + 1],
                                           lower, upper), settings)
        print(f"  scenario {s} alone would pick theta = "
              f"{float(solo.vars.theta[0, 0]):.6f}")
    assert np.all(statuses == 0)


if __name__ == "__main__":
    main()
