"""Receding-horizon planar-quadrotor MPC with warm starting, 100 re-solves
(BASELINE config 4), on the PyTorch + CUDA port.

The port's counterpart of examples/quadrotor_mpc.py: ``run_mpc`` is the
closed loop (solve, apply the first control, advance the plant, shift the
solution into the next warm start).  On a GPU the Riccati kernels and, in
float32, the fused line-search probe run; on the CPU their plain twins do.

Run (GPU):  python examples/torch_quadrotor_mpc.py
Run (CPU):  python examples/torch_quadrotor_mpc.py --device cpu \
                --dtype float64
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

import sip_optimal_control_tpu_torch as soc
from sip_optimal_control_tpu_torch.models import planar_quadrotor
from sip_optimal_control_tpu_torch.solver.settings import LineSearchSettings

TARGET = (1.0, 1.5)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", choices=("float32", "float64"),
                        default="float32")
    parser.add_argument("--steps", type=int, default=100)
    args = parser.parse_args(argv)
    dtype = getattr(torch, args.dtype)

    spec, dims, topo, lower, upper, hover = planar_quadrotor(
        horizon=20, target=TARGET, dtype=dtype, device=args.device)
    x0 = torch.zeros(1, 6, dtype=dtype, device=args.device)
    x0[0, 0] = -0.5                         # start displaced, at rest

    common = dict(max_iterations=25, riccati_backend="cuda",
                  line_search=LineSearchSettings(fused_probe=True))
    settings = (soc.Settings(tol=1e-6, **common) if dtype == torch.float64
                else soc.Settings(tol=1e-3, mu_min=1e-5, reg_floor=1e-5,
                                  prox_reg=1e-5, **common))
    trace = soc.run_mpc(spec, dims, topo, x0, n_steps=args.steps,
                        settings=settings, lower=lower, upper=upper)

    states = trace.states[:, 0].cpu().numpy()
    iters = trace.iterations[:, 0].cpu().numpy()
    statuses = trace.statuses[:, 0].cpu().numpy()
    print(f"{args.steps} warm-started re-solves: all solved = "
          f"{bool(np.all(statuses == 0))}")
    # steady state: after the first fifth of the steps (20 of 100)
    print(f"mean iterations/solve {iters.mean():.2f} (first solve "
          f"{iters[0]}, steady-state {iters[len(iters) // 5:].mean():.2f} "
          "— warm starting pays)")
    err = np.linalg.norm(states[-1, :2] - np.array(TARGET))
    start = np.linalg.norm(states[0, :2] - np.array(TARGET))
    print(f"final position error {err:.4f} m (from {start:.4f}); "
          f"max |phi| {np.abs(states[:, 2]).max():.3f} rad")
    assert np.all(np.isfinite(states))
    assert err < start, "the closed loop did not approach the target"


if __name__ == "__main__":
    main()
