"""Cartpole swing-up (BASELINE config 3) on the PyTorch + CUDA port: the
nominal start and a batch of perturbed starts, solved as one batch.

The port's counterpart of examples/cartpole_swingup.py, which solves the
nominal start alone and then vmaps over the batch.  Here every tensor
leads with the scenario axis, so scenario 0 (the nominal start) and the
perturbed starts are one call.  On a GPU the chain's Riccati kernels
(``riccati_backend="cuda"``) and, in float32, the fused line-search probe
run; on the CPU their plain twins do.

Run (GPU):  python examples/torch_cartpole_swingup.py
Run (CPU):  python examples/torch_cartpole_swingup.py --device cpu \
                --dtype float64
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

import sip_optimal_control_tpu_torch as soc
from sip_optimal_control_tpu_torch.models import cartpole_swingup
from sip_optimal_control_tpu_torch.solver.settings import LineSearchSettings


def settings_for(dtype):
    """fp64 reaches tight tolerances; fp32 needs barrier and
    regularization floors above single precision (as bench.py uses)."""
    common = dict(max_iterations=100, riccati_backend="cuda",
                  line_search=LineSearchSettings(fused_probe=True))
    if dtype == torch.float64:
        return soc.Settings(tol=1e-6, **common)
    return soc.Settings(tol=1e-3, mu_min=1e-5, reg_floor=1e-5,
                        prox_reg=1e-5, **common)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", choices=("float32", "float64"),
                        default="float32")
    parser.add_argument("--batch", type=int, default=64)
    # the swing-up is nonconvex in the horizon: 30 and 50 solve from the
    # cold start, most shorter horizons do not
    parser.add_argument("--horizon", type=int, default=50)
    args = parser.parse_args(argv)
    dtype = getattr(torch, args.dtype)

    spec, dims, topo, lower, upper, x0 = cartpole_swingup(
        horizon=args.horizon, dtype=dtype, device=args.device)
    settings = settings_for(dtype)

    # scenario 0 the nominal start, the others perturbed in position
    B = args.batch
    rng = np.random.default_rng(0)
    x0s = np.tile(x0.cpu().numpy(), (B, 1))
    x0s[1:, 0] += 0.1 * rng.standard_normal(B - 1)
    res = soc.solve(soc.build_problem(
        spec, dims, topo, torch.as_tensor(x0s, device=args.device), lower,
        upper), settings)

    u, xs = res.vars.u[0].cpu(), res.vars.x[0].cpu()
    print(f"nominal start: status={int(res.status[0])} "
          f"iters={int(res.iterations[0])} "
          f"kkt={float(res.kkt_error[0]):.2e}")
    print(f"  final angle {float(xs[-1, 2]):+.4f} rad (0 = upright), "
          f"|u| range [{float(u.min()):+.2f}, {float(u.max()):+.2f}] "
          "(limit 10)")
    print(f"batch of {B}: solved {int((res.status == 0).sum())}/{B}, "
          f"mean iterations {float(res.iterations.float().mean()):.1f}")
    assert int(res.status[0]) == soc.SIPStatus.SOLVED


if __name__ == "__main__":
    main()
