"""Where one MPC step of the PyTorch port spends its time on the GPU.

Runs the cartpole MPC main path exactly as chip_smoke.py drives it (its
inputs and settings: horizon 50, batch 4096, float32, 5 fixed
interior-point trips per step, riccati_backend="cuda"), warms it up, then
traces a few steps with torch.profiler and prints the wall time per step,
the device's busy and idle share, and the kernels that take the most device
time.  Needs a CUDA GPU:

    python scripts/profile_torch_mpc.py [--steps 5]
"""

import argparse
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the main path's settings and inputs)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=5,
                        help="untimed warm-up and timed steps")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_mpc: needs a CUDA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    model, state = chip_smoke.main_path_inputs(device)

    def run(st, steps):
        out = chip_smoke.mpc_call(model, st, "cuda", steps)
        return (out.x, out.vars, out.y)

    state = run(state, args.steps)                 # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run(state, args.steps)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / args.steps
    traced = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = run(state, traced)
        torch.cuda.synchronize()
        traced_s = (time.perf_counter() - t0) / traced
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / traced / 1e3
    launches = sum(e.count for e in kernels) / traced
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    print(f"{torch.cuda.get_device_name(0)} ({smi}); batch "
          f"{chip_smoke.BATCH}")
    print(f"wall per MPC step: {step_s * 1e3:.2f} ms untraced (mean of "
          f"{args.steps}), {traced_s * 1e3:.2f} ms traced")
    print(f"device busy per step {busy_ms:.2f} ms over {launches:.0f} "
          f"kernel launches; idle share {1 - busy_ms / (step_s * 1e3):.3f} "
          f"of the untraced step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / traced / 1e3:8.3f} ms "
              f"{e.count / traced:7.0f}x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
