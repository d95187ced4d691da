"""Where one MPC step of the PyTorch port spends its time on the GPU.

Runs the cartpole MPC main path exactly as chip_smoke.py drives it (its
inputs and settings, chip_smoke.mpc_settings: horizon 50, batch 4096,
float32, 5 fixed interior-point trips per step, riccati_backend="cuda", the
fused line-search probe), then the same path with the standard probe in the
same process, so the two traces show what the probe kernel removed, then
chip_smoke's chain16 path (n=16, m=4, 2 trips per step), then its
robust_tree path (scenario-tree robust MPC on the standard iteration: the
tree LQR in plain PyTorch and the tree probe kernel) with the tree probe
and with the standard probe, then both chain paths on the fused whole
iteration (fused_iteration=True, the bench's default: the fused eval,
factor and solve kernels and the probe), then chip_smoke's phase 8
(quadrotor ``run_mpc``: convergence-tested re-solves on the Riccati
kernels and the probe, profiled in its warm steps 21 on) and phase 9
(the coupled joint-θ solve, S=4096, profiled per solve).  ``--model``
profiles one path only; ``--fused`` only the fused iteration's paths.
For each path:
warm-up, a timed untraced run, then a few steps under torch.profiler;
prints the wall time per step, the device's busy and idle share, the kernel
launches per step, on the standard iteration the LQR's share of the ops
dispatched (one launch each), and the kernels that take the most device
time.  Needs a CUDA GPU:

    python scripts/profile_torch_mpc.py [--steps 5] \
        [--model cartpole|chain16|robust_tree|quadrotor|joint_theta]
        [--fused]
"""

import argparse
import contextlib
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the main path's settings and inputs)
from sip_optimal_control_tpu_torch import mpc  # noqa: E402
from sip_optimal_control_tpu_torch.ops import kkt  # noqa: E402


class _OpCount(TorchDispatchMode):
    """Counts the non-view ATen ops dispatched (one kernel launch each, on
    the card), all of them and those inside ``ops.kkt``'s calls of the
    LQR factor and solve."""

    VIEWS = {"view", "expand", "select", "slice", "unsqueeze", "squeeze",
             "t", "transpose", "permute", "alias", "_unsafe_view",
             "as_strided", "detach", "diagonal", "split", "unbind",
             "reshape"}

    def __init__(self):
        super().__init__()
        self.total = self.lqr = 0
        self.in_lqr = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ not in self.VIEWS:
            self.total += 1
            self.lqr += self.in_lqr
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _lqr_counted(counter):
    """ops.kkt's LQR calls flagged for ``counter``.  (A profiler range
    would not do: its annotation on the device timeline spans the idle gaps
    and is summed with the kernels.)"""
    real = kkt.lqr_factor, kkt.lqr_solve

    def marked(fn):
        def call(*args, **kwargs):
            counter.in_lqr = True
            try:
                return fn(*args, **kwargs)
            finally:
                counter.in_lqr = False
        return call
    kkt.lqr_factor, kkt.lqr_solve = (marked(f) for f in real)
    try:
        yield
    finally:
        kkt.lqr_factor, kkt.lqr_solve = real


def profile_run(run, state, steps, label, unit="MPC step", traced=2,
                lqr_ops=True):
    """Warm-up and timed untraced `steps` of `run(state, n) -> state`, then
    `traced` more under torch.profiler.  Returns (state, untraced s per
    unit, busy ms per unit, launches per unit, the traced kernels) and
    prints the breakdown."""
    state = run(state, steps)                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run(state, steps)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
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
    print(f"[{label}] wall per {unit}: {step_s * 1e3:.2f} ms untraced "
          f"(mean of {steps}), {traced_s * 1e3:.2f} ms traced")
    print(f"[{label}] device busy per {unit} {busy_ms:.2f} ms over "
          f"{launches:.0f} kernel launches; idle share "
          f"{1 - busy_ms / (step_s * 1e3):.3f} of the untraced {unit}")
    if lqr_ops:
        # the ops the standard iteration's LQR dispatches in one more unit
        counter = _OpCount()
        with _lqr_counted(counter), counter:
            state = run(state, 1)
        print(f"[{label}] LQR factor + solve: {counter.lqr} of the "
              f"{counter.total} ops dispatched in a {unit} (one launch "
              "each)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / traced / 1e3:8.3f} ms "
              f"{e.count / traced:7.0f}x  {e.key[:90]}")
    # the port's own kernels: device time per launch, without the wrappers'
    # host work and layout copies
    for e in kernels:
        if e.key.startswith(("void riccati::", "void ls_probe::",
                             "void ls_probe_tree::", "void fused_iter::")):
            print(f"  [{label}] {e.key.split('(')[0][5:]}: "
                  f"{e.self_device_time_total / e.count / 1e3:.4f} ms per "
                  f"launch, {e.count / traced:.0f} launches per {unit}")
    return state, step_s, busy_ms, launches, kernels


def profile_quadrotor(device, steps, warm=20):
    """chip_smoke phase 8's closed loop (run_mpc's step function on its
    inputs and settings), profiled after `warm` untimed warm steps."""
    model, x0s = chip_smoke.quad_inputs(device)
    step, carry = mpc._closed_loop(*model[:3], x0s,
                                   chip_smoke.quad_settings("cuda"),
                                   *model[3:], None, True, True, 1e2)

    def run(c, n):
        for _ in range(n):
            c, _ = step(c)
        return c

    carry = run(carry, warm)
    profile_run(run, carry, steps, f"quadrotor run_mpc, steps {warm + 1} on")


def profile_joint_theta(device):
    """chip_smoke phase 9's coupled solve, one solve per unit."""
    model, x0s = chip_smoke.joint_inputs(device)

    def run(state, n):
        for _ in range(n):
            chip_smoke.joint_call(model, x0s, "cuda")
        return state

    profile_run(run, None, 1, "joint_theta", unit="solve", traced=1)


def profile_path(model, state, steps, fused_probe, fused=False):
    """Returns (state, untraced s per step, busy ms per step, launches per
    step) and prints the breakdown."""
    def run(st, n):
        out = chip_smoke.mpc_call(model, st, "cuda", n, fused_probe, fused)
        return (out.x, out.vars, out.y)

    probe = f"{model[0]}, " + ("fused iteration" if fused else
                               "fused probe" if fused_probe
                               else "standard probe")
    state, step_s, busy_ms, launches, _ = profile_run(
        run, state, steps, probe, lqr_ops=not fused)
    return state, step_s, busy_ms, launches


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=5,
                        help="untimed warm-up and timed steps")
    parser.add_argument("--model", choices=sorted(chip_smoke.PATHS) + [
                        "joint_theta", "quadrotor"], default=None,
                        help="profile this path only")
    parser.add_argument("--fused", action="store_true",
                        help="profile the fused iteration's paths only")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_mpc: needs a CUDA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    print(f"{torch.cuda.get_device_name(0)} ({smi}); batch "
          f"{chip_smoke.BATCH}")
    want = (lambda name: args.model in (None, name))
    for name in ("cartpole", "chain16", "robust_tree"):
        if args.fused or not want(name):
            continue
        model, state = chip_smoke.main_path_inputs(device, model=name)
        if name == "chain16":
            profile_path(model, state, args.steps, True)
            continue
        # the probe kernel, then the standard probe from where it ended
        results = {}
        for fused_probe in (True, False):
            state, *results[fused_probe] = profile_path(
                model, state, args.steps, fused_probe)
        (f_s, f_busy, f_n), (s_s, s_busy, s_n) = (results[True],
                                                  results[False])
        print(f"[{name}] the probe kernel removed {s_n - f_n:.0f} launches "
              f"and {s_busy - f_busy:.2f} ms of device time per MPC step; "
              f"the untraced step went from {s_s * 1e3:.2f} to "
              f"{f_s * 1e3:.2f} ms")
    for name in chip_smoke.CHAIN_PATHS:
        if want(name):
            model, state = chip_smoke.main_path_inputs(device, model=name)
            profile_path(model, state, args.steps, True, fused=True)
    if not args.fused and want("quadrotor"):
        profile_quadrotor(device, args.steps)
    if not args.fused and want("joint_theta"):
        profile_joint_theta(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
