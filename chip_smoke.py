#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (sip_optimal_control_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. Device: requires CUDA; prints the card and its power limit; TF32 off.
2. Build: compiles the CUDA Riccati kernels (csrc/) with nvcc.
3. Kernels: each kernel's wrapper against its plain PyTorch twin on the card,
   on random float32 chain data: the main-path shape (B=4096, T=50, n=4,
   m=1), a ragged batch (B=1000), the quadrotor shape (n=6, m=2) and a batch
   where one scenario has a non-PD R: factor products within
   rtol=atol=2e-4, solutions within 2e-3, statuses identical.  Then the
   main-path shape at the main path's first dual regularization delta and
   at delta=1e-7, where the bar is relative to a float64 twin (compare).
   Times from CUDA events after warm-up.
4. Main path: batched warm-started cartpole MPC (horizon 50, batch 4096,
   float32, Gauss-Newton, 5 fixed interior-point trips per step, filter line
   search probing 6 step sizes, riccati_backend="cuda"): 4 calls of 25
   steps.  Every kernel must have launched 5 x 100 times; usable_frac must
   reach 0.99; on 99% of the scenarios, step 1 must give the plain "scan"
   backend's status, iterate and KKT error within the stated bars.
5. The last line is the device record.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HORIZON, BATCH, TRIPS = 50, 4096, 5
CALLS, STEPS = 4, 25
FACTOR_TOL, SOLVE_TOL = 2e-4, 2e-3
# at the solver's small delta: the kernel's error against a float64 twin
# may be this many times the float32 twin's own (see compare)
COND_FACTOR = 4
QUALITY_USABLE = 0.99
SCAN_AGREEMENT = 0.99
# step 1 on the kernels vs the "scan" backend, per scenario (compare_step1).
# The kernels' explicit W and scan's W differ by float32 roundoff times the
# conditioning of delta ~ 1e-5: the plain twins against scan differ by
# 1.2e-2 (iterates) and 1.6e-2 (KKT error) at the 99th percentile (batch
# 512 on a CPU); the bars allow ~4x that.
ITER_TOL, KKT_RTOL = 5e-2, 5e-2


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# random chain data (as tests/test_pallas_riccati.py::random_chain_f32)
# ---------------------------------------------------------------------------

def random_chain(T, n, m, batch, seed, device):
    import torch
    from sip_optimal_control_tpu_torch import LQRData

    rng = np.random.default_rng(seed)

    def spd(count, d, base):
        s = 0.3 * rng.standard_normal((batch, count, d, d))
        return s @ np.swapaxes(s, -1, -2) + base * np.eye(d)

    arrays = dict(
        Q=spd(T + 1, n, 2.0), q=rng.standard_normal((batch, T + 1, n)),
        c=rng.standard_normal((batch, T + 1, n)),
        delta=0.5 + rng.random((batch, T + 1, n)),
        A=0.4 * rng.standard_normal((batch, T, n, n)),
        B=0.5 * rng.standard_normal((batch, T, n, m)),
        M=0.1 * rng.standard_normal((batch, T, n, m)),
        R=spd(T, m, 2.0), r=rng.standard_normal((batch, T, m)))
    return LQRData(**{k: torch.as_tensor(v.astype(np.float32), device=device)
                      for k, v in arrays.items()})


def compare(label, what, got, twin, tol, lanes, ref64=None):
    """Kernel outputs `got` against the float32 twin's `twin` (tuples of
    tensors) on the scenarios `lanes`; returns the largest |got - twin|.

    Without `ref64`: every entry within |got - twin| <= tol (1 + |twin|).
    With `ref64`, the twin run in float64 on the same inputs: the kernel's
    largest error against it is at most COND_FACTOR times the float32
    twin's own, plus tol.  That is the bar where delta is the solver's
    small dual regularization: there W = delta^-1/2 (I - F^-1) delta^-1/2
    cancels digits, so two float32 operation orders differ by the
    formulation's conditioning, not by a fixed tolerance."""
    import torch

    def worst(a, b):
        return float((a - b)[lanes].abs().max())

    diff = max(worst(a, b) for a, b in zip(got, twin))
    if ref64 is None:
        ok = all(bool(torch.all(((a - b).abs() <= tol * (1 + b.abs()))[lanes]))
                 for a, b in zip(got, twin))
        detail = ""
    else:
        e_k = max(worst(a.double(), r) for a, r in zip(got, ref64))
        e_t = max(worst(b.double(), r) for b, r in zip(twin, ref64))
        ok = e_k <= COND_FACTOR * e_t + tol
        detail = (f" (against float64: kernel {e_k:.3e}, twin {e_t:.3e}, "
                  f"bar {COND_FACTOR} x twin + {tol})")
    if not ok:
        raise AssertionError(f"{label}: {what} kernel off by {diff:.3e}"
                             f"{detail}")
    return diff, detail


def time_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: each kernel against its twin
# ---------------------------------------------------------------------------

def regularized_delta():
    """delta of the main path's first factorization: the dual
    regularization gamma_reg * mu_init + reg_floor (solver/sip.py)."""
    s = mpc_settings("cuda")
    return s.gamma_reg * s.mu_init + s.reg_floor


def check_kernels(device):
    import torch
    from sip_optimal_control_tpu_torch.ops import riccati_cuda as rc

    # label, B, n, m, (scenario, edge) with a non-PD R, constant delta
    cases = [("main", BATCH, 4, 1, None, None),
             ("ragged", 1000, 4, 1, None, None),
             ("quadrotor", 1000, 6, 2, None, None),
             ("failure", 256, 4, 1, (1, 20), None),
             ("delta_main_path", BATCH, 4, 1, None, regularized_delta()),
             ("delta_1e-7", BATCH, 4, 1, None, 1e-7)]
    records = {}
    for seed, (label, B, n, m, bad, delta) in enumerate(cases):
        data = random_chain(HORIZON, n, m, B, seed, device)
        if bad is not None:                   # non-PD R in one scenario
            R = data.R.clone()
            R[bad[0], bad[1]] = -torch.eye(m, device=device)
            data = dataclasses.replace(data, R=R)
        if delta is not None:
            data = dataclasses.replace(
                data, delta=torch.full_like(data.delta, delta))

        fact_k = rc.factor_chain_cuda(data)
        fact_t = rc.factor_chain_reference(data)
        if not torch.equal(fact_k.status, fact_t.status):
            raise AssertionError(f"{label}: factor statuses differ")
        ok_lanes = fact_t.status == 0
        if bad is not None and (bool(ok_lanes[bad[0]])
                                or int(ok_lanes.sum()) != B - 1):
            raise AssertionError(f"{label}: failure status not isolated")

        def check(what, wrapper, twin, args, tol):
            # at the solver's delta the bar is relative to the twin run in
            # float64 on the same float32 inputs
            ref64 = (None if delta is None
                     else twin(*(t.double() for t in args)))
            return compare(label, what, wrapper(*args), twin(*args), tol,
                           ok_lanes, ref64)

        fac_in = (data.Q, data.delta, data.A, data.B, data.M, data.R)
        f_err, f_det = check("factor", rc.factor_kernel,
                             rc.factor_kernel_reference, fac_in, FACTOR_TOL)
        bwd_in = (data.q, data.r, data.c, data.delta, fact_t.F_chol,
                  fact_t.G_chol, fact_t.K, data.A, data.B)
        b_err, b_det = check("solve_bwd", rc.solve_bwd_kernel,
                             rc.solve_bwd_kernel_reference, bwd_in,
                             SOLVE_TOL)
        k_t, v_t = rc.solve_bwd_kernel_reference(*bwd_in)
        v_full = torch.cat([v_t, data.q[:, -1:]], dim=1)
        x_root = torch.randn(B, n, device=device,
                             generator=torch.Generator(device).manual_seed(0))
        fwd_in = (x_root, k_t, fact_t.K, data.A, data.B, data.c, data.delta,
                  v_full, fact_t.V, fact_t.F_chol)
        w_err, w_det = check("solve_fwd", rc.solve_fwd_kernel,
                             rc.solve_fwd_kernel_reference, fwd_in,
                             SOLVE_TOL)

        sol_k = rc.solve_chain_cuda(data, fact_k)
        sol_t = rc.solve_chain_reference(data, fact_t)
        sol_64 = None
        if delta is not None:
            data64 = dataclasses.replace(data, **{
                f.name: getattr(data, f.name).double()
                for f in dataclasses.fields(data)})
            sol_64 = (rc.solve_chain_reference(
                data64, rc.factor_chain_reference(data64)).x,)
        s_err, s_det = compare(label, "chain solution", (sol_k.x,),
                               (sol_t.x,), SOLVE_TOL, ok_lanes, sol_64)
        dtxt = "" if delta is None else f" delta={delta:.4g}"
        log(f"kernels[{label}] B={B} T={HORIZON} n={n} m={m}{dtxt}: "
            f"max|kernel - twin| factor {f_err:.3e}{f_det} solve_bwd "
            f"{b_err:.3e}{b_det} solve_fwd {w_err:.3e}{w_det} chain x "
            f"{s_err:.3e}{s_det}; statuses identical "
            f"({int(ok_lanes.sum())}/{B} SUCCESS)")
        if label == "main":
            records = {"riccati_factor": (f_err, fac_in),
                       "riccati_solve_bwd": (b_err, bwd_in),
                       "riccati_solve_fwd": (w_err, fwd_in)}

    kernels = []
    for name, (err, args) in records.items():
        wrapper, twin, source, replaces = rc.KERNELS[name]
        ms = time_ms(lambda: wrapper(*args), reps=50)
        plain_ms = time_ms(lambda: twin(*args), reps=5, warmup=1)
        log(f"time[{name}] B={BATCH} T={HORIZON} n=4 m=1: kernel wrapper "
            f"{ms:.4f} ms, plain twin {plain_ms:.4f} ms")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})
    return kernels


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def mpc_settings(backend):
    from sip_optimal_control_tpu_torch import Settings
    from sip_optimal_control_tpu_torch.solver.settings import \
        LineSearchSettings
    return Settings(max_iterations=TRIPS, fixed_iterations=True,
                    mu_init=3e-3, tol=1e-3, mu_min=1e-5, reg_floor=1e-5,
                    prox_reg=1e-5, max_factor_retries=0,
                    riccati_backend=backend,
                    line_search=LineSearchSettings(
                        max_steps=6, chunk=6, use_filter_line_search=True))


def main_path_inputs(device, batch=BATCH):
    """The main path's model and MPC start state: cartpole h50 in float32
    on `device`; plant states jittered from the hanging start with seed 0
    (bench.py:923-926); warm start the constant trajectory at each state
    with zero duals.  Returns (model, state) as `mpc_call` takes them."""
    import torch
    from sip_optimal_control_tpu_torch import Primal, YVec
    from sip_optimal_control_tpu_torch.models import cartpole_swingup

    spec, dims, topo, lower, upper, x0 = cartpole_swingup(
        horizon=HORIZON, dtype=torch.float32, device=device)
    N, E = dims.num_nodes, dims.num_edges
    n, m = dims.max_state_dim, dims.max_control_dim
    rng = np.random.default_rng(0)
    x0s = np.tile(x0.cpu().numpy(), (batch, 1))
    x0s += 0.1 * rng.standard_normal((batch, n)).astype(np.float32)
    x = torch.as_tensor(x0s, device=device)
    wv = Primal(x=x[:, None].expand(batch, N, n).contiguous(),
                u=torch.zeros(batch, E, m, device=device),
                theta=torch.zeros(batch, 0, device=device))
    wy = YVec(dyn=torch.zeros(batch, N, n, device=device),
              nc=torch.zeros(batch, N, 0, device=device),
              ec=torch.zeros(batch, E, 0, device=device))
    return (spec, dims, topo, lower, upper), (x, wv, wy)


def mpc_call(model, state, backend, steps=STEPS):
    """One call of the main path: `steps` MPC steps from `state`."""
    from sip_optimal_control_tpu_torch import mpc_steps
    return mpc_steps(*model, mpc_settings(backend), *state, steps=steps,
                     hessian_mode="gauss_newton", noise=0.05)


def run_main_path(device, batch=BATCH, calls=CALLS, steps=STEPS):
    """The cartpole MPC workload; returns a dict of results."""
    import torch
    from sip_optimal_control_tpu_torch.ops import riccati_cuda as rc

    model, state = main_path_inputs(device, batch)
    step1 = {b: mpc_call(model, state, b, steps=1) for b in ("scan", "cuda")}
    scan_first = mpc_call(model, state, "scan", steps)
    rc.reset_launch_counts()
    outs, seconds = [], []
    for _ in range(calls):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = mpc_call(model, state, "cuda", steps)
        end.record()
        torch.cuda.synchronize()
        seconds.append((start.elapsed_time(end) / 1e3,
                        time.perf_counter() - t0))
        outs.append(out)
        state = (out.x, out.vars, out.y)
    launches = dict(rc.launch_counts)
    return dict(first=outs[0], last=outs[-1], scan_first=scan_first,
                step1=step1, launches=launches, seconds=seconds, batch=batch,
                steps=steps, calls=calls)


def compare_step1(step1):
    """Step 1 of the main path on the kernels against the plain twins
    ("scan"), lane by lane: statuses equal, the next warm start and plant
    state within ITER_TOL (1 + |scan|), the KKT error within KKT_RTOL
    relative.  Returns the share of scenarios where all of that holds."""
    import torch
    cu, sc = step1["cuda"], step1["scan"]

    def lane_err(a, b):
        return ((a - b).abs() / (1 + b.abs())).flatten(1).max(-1).values

    it_err = torch.stack([lane_err(cu.x, sc.x), lane_err(cu.vars.x, sc.vars.x),
                          lane_err(cu.vars.u, sc.vars.u)]).max(0).values
    kkt_err = ((cu.kkt_errors[0] - sc.kkt_errors[0]).abs()
               / sc.kkt_errors[0].abs())
    same = cu.statuses[0] == sc.statuses[0]
    close = same & (it_err <= ITER_TOL) & (kkt_err <= KKT_RTOL)
    q = torch.tensor([0.5, 0.99], device=it_err.device)
    iq, kq = it_err.quantile(q).tolist(), kkt_err.quantile(q).tolist()
    share = float(close.float().mean())
    log(f"step 1, cuda vs scan backend: statuses equal on "
        f"{float(same.float().mean()):.4f} of scenarios; iterate rel. diff "
        f"median {iq[0]:.3e} p99 {iq[1]:.3e} max {float(it_err.max()):.3e} "
        f"(bar {ITER_TOL}); KKT error rel. diff median {kq[0]:.3e} p99 "
        f"{kq[1]:.3e} max {float(kkt_err.max()):.3e} (bar {KKT_RTOL}); all "
        f"within bars on {share:.4f} (bar {SCAN_AGREEMENT})")
    return share


def quality(out):
    st = out.statuses
    kkt = out.kkt_errors
    usable = ((st == 0) | ((st == 1) & (kkt < 1e2))).float().mean()
    return dict(usable_frac=float(usable),
                solved_frac=float((st == 0).float().mean()),
                final_state_rms=float(out.x.pow(2).mean().sqrt()),
                mean_iterations=float(out.iterations.float().mean()))


def check_main_path(res):
    import torch
    expected = TRIPS * res["calls"] * res["steps"]
    for name, count in res["launches"].items():
        log(f"launches[{name}] = {count} (expected {expected})")
        if count != expected:
            raise AssertionError(f"{name}: {count} launches on the main "
                                 f"path, expected {expected}")
    last = res["last"]
    B = res["batch"]
    for out in (res["first"], last, res["scan_first"]):
        if tuple(out.statuses.shape) != (res["steps"], B):
            raise AssertionError(f"statuses shape {tuple(out.statuses.shape)}")
        if not (torch.isfinite(out.x).all() and torch.isfinite(out.vars.x)
                .all() and torch.isfinite(out.vars.u).all()):
            raise AssertionError("non-finite MPC state")
    agree = compare_step1(res["step1"])
    q_scan = quality(res["scan_first"])
    q_first = quality(res["first"])
    log(f"first call, cuda vs scan backend: usable "
        f"{q_first['usable_frac']:.4f} vs {q_scan['usable_frac']:.4f}, "
        f"final_state_rms {q_first['final_state_rms']:.4f} vs "
        f"{q_scan['final_state_rms']:.4f}")
    if agree < SCAN_AGREEMENT:
        raise AssertionError(f"step-1 agreement {agree} < {SCAN_AGREEMENT}")
    q = quality(last)
    log(f"timed call quality: {json.dumps(q)}")
    if q["usable_frac"] < QUALITY_USABLE:
        raise AssertionError(f"usable_frac {q['usable_frac']} < "
                             f"{QUALITY_USABLE}")
    return q


# ---------------------------------------------------------------------------

def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from sip_optimal_control_tpu_torch.ops import riccati_cuda as rc
    except ImportError as err:
        print(f"chip_smoke: the port package is missing ({err}); run from "
              "the repository root", file=sys.stderr)
        return 1

    # phase 1: device
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(smi)

    # phase 2: build
    path, build_s = rc.build_library()
    log(f"build: {path} in {build_s:.1f} s")

    # phase 3: kernels against their twins
    kernels = check_kernels(device)

    # phase 4: main path
    res = run_main_path(device)
    q = check_main_path(res)
    ev_s, host_s = res["seconds"][-1]
    solves = BATCH * STEPS
    per_call = ", ".join(f"{a:.3f}" for a, _ in res["seconds"])
    log(f"main path: {CALLS} calls x {STEPS} steps, batch {BATCH}; "
        f"seconds per call (CUDA events) [{per_call}]; last call "
        f"{ev_s:.3f} s events / {host_s:.3f} s host -> "
        f"{solves / ev_s:.1f} solves/s, {1e3 * ev_s / STEPS:.2f} ms per MPC "
        f"step, {1e3 * ev_s / (STEPS * TRIPS):.2f} ms per IPM trip")
    for k in kernels:
        k["launches"] = res["launches"][k["name"]]
    log(json.dumps({"main_path": {"solves_per_s": solves / ev_s,
                                  "step_ms": 1e3 * ev_s / STEPS, **q}}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
