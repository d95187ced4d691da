#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (sip_optimal_control_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. Device: requires CUDA; prints the card and its power limit; TF32 off.
2. Build: compiles, all at once, the CUDA Riccati kernels (csrc/riccati.cu),
   the fused line-search probe generated for each chain path's model and
   for phase 8's quadrotor (ops/ls_probe.py), the tree probe generated for robust_tree
   (csrc/ls_probe_tree.cuh) and the four whole-iteration kernels
   generated for cartpole, chain16 and the quadrotor (ops/fused_iter.py),
   one nvcc per library;
   prints each kernel's registers and spills.
3. Kernels: each kernel's wrapper against its plain PyTorch twin on the
   card.  Riccati kernels on random float32 chain data: the cartpole shape
   (B=4096, T=50, n=4, m=1), a ragged batch (B=1000), the quadrotor shape
   (n=6, m=2) and a batch where one scenario has a non-PD R; the same at the
   chain16 shape (n=16, m=4, the Gram-form factor): factor products within
   rtol=atol=2e-4, solutions within 2e-3, statuses identical.  Then both
   shapes at the paths' first dual regularization delta and at delta=1e-7,
   where the bar is relative to a float64 twin (compare) and the kernel may
   fail only where the float32 twin fails; the chains (8, 3) and (16, 5) at
   B=1000 (the team kernels where m * m exceeds the team's lanes).  Every
   Riccati kernel's launch configuration and ptxas line at every shape it
   is instantiated at, and its device time per launch.  The probe for
   both models at B=4096 with 6 candidates, some of them infeasible, the
   candidates contiguous and as the solver's transposed view, and at a
   ragged B=1000 (transposed): -inf patterns identical, finite entries
   within 2e-5 relative; its launch configuration, ptxas line and device
   time per launch.  The tree probe the same way on robust_tree (horizon
   50: 51 nodes, 50 edges) at B=4096 in both layouts and at a ragged
   B=1000 (transposed), with its launch configuration, ptxas line and
   device time per launch.  The four
   fused kernels on cartpole, quadrotor (exact) and chain16 at B=4096,
   T=50 against their twins (FACTOR_TOL, SOLVE_TOL, statuses identical,
   the Newton step at the solver's delta under compare's rule), with the
   factor's and eval's launch configuration, ptxas line and wrapper time
   less device time.
   Times from CUDA events after warm-up, beside each kernel's bound;
   device times from torch.profiler, each session's count of a kernel's
   records held to the launches its counter saw (profiled again on a
   mismatch).
4. Cartpole path: batched warm-started cartpole MPC (horizon 50, batch
   4096, float32, Gauss-Newton, 5 fixed interior-point trips per step,
   filter line search probing 6 step sizes through the fused probe,
   riccati_backend="cuda"): 4 calls of 25 steps.  Every Riccati kernel of
   the explicit-W form and the probe must have launched 5 x 100 times;
   usable_frac must reach 0.99; on 99% of the scenarios, step 1 must give
   the plain "scan" backend's (standard probe) status, iterate and KKT
   error within the stated bars.  A 25-step call with the standard probe
   before the fused calls and one after, timed, say what the probe kernel
   changed.
5. chain16 path: the same at n=16, m=4 with 2 trips per step
   (bench.py --model chain16): 2 calls of 25 steps; the Gram factor,
   solve_bwd, solve_fwd and the probe each launch 2 x 50 times;
   usable_frac >= 0.99; step 1 against "scan" with the standard probe on
   99% of the scenarios, within the bars of compare_step1, which also runs
   step 1 on "scan" in float64 to bound how often float32 roundoff may
   flip a scenario's barrier-parameter decision.
6. Fused paths: the same two MPC paths with fused_iteration=True (the
   bench's default, bench.py:768): cartpole K=5 and chain16 K=2, as many
   calls of 25 steps as phases 4-5; fused factor, solve_bwd, solve_fwd
   and the probe launch once per trip, the eval kernel once more per
   solve, no Riccati kernel; usable_frac >= 0.99; step 1 against "scan"
   with the standard probe under compare_step1's rules; the first call's
   quality beside the same "scan" call as phases 4-5's.
7. robust_tree path: scenario-tree robust MPC (bench.py --model
   robust_tree: 2 shared edges and 4 branches of 12, n=2, m=1, batch 4096,
   float32, Gauss-Newton, 2 fixed trips, rti_freeze_ev=False) on the
   standard iteration, whose trees take the level-synchronous LQR of
   ops/lqr.py (no Riccati kernel) and the tree probe kernel: 25 warm steps,
   then 2 timed calls of 25 steps; the tree probe launches once per trip
   and no other kernel launches; usable_frac >= 0.99; step 1 against
   "scan" with the standard probe under compare_step1's rules.
Every path logs usable_frac and solved_frac of each timed call; the gate
reads the last.  A kernel's bound counts the bytes it reads and writes
(fused_bytes for the fused kernels) and its operations.
8. Quadrotor run_mpc (BASELINE config 4, examples/quadrotor_mpc.py):
   planar_quadrotor(horizon=20, target=(1.0, 1.5)), float32, B=4096
   starts x0 = (-0.5, 0, ...) jittered with seed 0, 100 warm-started
   re-solves through the package's run_mpc with the example's float32
   settings (25 iterations, tol 1e-3, convergence-tested, 3 factor
   retries, Armijo over 10 candidates one at a time), riccati_backend=
   "cuda" and the fused probe.  First the factor, both solve kernels and
   the probe at the path's shape against their twins, timed beside twin
   and bound.  Step 1 against "scan" with the standard probe under
   compare_step1's rule (the next plant state and applied control within
   1e-2 (1 + |scan|)); usable on >= 0.99 of the (step, scenario) pairs;
   launches as solver_launches predicts from the trips (each step's
   largest iteration count): factor 4 per trip, each solve 1, the probe
   10; solves/s from CUDA events; then run_mpc_timed at a quarter of the
   run's host time must stop early with run_mpc's statuses and states.
9. Joint theta (bench.py --mode joint-theta): shared_theta_chain(horizon=
   50), S=4096 coupled scenarios from standard normal starts (seed 0,
   float32), the bench's settings, riccati_backend="cuda": the three
   Riccati kernels at (2, 1) against their twins and timed; one warm-up
   call, which must be SOLVED on every scenario with theta bit-identical
   on all of them and theta and the controls within compare's rule of
   the same coupled solve on "scan" in float64 (4x the float32 "scan"
   solve's own error); then 5 timed calls whose launches must equal
   solver_launches' count (per trip: 4 factorizations, each with one
   theta-column solve, and one solve); best call -> coupled scenarios/s.
   Phases 8 and 9 print their numbers beside the card's nvidia-smi line.
10. Variable dimensions and general constraints (BASELINE config 2).
   (a) Random float32 chain data (B=4096, T=50) at (n_max, m_max) =
   (3, 2), node k with 1 + (k mod 3) states and edge e with 1 + (e mod 2)
   controls, padded by pad_lqr_data and factored and solved on "scan"
   and "cuda": statuses identical, the dead entries of x, u and y exactly
   0 on both backends, the solutions under compare's rule against
   float64 "scan", residuals logged; the Riccati kernels at (3, 2) against
   their twins on the padded data, timed, with launch configuration and
   ptxas line.  (b) tests/test_variable_dims_frontdoor.py's stage-varying
   constraints at horizon 50 (velocity cap at node 2, final position
   pinned at 0.5, |u| <= 20) and (c) its growing state at horizon 50 (2
   states before node 25, 3 from there: the kernels at padded (3, 1)),
   each from B=4096 starts (0, 0) jittered with seed 0, float32, "cuda",
   convergence-tested (80 iterations, tol 1e-3): SOLVED on >= 0.99, on
   those the cap and bounds (and the pin within 1e-3), controls within
   1e-2 (1 + |ref|) of the same batch on float64 "scan" on >= 0.99, the
   dead third state exactly 0, launches as solver_launches counts, the
   kernels at the path's shape timed.  (d) The constrained result saved
   by save_warm_start and loaded onto the card: a warm re-solve from it
   equals the one from the tensors in memory bit for bit.  (e) The
   derivative-check channel on the constrained problem at B=1, float64:
   its four errors < 1e-6.
11. Scenario sharding (BASELINE config 5, bench.py --mode scaling):
   robust_tree h50 (main_path_inputs), B=4096 cold starts jittered by 0.05
   with seed 0, float32, the scaling mode's settings (100 convergence-
   tested iterations, tol 1e-3, float32 floors) with the tree probe on 6
   candidates a chunk.  (a) solve_batch_sharded over NCCL with a world of
   1 in this process: controls and statuses bit-identical to solve on the
   same batch (both in PyTorch's deterministic mode), the statistics equal
   to the host's reductions, usable on >= 0.99, the tree probe's launches
   > 0 and equal to solve's.  (b) 4 gloo ranks on the one card (NCCL
   refuses two ranks on one device), each a process of its own that loads
   the libraries phase 2 built and solves its 1024 rows: statuses equal to
   (a)'s rows and controls within 1e-2 (1 + |ref|) on >= 0.99 of the
   scenarios, every rank's statistics identical, the solved count the
   ranks' sum.  (c) phase 9's joint-θ problem (S=4096) as one coupled
   solve over the same 4 ranks, 1024 scenarios each: θ, status and
   iterations bit-identical on every rank, θ and the controls within
   phase 9's bar against float64 "scan", each rank's Riccati launches
   solver_launches' count.  ms per solve logged for each, not gated; every
   process group has a 60 s timeout.
12. The kernels line gives the Riccati kernels and the chain probe a
   record at the shapes of phases 8, 9 and 10 with those paths' launches,
   and every kernel phase 11's launches ((a), and (b) and (c) by rank);
   the last line is the device record.

`python3 chip_smoke.py --shard-worker RANK WORLD STORE OUT_DIR` is one rank
of phase 11(b)-(c); phase 11 starts them itself.
"""

import concurrent.futures
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HORIZON, BATCH, STEPS = 50, 4096, 25
# per path: (n, m), fixed interior-point trips per MPC step
# (bench.py:845-846), timed calls of STEPS steps
# and the step-1 iterate bar (compare_step1)
PATHS = {"cartpole": dict(nm=(4, 1), trips=5, calls=4, steps=STEPS,
                          iter_tol=5e-2),
         "chain16": dict(nm=(16, 4), trips=2, calls=2, steps=STEPS,
                         iter_tol=1e-2),
         # bench.py --model robust_tree: K=2 (bench.py:845), 25 untimed
         # steps on the kernels before the timed calls
         "robust_tree": dict(nm=(2, 1), trips=2, calls=2, steps=STEPS,
                             iter_tol=1e-2, warm=STEPS)}
# the chain paths, which run on both iterations; trees take the standard one
CHAIN_PATHS = ("cartpole", "chain16")
# JAX's converged-controller rms floor of robust_tree, a TPU figure
# (bench.py:1167), logged beside the port's
JAX_TPU_RMS_FLOOR = {"robust_tree": 0.152}
# the fused kernels' check (phase 3): model, Hessian mode
FUSED_MODELS = {"cartpole": "gauss_newton", "quadrotor": "exact",
                "chain16": "gauss_newton"}
CHUNK = 6                       # line-search candidates probed per trip
FACTOR_TOL, SOLVE_TOL = 2e-4, 2e-3
PROBE_TOL = 2e-5                # relative, tests/test_pallas_ls.py:60-67
# at the solver's small delta: the kernel's error against a float64 twin
# may be this many times the float32 twin's own (see compare)
COND_FACTOR = 4
QUALITY_USABLE = 0.99
# phase 8's gate over its (step, scenario) pairs
QUAD_USABLE = 0.99
SCAN_AGREEMENT = 0.99
# step 1 on the kernels vs the "scan" backend, per scenario (compare_step1).
# The kernels' explicit W and scan's W differ by float32 roundoff times the
# conditioning of delta ~ 1e-5: the plain twins against scan differ by
# 1.2e-2 (iterates) and 1.6e-2 (KKT error) at the 99th percentile (cartpole,
# batch 512 on a CPU); the bars allow ~4x that.  chain16's twins against
# scan: iterates 2.6e-3 at the 99th percentile (batch 256 on a CPU), hence
# its iter_tol of 1e-2; KKT error 1.5e-2 where both ended at the same
# barrier parameter mu (batch 512 on a CPU).
KKT_RTOL = 5e-2
# the H100 SXM's published peaks: float32 outside the tensor cores, device
# memory bandwidth
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


_T0 = time.perf_counter()


def log(msg):
    print(msg, flush=True)


def phase_done(name):
    log(f"phase {name} done at {time.perf_counter() - _T0:.1f} s")


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
        # spectral radius ~0.8 at every n (0.4 at n=4 as before)
        A=0.8 / math.sqrt(n) * rng.standard_normal((batch, T, n, n)),
        B=0.5 * rng.standard_normal((batch, T, n, m)),
        M=0.1 * rng.standard_normal((batch, T, n, m)),
        R=spd(T, m, 2.0), r=rng.standard_normal((batch, T, m)))
    return LQRData(**{k: torch.as_tensor(v.astype(np.float32), device=device)
                      for k, v in arrays.items()})


def compare(label, what, got, twin, tol, lanes, ref64=None, lanes_k=None):
    """Kernel outputs `got` against the float32 twin's `twin` (tuples of
    tensors) on the scenarios `lanes`; returns the largest |got - twin|.

    Without `ref64`: every entry within |got - twin| <= tol (1 + |twin|).
    With `ref64`, the twin run in float64 on the same inputs: the kernel's
    largest error against it, on the scenarios `lanes_k` (default `lanes`),
    is at most COND_FACTOR times the float32 twin's own on `lanes`, plus
    tol.  That is the bar where delta is the solver's
    small dual regularization: there W = delta^-1/2 (I - F^-1) delta^-1/2
    (and the Gram form's Ah^T Ah - Za^T Za) cancels digits, so two float32
    operation orders differ by the formulation's conditioning, not by a
    fixed tolerance."""
    import torch

    def worst(a, b):
        return float((a - b)[lanes].abs().max())

    diff = max(worst(a, b) for a, b in zip(got, twin))
    if ref64 is None:
        ok = all(bool(torch.all(((a - b).abs() <= tol * (1 + b.abs()))[lanes]))
                 for a, b in zip(got, twin))
        detail = ""
    else:
        kl = lanes if lanes_k is None else lanes_k
        e_k = max(float((a.double() - r)[kl].abs().max())
                  for a, r in zip(got, ref64))
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
# bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

def _riccati_flops(name, n, m):
    """Floating-point operations per scenario and edge of each Riccati
    kernel, counted from csrc/riccati.cu (a multiply-add is 2; Cholesky
    n^3/3, a triangular solve with c columns c n^2)."""
    if name == "riccati_factor":
        # F, chol, F^-1 (2 triangular solves of n columns), W, B^T W, G,
        # chol G, W A, H, K (2 solves of n columns), V = Q + A^T W A + K^T H
        return (3 * n * n + n ** 3 / 3 + 2 * n ** 3 + 3 * n * n
                + 2 * m * n * n + 2 * m * m * n + m ** 3 / 3 + 2 * n ** 3
                + 2 * m * n * n + 2 * n * m * m + 2 * n ** 3 + 2 * m * n * n
                + 2 * n * n)
    if name == "riccati_factor_gram":
        # F, chol, Ah and Bh, Za and Zb (triangular solves), G (upper
        # triangle), chol G, H, K, V (upper triangle: A^T A - Za^T Za + K^T H)
        return (3 * n * n + n ** 3 / 3 + n * n + n * m + n ** 3 + m * n * n
                + 2 * m * (m + 1) * n + m ** 3 / 3 + 4 * m * n * n
                + 2 * n * m * m + n * (n + 1) / 2 * (4 * n + 2 * m))
    if name == "riccati_solve_bwd":
        # W f through two triangular solves, h = r + B^T g, k, v update
        return (6 * n + 2 * n * n + 2 * m * n + 2 * m * m + 2 * n * n
                + 2 * m * n + 2 * n)
    if name == "riccati_solve_fwd":
        # u = k + K x, A x + B u + c - delta v, two triangular solves, y
        return 2 * m * n + 2 * n * n + 2 * m * n + 4 * n + 2 * n * n \
            + 2 * n * n
    raise KeyError(name)


def probe_flops(spec, bounds):
    """Operations per (scenario, candidate) of the probe kernel: the
    candidate points, each stage's generated programs (one operation per
    scalar instruction, a transcendental counted as one), the L1
    infeasibility and the finite bounds' log terms."""
    T, n, m = spec.horizon, spec.n, spec.m
    finite = sum(int(np.isfinite(b).sum()) for b in bounds)
    per_stage = (len(spec.dyn_prog.instrs) + len(spec.ncost_prog.instrs)
                 + len(spec.ecost_prog.instrs) + 2 * (n + m) + 3 * n + 4)
    return T * per_stage + len(spec.ncost_prog.instrs) + 5 * n \
        + 3 * finite * (T + 1)


def probe_tree_flops(spec, bounds):
    """Operations per (scenario, candidate) of the tree probe kernel: every
    node's and edge's candidate point, each stage's baked programs (one
    operation per scalar instruction, a transcendental counted as one), the
    L1 infeasibility of every edge and the root row, and the finite
    bounds' log terms."""
    N, E, n, m = spec.num_nodes, len(spec.parents), spec.n, spec.m
    lb_u, ub_u, lb_x, ub_x = bounds
    finite_u = int(np.isfinite(lb_u).sum() + np.isfinite(ub_u).sum())
    finite_x = int(np.isfinite(lb_x).sum() + np.isfinite(ub_x).sum())
    progs = sum(len(p.instrs) for group in (spec.node_progs,
                                            spec.ecost_progs,
                                            spec.dyn_progs) for p in group)
    return (2 * (N * n + E * m) + progs + 3 * n * (E + 1) + 2 * (N + E)
            + 3 * (finite_u * E + finite_x * N))


def bound(inputs, outputs, flops, nbytes=None):
    """(bound_ms, bound_by): the larger of the bytes each input and output
    must move once (``nbytes``, else every element of ``inputs`` and
    ``outputs``) over the memory rate and the operations over the float32
    peak."""
    if nbytes is None:
        nbytes = sum(t.numel() * t.element_size() for t in inputs + outputs)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_record(name, err, fn, twin, args, flops, source, replaces):
    """Times the kernel wrapper and its twin on `args`; the bound from the
    wrapper's inputs and outputs."""
    outs = fn(*args)
    ms = time_ms(lambda: fn(*args), reps=50)
    plain_ms = time_ms(lambda: twin(*args), reps=5, warmup=1)
    bound_ms, bound_by = bound(list(args), list(outs), flops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# ---------------------------------------------------------------------------
# phase 3: each kernel against its twin
# ---------------------------------------------------------------------------

# each Riccati kernel's name in the profiler and in ptxas's log
RICCATI_NAMES = {"riccati_factor": "factor_kernel",
                 "riccati_factor_gram": "factor_gram_kernel",
                 "riccati_solve_bwd": "solve_bwd_kernel",
                 "riccati_solve_fwd": "solve_fwd_kernel"}


def regularized_delta(model="cartpole"):
    """delta of a path's first factorization: the dual regularization
    gamma_reg * mu_init + reg_floor (solver/sip.py)."""
    s = mpc_settings("cuda", model=model)
    return s.gamma_reg * s.mu_init + s.reg_floor


def check_riccati(device):
    """Riccati kernels against their twins; returns the timing records:
    cartpole shape for every kernel, chain16 shape for the solve kernels
    under "chain16" and for the Gram factor.  Logs every kernel's launch
    configuration and ptxas line at every shape it is instantiated at, and
    each record's device ms per launch."""
    import torch
    from sip_optimal_control_tpu_torch.ops import riccati_cuda as rc

    # label, B, n, m, (scenario, edge) with a non-PD R, constant delta
    cases = [("main", BATCH, 4, 1, None, None),
             ("ragged", 1000, 4, 1, None, None),
             ("quadrotor", 1000, 6, 2, None, None),
             ("failure", 256, 4, 1, (1, 20), None),
             ("delta_main_path", BATCH, 4, 1, None, regularized_delta()),
             ("delta_1e-7", BATCH, 4, 1, None, 1e-7),
             ("chain16", BATCH, 16, 4, None, None),
             ("chain16_ragged", 1000, 16, 4, None, None),
             ("chain16_failure", 256, 16, 4, (1, 20), None),
             ("chain16_delta_path", BATCH, 16, 4, None,
              regularized_delta("chain16")),
             ("chain16_delta_1e-7", BATCH, 16, 4, None, 1e-7),
             # the team kernels where m * m exceeds the team's lanes and
             # n + m two columns per lane
             ("chain8x3", 1000, 8, 3, None, None),
             ("chain16x5", 1000, 16, 5, None, None)]
    records = {}
    for seed, (label, B, n, m, bad, delta) in enumerate(cases):
        data = random_chain(HORIZON, n, m, B, seed, device)
        if bad is not None:                   # non-PD R in one scenario
            R = data.R.clone()
            R[bad[0], bad[1]] = -100.0 * torch.eye(m, device=device)
            data = dataclasses.replace(data, R=R)
        if delta is not None:
            data = dataclasses.replace(
                data, delta=torch.full_like(data.delta, delta))

        fact_k = rc.factor_chain_cuda(data)
        fact_t = rc.factor_chain_reference(data)
        ok_k, ok_t = fact_k.status == 0, fact_t.status == 0
        fail_k, fail_t = B - int(ok_k.sum()), B - int(ok_t.sum())
        same = float((fact_k.status == fact_t.status).float().mean())
        # at a small delta float32 loses the factor by cancellation in some
        # scenarios (G or F turns indefinite), and which ones depends on
        # roundoff: where the float32 twin fails somewhere, the kernel may
        # fail only where the twin fails too; elsewhere statuses are equal
        if delta is not None and fail_t > 0:
            if bool((ok_t & ~ok_k).any()):
                raise AssertionError(
                    f"{label}: the kernel fails on {int((ok_t & ~ok_k).sum())}"
                    " scenarios where the float32 twin succeeds")
        elif same < 1.0:
            raise AssertionError(f"{label}: factor statuses differ (kernel "
                                 f"{fail_k} failures, twin {fail_t})")
        ok_lanes = ok_t & ok_k
        if bad is not None and (bool(ok_lanes[bad[0]])
                                or int(ok_lanes.sum()) != B - 1):
            raise AssertionError(f"{label}: failure status not isolated")
        # at the solver's delta: a float64 twin on the same inputs; the
        # kernel's factor and chain solution are held against it wherever
        # the kernel and the float64 twin succeed, the twin's own error on
        # the scenarios where it succeeds too
        lanes_k = ok_lanes
        if delta is not None:
            data64 = dataclasses.replace(data, **{
                f.name: getattr(data, f.name).double()
                for f in dataclasses.fields(data)})
            fact_64 = rc.factor_chain_reference(data64)
            ok_lanes = ok_lanes & (fact_64.status == 0)
            lanes_k = ok_k & (fact_64.status == 0)

        def check(what, wrapper, twin, args, tol, kernel_lanes=None):
            # at the solver's delta the bar is relative to the twin run in
            # float64 on the same float32 inputs
            ref64 = (None if delta is None
                     else twin(*(t.double() for t in args)))
            return compare(label, what, wrapper(*args), twin(*args), tol,
                           ok_lanes, ref64, kernel_lanes)

        factor = ("riccati_factor_gram" if n >= rc.GRAM_N
                  else "riccati_factor")
        fac_in = (data.Q, data.delta, data.A, data.B, data.M, data.R)
        f_err, f_det = check(factor, *rc.KERNELS[factor][:2], fac_in,
                             FACTOR_TOL, lanes_k)
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
        sol_64 = (None if delta is None else
                  (rc.solve_chain_reference(data64, fact_64).x,))
        s_err, s_det = compare(label, "chain solution", (sol_k.x,),
                               (sol_t.x,), SOLVE_TOL, ok_lanes, sol_64,
                               lanes_k)
        dtxt = "" if delta is None else (
            f" delta={delta:.4g} (kernel held on {int(lanes_k.sum())}, "
            f"twin on {int(ok_lanes.sum())} of {B} scenarios)")
        log(f"kernels[{label}] B={B} T={HORIZON} n={n} m={m}{dtxt}: "
            f"max|kernel - twin| {factor} {f_err:.3e}{f_det} solve_bwd "
            f"{b_err:.3e}{b_det} solve_fwd {w_err:.3e}{w_det} chain x "
            f"{s_err:.3e}{s_det}; statuses identical on {same:.4f} "
            f"(kernel {B - fail_k}/{B} SUCCESS, twin {B - fail_t}/{B})")
        if label in ("main", "chain16"):
            records[label] = {factor: (f_err, fac_in),
                              "riccati_solve_bwd": (b_err, bwd_in),
                              "riccati_solve_fwd": (w_err, fwd_in)}

    lib = rc.build_library()[0]
    for n, m in sorted(rc.SUPPORTED_SHAPES):
        for name in rc.TEAM_KERNELS:
            cfg = rc.launch_config(rc._library(), name, n, m, BATCH)
            if cfg["grid"]:
                entry = f"{RICCATI_NAMES[name]}ILi{n}ELi{m}E"
                log(f"launch[{name} ({n}, {m})] B={BATCH}: {json.dumps(cfg)}"
                    f"; ptxas {ptxas_line(lib, entry)}")
    out = {}
    for label, recs in records.items():
        n, m = (4, 1) if label == "main" else (16, 4)
        dev = kernel_device_ms([lambda fn=rc.KERNELS[name][0], args=args:
                                fn(*args) for name, (_, args) in recs.items()],
                               "void riccati::",
                               {name: RICCATI_NAMES[name] for name in recs})
        for name, (err, args) in recs.items():
            fn, twin, source, replaces = rc.KERNELS[name]
            rec = kernel_record(name, err, fn, twin, args,
                                BATCH * HORIZON * _riccati_flops(name, n, m),
                                source, replaces)
            rec["device_ms"] = dev[RICCATI_NAMES[name]]
            log(f"time[{name}] B={BATCH} T={HORIZON} n={n} m={m}: kernel "
                f"wrapper {rec['ms']:.4f} ms, device {rec['device_ms']:.4f} "
                f"ms per launch (wrapper - device "
                f"{rec['ms'] - rec['device_ms']:.4f} ms), plain twin "
                f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']})")
            if name in out:
                out[name]["chain16"] = rec
            else:
                out[name] = rec
    return out


def path_problem(model, device, batch=BATCH):
    """A path's model at the main-path batch and its problem, for the
    probe's spec and bounds."""
    from sip_optimal_control_tpu_torch import build_problem
    (_, spec, dims, topo, lower, upper), (x, _, _) = main_path_inputs(
        device, batch, model)
    prob = build_problem(spec, dims, topo, x, lower, upper,
                         hessian_mode="gauss_newton")
    if prob.fused_ls is None:
        raise AssertionError(f"{model}: not eligible for the fused probe")
    return prob, dims


def probe_inputs(dims, batch, seed, device):
    """Random probe inputs (as tests/test_pallas_ls.py): iterate, direction,
    root state, candidates; the first eighth of the scenarios' controls
    scaled by 20 so their candidates violate the control bounds."""
    import torch
    rng = np.random.default_rng(seed)
    N, E = dims.num_nodes, dims.num_edges
    n, m = dims.max_state_dim, dims.max_control_dim

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    u = 0.3 * rng.standard_normal((batch, E, m))
    u[:batch // 8] *= 20.0
    return (t(rng.standard_normal((batch, N, n))),
            t(0.1 * rng.standard_normal((batch, N, n))), t(u),
            t(0.1 * rng.standard_normal((batch, E, m))),
            t(rng.standard_normal((batch, n))),
            t(0.3 * rng.random((batch, CHUNK))))


def probe_match(label, got, want):
    """A probe kernel's (f, theta, logb) against its twin's: -inf patterns
    identical, finite entries within PROBE_TOL relative.  Returns the
    largest absolute difference on finite entries."""
    import torch
    err = 0.0
    for what, a, b in zip(("f", "theta", "logb"), got, want):
        if not torch.equal(torch.isneginf(a), torch.isneginf(b)):
            raise AssertionError(f"{label}: {what} -inf pattern differs")
        fin = torch.isfinite(b)
        if not bool(fin.any()) or not bool(torch.isfinite(a[fin]).all()):
            raise AssertionError(f"{label}: {what} not finite")
        rel = float(((a - b).abs() / (1 + b.abs()))[fin].max())
        if rel > PROBE_TOL:
            raise AssertionError(f"{label}: {what} off by {rel:.3e} "
                                 f"relative (bar {PROBE_TOL})")
        err = max(err, float((a - b)[fin].abs().max()))
    return err


def check_probe(device):
    """The probe kernel against its twin for both paths' models at the main
    path's batch (the candidates contiguous, then as the solver's
    transposed view) and at a ragged batch (B=1000, transposed); logs its
    launch configuration and ptxas line.  Returns the timing record
    (cartpole, with chain16's under "chain16")."""
    import torch
    from sip_optimal_control_tpu_torch.ops import ls_probe

    out = None
    for seed, model in enumerate(CHAIN_PATHS):
        prob, dims = path_problem(model, device)
        fspec, fbounds, _ = prob.fused_ls
        fn = ls_probe.make_fused_probe(fspec, fbounds)

        def twin(*a):
            return ls_probe.probe_reference(fspec, fbounds, *a)

        for case, (batch, solver_view) in enumerate(
                ((BATCH, False), (BATCH, True), (1000, True))):
            args = probe_inputs(dims, batch, seed + 10 * case, device)
            if solver_view:            # solver/sip.py, solver/fused_chain.py
                args = args[:5] + (args[5].t().contiguous().t(),)
            got, want = fn(*args), twin(*args)
            torch.cuda.synchronize()
            layout = "transposed" if solver_view else "contiguous"
            err = probe_match(f"probe[{model} B={batch} {layout}]", got,
                              want)
            infeasible = float(torch.isneginf(want[2]).float().mean())
            log(f"kernels[probe {model}] B={batch} chunk={CHUNK} "
                f"T={HORIZON} n={dims.max_state_dim} "
                f"m={dims.max_control_dim} alphas {layout}: max|kernel - "
                f"twin| {err:.3e} on finite entries, -inf patterns "
                f"identical ({infeasible:.4f} of the candidates infeasible)")
            if case == 0:
                main_err, main_args = err, args
        lib = ls_probe.build_library(fspec, fbounds)[0]
        log(f"launch[ls_probe {model}] B={BATCH}: "
            f"{json.dumps(ls_probe.launch_config(lib, BATCH))}; ptxas "
            f"{ptxas_line(lib, 'probe_kernel')}")
        source, replaces = ls_probe.KERNELS["ls_probe"]
        rec = kernel_record("ls_probe", main_err, fn, twin, main_args,
                            BATCH * CHUNK * probe_flops(fspec, fbounds),
                            source, replaces)
        rec["device_ms"] = kernel_device_ms(
            [lambda: fn(*main_args)], "void ls_probe::",
            {"ls_probe": "probe_kernel"}, reps=20)["probe_kernel"]
        log(f"time[ls_probe {model}] B={BATCH} chunk={CHUNK} T={HORIZON}: "
            f"kernel wrapper {rec['ms']:.4f} ms, device "
            f"{rec['device_ms']:.4f} ms per launch, plain twin "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
        if out is None:
            out = rec
        else:
            out[model] = rec
    return out


def check_probe_tree(device):
    """The tree probe kernel against its twin on robust_tree at the main
    path's batch (the candidates contiguous, then as the solver's
    transposed view) and at a ragged batch (B=1000, transposed), some
    candidates infeasible; logs its launch configuration and ptxas line.
    Returns the timing record, with the device time per launch."""
    import torch
    from sip_optimal_control_tpu_torch.ops import ls_probe

    prob, dims = path_problem("robust_tree", device)
    tspec, tbounds, _ = prob.fused_ls
    fn = ls_probe.make_fused_probe(tspec, tbounds)

    def twin(*a):
        return ls_probe.probe_reference_tree(tspec, tbounds, *a)

    for case, (batch, solver_view) in enumerate(
            ((BATCH, False), (BATCH, True), (1000, True))):
        args = probe_inputs(dims, batch, 20 + case, device)
        if solver_view:                # solver/sip.py
            args = args[:5] + (args[5].t().contiguous().t(),)
        want = twin(*args)
        got = fn(*args)
        torch.cuda.synchronize()
        layout = "transposed" if solver_view else "contiguous"
        err = probe_match(f"probe_tree[B={batch} {layout}]", got, want)
        infeasible = float(torch.isneginf(want[2]).float().mean())
        log(f"kernels[probe_tree robust_tree] B={batch} chunk={CHUNK} "
            f"N={dims.num_nodes} E={dims.num_edges} n={dims.max_state_dim} "
            f"m={dims.max_control_dim} alphas {layout}: max|kernel - twin| "
            f"{err:.3e} on finite entries, -inf patterns identical "
            f"({infeasible:.4f} of the candidates infeasible)")
        if case == 0:
            main_err, main_args = err, args
    lib = ls_probe.build_library(tspec, tbounds)[0]
    log(f"launch[ls_probe_tree robust_tree] B={BATCH}: "
        f"{json.dumps(ls_probe.launch_config(lib, BATCH))}; ptxas "
        f"{ptxas_line(lib, 'probe_tree_kernel')}")
    source, replaces = ls_probe.KERNELS["ls_probe_tree"]
    rec = kernel_record("ls_probe_tree", main_err, fn, twin, main_args,
                        BATCH * CHUNK * probe_tree_flops(tspec, tbounds),
                        source, replaces)
    rec["device_ms"] = kernel_device_ms(
        [lambda: fn(*main_args)], "void ls_probe_tree::",
        {"ls_probe_tree": "probe_tree_kernel"}, reps=20)["probe_tree_kernel"]
    log(f"time[ls_probe_tree] B={BATCH} chunk={CHUNK}: kernel wrapper "
        f"{rec['ms']:.4f} ms, device {rec['device_ms']:.4f} ms per "
        f"launch; plain twin {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    return rec


def fused_flops(name, spec, bounds):
    """Floating-point operations per scenario of each fused kernel: the
    generated stage programs (one operation per scalar instruction, a
    transcendental counted as one) plus the Riccati algebra as
    _riccati_flops counts it, per stage."""
    T, n, m = spec.horizon, spec.n, spec.m

    def ops(*progs):
        return sum(len(p.instrs) for p in progs)
    recompute = ops(spec.dyn_jac) if n >= 8 else 0
    if name == "fused_factor":
        edge = _riccati_flops("riccati_factor_gram" if n >= 8
                              else "riccati_factor", n, m)
        # + condensation: Q = Hn + Hxx + diag, R = Huu + diag; the
        # terminal node's Hessian and diagonal
        return (T * (ops(spec.dyn_jac, spec.nhess, spec.ehess) + 2 * n * n
                     + n + m * m + m + edge) + ops(spec.nhess) + n)
    if name == "fused_solve_bwd":
        # + the root solve: F, chol, two triangular solves, y
        return (T * (_riccati_flops("riccati_solve_bwd", n, m) + recompute)
                + 2 * n * n + n ** 3 / 3 + 2 * n * n + 4 * n + 2 * n * n)
    if name == "fused_solve_fwd":
        return T * (_riccati_flops("riccati_solve_fwd", n, m) + recompute)
    if name == "fused_eval":
        finite = sum(int(np.isfinite(b).sum()) for b in bounds)
        # + gx, ctx, cdyn, the |stat| and |c| maxima, gu, ctu, and the d*z
        # terms of the finite bounds; node T and the root row
        return (T * (ops(spec.ncost_grad, spec.ecost_grad, spec.dyn_vjp,
                         spec.dyn, spec.ncost, spec.ecost)
                     + 9 * n + 6 * m + 4 * finite)
                + ops(spec.ncost_grad, spec.ncost) + 9 * n
                + 4 * sum(int(np.isfinite(b).sum()) for b in bounds[2:]))
    raise KeyError(name)


def fused_bytes(name, spec):
    """Bytes per scenario that each fused kernel reads and writes once, the
    operands as csrc/fused_iter.cuh uses them (float32; V and F_chol in
    nsym rows): the factor reads x and r1x at the T + 1 nodes (the terminal
    node's Hessian is formed in the kernel), u and r1u at the T edges and y
    at the children in exact mode only; both solve kernels read the stored
    A and B at n < GRAM_N and x, u at the T edges to recompute them
    otherwise; solve_bwd reads V_root but no V_child, solve_fwd V_child but
    neither G_chol nor V_root; eval reads the iterate, x0 and the bound
    duals and writes every node's and edge's gradients and residuals (node
    T and the root row included)."""
    from sip_optimal_control_tpu_torch.ops import fused_iter as fi
    T, n, m = spec.horizon, spec.n, spec.m
    s, small = fi.nsym(n), n < fi.GRAM_N
    jac = T * (n * n + n * m) if small else T * (n + m)
    if name == "fused_factor":
        floats = (2 * (T + 1) * n + 2 * T * m + (T * n if spec.exact else 0)
                  + 1                                       # reads
                  + T * (2 * s + m * n + m * m) + s         # writes
                  + (T * (n * n + n * m) if small else 0))
    elif name == "fused_solve_bwd":
        floats = (2 * (T + 1) * n + T * m + 1 + s + T * (s + m * m + m * n)
                  + jac + T * (m + n) + 2 * n)
    elif name == "fused_solve_fwd":
        floats = (2 * n + T * (m + m * n + n + n + 2 * s) + jac + 1
                  + T * m + 2 * (T + 1) * n)
    elif name == "fused_eval":
        floats = (2 * (T + 1) * n + T * m + n + 2 * (T + 1) * n + 2 * T * m
                  + 3 * (T + 1) * n + 2 * T * m + 7)
    else:
        raise KeyError(name)
    return 4 * floats


def fused_model(model, device, dtype=None):
    """A model of the fused check at HORIZON: (stage functions, FusedIterSpec,
    bound rows) through model.fused_probe_model, the path's own entry."""
    import torch
    from sip_optimal_control_tpu_torch.model import fused_probe_model
    from sip_optimal_control_tpu_torch.models import (cartpole_swingup,
                                                      planar_quadrotor,
                                                      synthetic_chain)
    make = {"cartpole": cartpole_swingup, "quadrotor": planar_quadrotor,
            "chain16": synthetic_chain}[model]
    spec, dims, topo, lo, up, _ = make(horizon=HORIZON,
                                       dtype=dtype or torch.float32,
                                       device=device)
    if dtype not in (None, torch.float32):
        return spec, None, None
    _, rows, ispec = fused_probe_model(spec, dims, topo, lo, up,
                                       torch.float32, device,
                                       FUSED_MODELS[model])
    if ispec is None:
        raise AssertionError(f"{model}: not eligible for the fused kernels")
    return spec, ispec, rows


def fused_inputs(spec, batch, seed, device, delta):
    """Random iterate, regularizations, right-hand side and bound duals
    (as tests/test_fused_iter.py), float32 on `device`."""
    import torch
    T, n, m = spec.horizon, spec.n, spec.m
    rng = np.random.default_rng(seed)
    arrays = dict(
        x=0.5 * rng.standard_normal((batch, T + 1, n)),
        u=0.5 * rng.standard_normal((batch, T, m)),
        y=0.1 * rng.standard_normal((batch, T + 1, n)),
        r1x=0.5 + rng.random((batch, T + 1, n)),
        r1u=0.5 + rng.random((batch, T, m)), delta=np.full(batch, delta),
        q=rng.standard_normal((batch, T + 1, n)),
        r=rng.standard_normal((batch, T, m)),
        c=rng.standard_normal((batch, T + 1, n)),
        x0=rng.standard_normal((batch, n)),
        zlx=rng.random((batch, T + 1, n)), zlu=rng.random((batch, T, m)),
        zux=rng.random((batch, T + 1, n)), zuu=rng.random((batch, T, m)))
    return {k: torch.as_tensor(v.astype(np.float32), device=device)
            for k, v in arrays.items()}


def _leaves(tensors):
    out = []
    for t in tensors:
        if isinstance(t, tuple):
            out += _leaves(t)
        elif t is not None:
            out.append(t)
    return out


def kernel_device_ms(calls, prefix, want, reps=5, tries=5):
    """The kernels' own device time per launch (ms) by torch.profiler over
    `reps` rounds of `calls`, keyed by kernel name after `prefix`: each
    kernel's device time over the launches the profiler recorded.  `want`
    maps each wanted kernel's launch counter (the port's) to the start of
    its name, in the order of `calls` (one wanted kernel a call); a
    warm-up round's counters give the launches a round makes.
    The profiler lost device records at a session's edges (the first one
    or two of a session without a warm-up step; one of 20 in sessions
    with one): so each session traces one more round first and discards
    it (the profiler schedule's warm-up step), and each traced step
    starts and ends with a spin kernel of ~1 ms that no count reads.  A
    session whose records of a wanted kernel count other than `reps`
    times the round's launches is profiled again, up to `tries` sessions.
    Late in a run whole sessions record no device activity at all, the
    spins' included (on an H100 the first session of each of phases
    8-10, and every session of phase 8's probe in some runs): with no
    session that counts every launch, each call's device time comes from
    CUDA events around `reps` calls queued behind a spin kernel, so that
    the host's issue gaps do not count (`events_device_ms`: the call's
    every launch, the wanted kernel's in practice).  Every session's
    readings are logged, with its count of all device records."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    before = read_counts()
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    after = read_counts()
    launched = {name: reps * (after[counter] - before[counter])
                for counter, name in want.items()}
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for rounds in (1, reps):
                torch.cuda._sleep(2_000_000)
                for _ in range(rounds):
                    for fn in calls:
                        fn()
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
                prof.step()
        out, count, records = {}, {}, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                records += e.count
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and e.key.startswith(prefix)):
                name = e.key[len(prefix):].split("<")[0]
                out[name] = e.self_device_time_total / e.count / 1e3
                count[name] = count.get(name, 0) + e.count
        seen = {name: sum(c for k, c in count.items() if k.startswith(name))
                for name in launched}
        log(f"device time: profiler session {attempt + 1} of {tries}: "
            + ", ".join(f"{k} {v:.4f} ms x {count[k]}" for k, v in out.items())
            + f"; launched {launched}; {records} device records in all")
        if seen == launched:
            return out
    out = {name: events_device_ms(fn, reps) / max(1, launched[name] // reps)
           for fn, name in zip(calls, launched)}
    log(f"device time: no profiler session counted {launched}; by CUDA "
        "events behind a spin kernel instead: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()))
    return out


def events_device_ms(fn, reps):
    """Device ms of one call of `fn`: CUDA events around `reps` calls that
    the host queues while a ~20 ms spin kernel keeps the stream busy, so
    that the calls run back to back on the device."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# each fused kernel's name in the profiler and in ptxas's log (the factor:
# factor_thread_kernel at n < 8, factor_team_kernel above)
FUSED_NAMES = {"fused_factor": "factor_",
               "fused_solve_bwd": "solve_bwd_kernel",
               "fused_solve_fwd": "solve_fwd_kernel",
               "fused_eval": "eval_kernel"}


def device_ms_of(dev, name):
    """The device ms per launch of fused kernel `name` in a
    kernel_device_ms result."""
    hits = [v for k, v in dev.items() if k.startswith(FUSED_NAMES[name])]
    if len(hits) != 1:
        raise AssertionError(f"{name}: device times {dev}")
    return hits[0]


def ptxas_line(lib_path, kernel):
    """One line of ptxas's report for the entry whose name holds `kernel`:
    registers, stack frame, spill stores and loads."""
    from sip_optimal_control_tpu_torch.ops import cuda_build
    lines = cuda_build.ptxas_report(lib_path).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            mangled = line.split("'")[1]
            body = []
            for nxt in lines[i + 1:]:
                if "Compiling entry" in nxt:
                    break
                body.append(nxt.strip().replace("ptxas info    : ", ""))
            return f"{mangled}: " + "; ".join(body)
    raise AssertionError(f"no ptxas entry for {kernel} in {lib_path}")


def check_fused(device):
    """The fused kernels against their twins on the three models; returns
    the timing records (cartpole, with quadrotor's and chain16's nested
    under their names)."""
    import torch
    from sip_optimal_control_tpu_torch.ops import fused_iter as fi

    out = {}
    for seed, model in enumerate(FUSED_MODELS, start=100):
        spec_m, spec, bounds = fused_model(model, device)
        entries = fi._entries(spec, bounds)
        a = fused_inputs(spec, BATCH, seed, device, 0.01)
        it = [a[k] for k in ("x", "u", "y", "r1x", "r1u", "delta")]
        x, u, q, r, c, d = (a[k] for k in ("x", "u", "q", "r", "c",
                                           "delta"))
        ev_in = [a[k] for k in ("x", "u", "y", "x0", "zlx", "zlu", "zux",
                                "zuu")]
        step_in = it + [q, r, c]
        label = f"fused {model}"

        def factor(*args):
            return fi.factor_kernel(spec, *args, entries=entries)
        fac_t = fi.factor_reference(spec, *it)
        bwd_t = fi.solve_bwd_reference(spec, fac_t, x, u, q, r, c, d)
        cases = {
            "fused_factor": (factor, lambda *args: fi.factor_reference(
                spec, *args), it, FACTOR_TOL),
            "fused_solve_bwd": (
                lambda *args: fi.solve_bwd_kernel(spec, *args,
                                                  entries=entries),
                lambda *args: fi.solve_bwd_reference(spec, *args),
                [fac_t, x, u, q, r, c, d], SOLVE_TOL),
            "fused_solve_fwd": (
                lambda *args: fi.solve_fwd_kernel(spec, *args,
                                                  entries=entries),
                lambda *args: fi.solve_fwd_reference(spec, *args),
                [fac_t, bwd_t, x, u, c, d], SOLVE_TOL),
            "fused_eval": (
                lambda *args: fi.eval_kernel(spec, bounds, *args,
                                             entries=entries),
                lambda *args: fi.eval_reference(spec, bounds, *args),
                ev_in, SOLVE_TOL)}
        errs = {}
        for name, (fn, twin, args, tol) in cases.items():
            got, want = _leaves(fn(*args)), _leaves(twin(*args))
            errs[name], _ = compare(label, name, got, want, tol,
                                    slice(None))
        st_k = fi.factor_solve_kernel(spec, *step_in, entries=entries)[3]
        st_t = fi.factor_solve_plain(spec, *step_in)[3]
        torch.cuda.synchronize()
        if not torch.equal(st_k, st_t):
            raise AssertionError(f"{label}: statuses differ")

        # at the solver's delta: the Newton step against the twins in
        # float64 on the same inputs, the float32 twins' own error the bar
        delta = regularized_delta("chain16" if model == "chain16"
                                  else "cartpole")
        b = fused_inputs(spec, BATCH, seed + 50, device, delta)
        step_in_d = [b[k] for k in ("x", "u", "y", "r1x", "r1u", "delta",
                                    "q", "r", "c")]
        m64 = fused_model(model, device, torch.float64)[0]
        spec64 = spec._replace(dyn_orig=m64.dynamics,
                               ncost_orig=m64.node_cost,
                               ecost_orig=m64.edge_cost)
        got = fi.factor_solve_kernel(spec, *step_in_d, entries=entries)
        twin = fi.factor_solve_plain(spec, *step_in_d)
        ref = fi.factor_solve_plain(spec64, *[t.double() for t in step_in_d])
        ok_k, ok_t, ok_64 = got[3] == 0, twin[3] == 0, ref[3] == 0
        if bool((ok_t & ~ok_k).any()):
            raise AssertionError(f"{label}: the kernels fail where the "
                                 "float32 twins succeed")
        lanes = ok_k & ok_t & ok_64
        d_err, d_det = compare(label, "Newton step at the solver's delta",
                               got[:3], twin[:3], SOLVE_TOL, lanes,
                               ref[:3], ok_k & ok_64)
        log(f"kernels[{label}] B={BATCH} T={HORIZON} n={spec.n} m={spec.m}: "
            "max|kernel - twin| "
            + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f"; statuses identical (SUCCESS {int((st_k == 0).sum())}"
            f"/{BATCH}); delta={delta:.4g}: {d_err:.3e}{d_det}, SUCCESS "
            f"kernel {int(ok_k.sum())} twin {int(ok_t.sum())} float64 "
            f"{int(ok_64.sum())}")

        dev = kernel_device_ms([lambda fn=fn, args=args: fn(*args)
                                for fn, _, args, _ in cases.values()],
                               "void fused_iter::",
                               {name: FUSED_NAMES[name] for name in cases})
        lib = fi.build_library(spec, bounds)[0]
        for name in fi.KERNEL_NAMES:
            log(f"launch[{name} {model}] B={BATCH}: "
                f"{json.dumps(fi.launch_config(entries, name, BATCH))}; "
                f"ptxas {ptxas_line(lib, FUSED_NAMES[name])}")
        recs = {}
        for name, (fn, twin, args, tol) in cases.items():
            ms = time_ms(lambda: fn(*args), reps=20)
            plain_ms = time_ms(lambda: twin(*args), reps=3, warmup=1)
            bound_ms, bound_by = bound(
                None, None, BATCH * fused_flops(name, spec, bounds),
                BATCH * fused_bytes(name, spec))
            source, replaces = fi.KERNELS[name]
            recs[name] = {
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "max_abs_err": errs[name], "ms": ms,
                "device_ms": device_ms_of(dev, name), "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}
            log(f"time[{name} {model}] B={BATCH} T={HORIZON}: wrapper "
                f"{ms:.4f} ms, device {recs[name]['device_ms']:.4f} ms per "
                f"launch (wrapper - device {ms - recs[name]['device_ms']:.4f}"
                f" ms), plain twin {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by})")
        for name, rec in recs.items():
            if model == "cartpole":
                out[name] = rec
            else:
                out[name][model] = rec
    return out


# ---------------------------------------------------------------------------
# phases 4 to 7: the paths
# ---------------------------------------------------------------------------

def mpc_settings(backend, fused_probe=True, model="cartpole", fused=False):
    """The bench's RTI settings (bench.py:845-921) for a path: its fixed
    trips, the filter line search probing 6 candidates in one chunk (the
    fused probe unless fused_probe=False), no factor retries, the RTI
    freeze-select off for robust_tree (bench.py:851-852); the fused
    whole iteration when `fused`."""
    from sip_optimal_control_tpu_torch import Settings
    from sip_optimal_control_tpu_torch.solver.settings import \
        LineSearchSettings
    return Settings(max_iterations=PATHS[model]["trips"],
                    fixed_iterations=True, mu_init=3e-3, tol=1e-3,
                    mu_min=1e-5, reg_floor=1e-5, prox_reg=1e-5,
                    max_factor_retries=0, riccati_backend=backend,
                    fused_iteration=fused,
                    rti_freeze_ev=model != "robust_tree",
                    line_search=LineSearchSettings(
                        max_steps=CHUNK, chunk=CHUNK,
                        use_filter_line_search=True,
                        fused_probe=fused_probe))


def main_path_inputs(device, batch=BATCH, model="cartpole", dtype=None,
                     jitter=0.1):
    """A path's model and MPC start state: cartpole h50, chain16 h50 or
    robust_tree h50 (bench.py:146-150: 2 shared edges, 4 branches of 12) in
    float32 (or `dtype`) on `device`; plant states jittered from the model's
    start by `jitter` standard normals with seed 0 in float32
    (bench.py:923-926; bench.py --mode scaling jitters by 0.05); warm start
    the constant trajectory at each state with zero duals.  Returns (model,
    state) as `mpc_call` takes them."""
    import torch
    from sip_optimal_control_tpu_torch import Primal, YVec
    from sip_optimal_control_tpu_torch.models import (cartpole_swingup,
                                                      robust_scenario_tree,
                                                      synthetic_chain)

    dtype = dtype or torch.float32
    if model == "cartpole":
        built = cartpole_swingup(horizon=HORIZON, dtype=dtype, device=device)
    elif model == "robust_tree":
        built = robust_scenario_tree(t_shared=2, n_branches=4,
                                     t_branch=max(1, (HORIZON - 2) // 4),
                                     dtype=dtype, device=device)
    else:
        n, m = PATHS[model]["nm"]
        built = synthetic_chain(horizon=HORIZON, state_dim=n, control_dim=m,
                                dtype=dtype, device=device)
    spec, dims, topo, lower, upper, x0 = built
    N, E = dims.num_nodes, dims.num_edges
    n, m = dims.max_state_dim, dims.max_control_dim
    rng = np.random.default_rng(0)
    x0s = np.tile(x0.cpu().numpy(), (batch, 1))
    x0s += jitter * rng.standard_normal((batch, n)).astype(np.float32)
    x = torch.as_tensor(x0s.astype(np.float32), device=device).to(dtype)
    zeros = dict(dtype=dtype, device=device)
    wv = Primal(x=x[:, None].expand(batch, N, n).contiguous(),
                u=torch.zeros(batch, E, m, **zeros),
                theta=torch.zeros(batch, 0, **zeros))
    wy = YVec(dyn=torch.zeros(batch, N, n, **zeros),
              nc=torch.zeros(batch, N, 0, **zeros),
              ec=torch.zeros(batch, E, 0, **zeros))
    return (model, spec, dims, topo, lower, upper), (x, wv, wy)


def mpc_call(model, state, backend, steps=STEPS, fused_probe=True,
             fused=False):
    """One call of a path: `steps` MPC steps from `state`."""
    from sip_optimal_control_tpu_torch import mpc_steps
    return mpc_steps(*model[1:], mpc_settings(backend, fused_probe, model[0],
                                              fused),
                     *state, steps=steps, hessian_mode="gauss_newton",
                     noise=0.05)


def _counted_modules():
    from sip_optimal_control_tpu_torch.ops import fused_iter, ls_probe
    from sip_optimal_control_tpu_torch.ops import riccati_cuda as rc
    return rc, ls_probe, fused_iter


def reset_counts():
    for module in _counted_modules():
        module.reset_launch_counts()


def read_counts():
    out = {}
    for module in _counted_modules():
        out.update(module.launch_counts)
    return out


def timed_call(model, state, fused_probe=True, steps=STEPS, fused=False):
    """One call on the kernels; (out, (CUDA-event s, host s))."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = mpc_call(model, state, "cuda", steps, fused_probe, fused)
    end.record()
    torch.cuda.synchronize()
    return out, (start.elapsed_time(end) / 1e3, time.perf_counter() - t0)


def run_path(device, model="cartpole", batch=BATCH, calls=None, steps=None,
             fused=False, scan_first=None):
    """A path's workload; returns a dict of results.  Step 1 on both
    backends, a call of `steps` steps on the plain backend ("scan",
    standard probe; `scan_first` when the caller ran it already from the
    same start state), a path's untimed warm steps on the kernels (its
    "warm" entry; that call is then the one held against scan's), then
    the timed calls on the kernels with the fused probe (the launch counts
    cover exactly these).  The standard iteration (`fused` False) on
    cartpole also runs a call on the standard probe before the timed calls
    (from the same start state as the first) and one after them, in
    turns."""
    calls = PATHS[model]["calls"] if calls is None else calls
    steps = PATHS[model]["steps"] if steps is None else steps
    import torch
    mdl, state = main_path_inputs(device, batch, model)
    step1 = {"scan": mpc_call(mdl, state, "scan", 1, fused_probe=False),
             "cuda": mpc_call(mdl, state, "cuda", 1, fused=fused)}
    if model == "chain16":
        # float32's own spread: the scan backend in float64, same inputs
        step1["scan64"] = mpc_call(*main_path_inputs(
            device, batch, model, torch.float64), "scan", 1,
            fused_probe=False)
    if scan_first is None:
        scan_first = mpc_call(mdl, state, "scan", steps, fused_probe=False)
    warm = None
    if PATHS[model].get("warm"):
        warm = mpc_call(mdl, state, "cuda", PATHS[model]["warm"])
        state = (warm.x, warm.vars, warm.y)
    standard = []
    if model == "cartpole" and not fused:
        standard.append(timed_call(mdl, state, False, steps)[1][0])
    reset_counts()
    outs, seconds = [], []
    for _ in range(calls):
        out, secs = timed_call(mdl, state, steps=steps, fused=fused)
        seconds.append(secs)
        outs.append(out)
        state = (out.x, out.vars, out.y)
    launches = read_counts()
    if model == "cartpole" and not fused:
        standard.append(timed_call(mdl, state, False, steps)[1][0])
    return dict(model=model, fused=fused, first=outs[0], last=outs[-1],
                warm=warm, per_call=[quality(out) for out in outs],
                scan_first=scan_first, step1=step1, launches=launches,
                seconds=seconds, standard_seconds=standard, batch=batch,
                steps=steps, calls=calls)


def compare_step1(step1, model="cartpole", label=None, iter_tol=None):
    """Step 1 on the kernels against the plain twins ("scan", standard
    probe), lane by lane: statuses equal, the next warm start and plant
    state within the path's iter_tol (1 + |scan|), the KKT error within
    KKT_RTOL relative.  Returns the share of scenarios where all of that
    holds.

    chain16 ends its 2 trips with a KKT error of about the barrier parameter
    mu (complementarity, ~3e-3 at mu_init), or well below it where the
    scenario's mu has dropped; whether it drops is a threshold decision that
    float32 roundoff flips (batch 512 on a CPU: the twins against scan on
    4.3% of the scenarios, float32 scan against float64 scan on 17.4%).  So
    on chain16 a scenario whose mu differs between the two runs is held to
    the iterate bar only, and the share of such scenarios must not exceed
    the share on which float32 scan's mu differs from a float64 scan run's
    (step1["scan64"])."""
    import torch
    cu, sc = step1["cuda"], step1["scan"]
    iter_tol = iter_tol or PATHS[model]["iter_tol"]
    label = label or model

    def lane_err(a, b):
        return ((a - b).abs() / (1 + b.abs())).flatten(1).max(-1).values

    it_err = torch.stack([lane_err(cu.x, sc.x), lane_err(cu.vars.x, sc.vars.x),
                          lane_err(cu.vars.u, sc.vars.u)]).max(0).values
    kkt_err = (cu.kkt_errors[0] - sc.kkt_errors[0]).abs() \
        / sc.kkt_errors[0].abs()
    same = cu.statuses[0] == sc.statuses[0]
    close = same & (it_err <= iter_tol) & (kkt_err <= KKT_RTOL)
    if "scan64" in step1:
        mu64 = step1["scan64"].mus[0]
        flipped = cu.mus[0] != sc.mus[0]
        flipped_32 = (sc.mus[0].double() - mu64).abs() > 1e-6 * mu64
        share_k = float(flipped.float().mean())
        share_32 = float(flipped_32.float().mean())
        log(f"step 1 [{label}]: mu differs from scan's on {share_k:.4f} of "
            f"the scenarios (bar: float32 scan's against float64 scan, "
            f"{share_32:.4f}); where it agrees, all within the bars on "
            f"{float(close[~flipped].float().mean()):.4f}")
        if share_k > share_32:
            raise AssertionError(f"{label}: mu decision flipped on "
                                 f"{share_k} > {share_32}")
        close = close | (flipped & (it_err <= iter_tol))
    q = torch.tensor([0.5, 0.99], device=it_err.device)
    iq, kq = it_err.quantile(q).tolist(), kkt_err.quantile(q).tolist()
    share = float(close.float().mean())
    log(f"step 1 [{label}], cuda + fused probe vs scan + standard probe: "
        f"statuses equal on {float(same.float().mean()):.4f} of scenarios; "
        f"iterate rel. diff median {iq[0]:.3e} p99 {iq[1]:.3e} max "
        f"{float(it_err.max()):.3e} (bar {iter_tol}); KKT error rel. diff "
        f"median {kq[0]:.3e} p99 {kq[1]:.3e} max {float(kkt_err.max()):.3e} "
        f"(bar {KKT_RTOL}); all within bars on {share:.4f} (bar "
        f"{SCAN_AGREEMENT})")
    return share


def usable(out):
    """The MPC step's usable decision per step and scenario."""
    st, kkt = out.statuses, out.kkt_errors
    return (st == 0) | ((st == 1) & (kkt < 1e2))


def quality(out):
    return dict(usable_frac=float(usable(out).float().mean()),
                solved_frac=float((out.statuses == 0).float().mean()),
                final_state_rms=float(out.x.pow(2).mean().sqrt()),
                mean_iterations=float(out.iterations.float().mean()))


# kernels each path must launch once per trip and step; the fused paths'
# eval kernel runs once more per solve (at the start iterate)
PATH_KERNELS = {"cartpole": ("riccati_factor", "riccati_solve_bwd",
                             "riccati_solve_fwd", "ls_probe"),
                "chain16": ("riccati_factor_gram", "riccati_solve_bwd",
                            "riccati_solve_fwd", "ls_probe"),
                "fused": ("fused_factor", "fused_solve_bwd",
                          "fused_solve_fwd", "ls_probe"),
                # the tree LQR is plain PyTorch: no Riccati kernel
                "robust_tree": ("ls_probe_tree",)}


def path_label(res):
    return res["model"] + (" fused" if res["fused"] else "")


def expected_launches(res):
    """Launches per kernel the path's timed calls must show."""
    solves = res["calls"] * res["steps"]
    trips = PATHS[res["model"]]["trips"] * solves
    kernels = PATH_KERNELS["fused" if res["fused"] else res["model"]]
    out = {name: trips if name in kernels else 0 for name in res["launches"]}
    if res["fused"]:
        out["fused_eval"] = trips + solves
    return out


def check_path(res):
    import torch
    model, label = res["model"], path_label(res)
    for name, want in expected_launches(res).items():
        count = res["launches"][name]
        log(f"launches[{label}][{name}] = {count} (expected {want})")
        if count != want:
            raise AssertionError(f"{name}: {count} launches on the {label} "
                                 f"path, expected {want}")
    last = res["last"]
    B = res["batch"]
    for out in (res["first"], last, res["scan_first"], res["warm"]):
        if out is None:
            continue
        if tuple(out.statuses.shape) != (res["steps"], B):
            raise AssertionError(f"statuses shape {tuple(out.statuses.shape)}")
        if not (torch.isfinite(out.x).all() and torch.isfinite(out.vars.x)
                .all() and torch.isfinite(out.vars.u).all()):
            raise AssertionError("non-finite MPC state")
    agree = compare_step1(res["step1"], model, label)
    q_scan = quality(res["scan_first"])
    q_first = (res["per_call"][0] if res["warm"] is None
               else quality(res["warm"]))
    log(f"first call [{label}], cuda + fused probe vs scan + standard "
        f"probe: usable {q_first['usable_frac']:.4f} vs "
        f"{q_scan['usable_frac']:.4f}, final_state_rms "
        f"{q_first['final_state_rms']:.4f} vs "
        f"{q_scan['final_state_rms']:.4f}")
    log(f"timed calls [{label}]: usable_frac per call "
        + json.dumps([q["usable_frac"] for q in res["per_call"]])
        + ", solved_frac per call "
        + json.dumps([q["solved_frac"] for q in res["per_call"]]))
    if agree < SCAN_AGREEMENT:
        raise AssertionError(f"{label}: step-1 agreement {agree} < "
                             f"{SCAN_AGREEMENT}")
    q = quality(last)
    floor = JAX_TPU_RMS_FLOOR.get(model)
    log(f"timed call quality [{label}]: {json.dumps(q)}"
        + ("" if floor is None else
           f" (JAX's converged-controller rms floor {floor}: a TPU figure, "
           "not a port number)"))
    if q["usable_frac"] < QUALITY_USABLE:
        raise AssertionError(f"{label}: usable_frac {q['usable_frac']} < "
                             f"{QUALITY_USABLE}")
    return q


def report_path(res, q):
    model, steps, calls = res["model"], res["steps"], res["calls"]
    label = path_label(res)
    trips = PATHS[model]["trips"]
    ev_s, host_s = res["seconds"][-1]
    solves = BATCH * steps
    per_call = ", ".join(f"{a:.3f}" for a, _ in res["seconds"])
    per_step = {k: v / (calls * steps) for k, v in res["launches"].items()
                if v}
    log(f"path [{label}]: launches per MPC step of the port's kernels "
        f"{json.dumps(per_step)}")
    log(f"path [{label}]: {calls} calls x {steps} steps, batch {BATCH}; "
        f"seconds per call (CUDA events) [{per_call}]; last call "
        f"{ev_s:.3f} s events / {host_s:.3f} s host -> "
        f"{solves / ev_s:.1f} solves/s, {1e3 * ev_s / steps:.2f} ms per MPC "
        f"step, {1e3 * ev_s / (steps * trips):.2f} ms per IPM trip")
    summary = {"solves_per_s": solves / ev_s, "step_ms": 1e3 * ev_s / steps,
               **q, "usable_frac_per_call": [c["usable_frac"]
                                             for c in res["per_call"]]}
    if res["standard_seconds"]:
        before, after = res["standard_seconds"]
        first, last = res["seconds"][0][0], ev_s
        log(f"path [{label}] with the standard probe, in turns: a call "
            f"before the fused calls {before:.3f} s and one after "
            f"{after:.3f} s (CUDA events) -> {solves / before:.1f} and "
            f"{solves / after:.1f} solves/s; against the neighbouring fused "
            f"calls {first:.3f} and {last:.3f} s the fused probe is "
            f"{before / first:.3f}x and {after / last:.3f}x faster")
        summary["standard_probe_solves_per_s"] = 2 * solves / (before + after)
    log(json.dumps({label: summary}))


# ---------------------------------------------------------------------------
# phases 8 and 9: run_mpc on the quadrotor, the coupled joint-θ solve
# ---------------------------------------------------------------------------

# BASELINE config 4 (examples/quadrotor_mpc.py): planar quadrotor, horizon
# 20, target (1.0, 1.5), 100 warm-started re-solves; the example's float32
# settings, convergence-tested, with the Riccati kernels and the fused probe
QUAD = dict(horizon=20, target=(1.0, 1.5), steps=100, iter_tol=1e-2,
            budget_share=0.25)
# bench.py --mode joint-theta (bench.py:349-356): 4096 coupled scenarios at
# horizon 50, the best of 5 timed calls after one warm-up
JOINT = dict(horizon=50, calls=5)


def quad_settings(backend, fused_probe=True):
    """examples/quadrotor_mpc.py's float32 settings on `backend`; the
    default line search (Armijo, 10 candidates one at a time)."""
    from sip_optimal_control_tpu_torch import Settings
    from sip_optimal_control_tpu_torch.solver.settings import \
        LineSearchSettings
    return Settings(max_iterations=25, tol=1e-3, mu_min=1e-5, reg_floor=1e-5,
                    prox_reg=1e-5, riccati_backend=backend,
                    line_search=LineSearchSettings(fused_probe=fused_probe))


def quad_inputs(device, batch=None):
    """The quadrotor model (float32) and `batch` (BATCH) start states: the
    example's x0 = (-0.5, 0, ...) jittered as main_path_inputs jitters
    (seed 0, float32)."""
    import torch
    batch = batch or BATCH
    from sip_optimal_control_tpu_torch.models import planar_quadrotor
    built = planar_quadrotor(horizon=QUAD["horizon"], target=QUAD["target"],
                             dtype=torch.float32, device=device)
    x0 = np.zeros(6, np.float32)
    x0[0] = -0.5
    rng = np.random.default_rng(0)
    x0s = np.tile(x0, (batch, 1))
    x0s += 0.1 * rng.standard_normal((batch, 6)).astype(np.float32)
    return built[:5], torch.as_tensor(x0s.astype(np.float32), device=device)


def quad_run(model, x0s, backend, steps, fused_probe=True, budget=None):
    """run_mpc (or run_mpc_timed with `budget` seconds) from `x0s`."""
    from sip_optimal_control_tpu_torch import run_mpc, run_mpc_timed
    settings = quad_settings(backend, fused_probe)
    if budget is None:
        return run_mpc(*model[:3], x0s, steps, settings, *model[3:])
    return run_mpc_timed(*model[:3], x0s, steps, budget, settings,
                         *model[3:])


def step1_view(trace):
    """run_mpc's first step in the fields compare_step1 reads: the next
    plant state, the applied control (as a one-stage trajectory), the
    status and the KKT error."""
    import types
    return types.SimpleNamespace(
        x=trace.states[1], statuses=trace.statuses,
        kkt_errors=trace.kkt_errors,
        vars=types.SimpleNamespace(x=trace.states[1][:, None],
                                   u=trace.controls[0][:, None]))


def solver_launches(settings, trips, p=0):
    """Launches of the standard iteration's kernels over `trips` interior-
    point trips of a chain (solver/sip.py, ops/kkt.py): every trip factors
    1 + max_factor_retries times (each retry refactors every scenario), and
    each factorization solves the p θ columns (one stagewise solve per
    column); one solve per trip plus one per refinement step; the fused
    probe once per chunk of the backtracking budget."""
    factors = (1 + settings.max_factor_retries) * trips
    solves = factors * p + (1 + settings.iterative_refinement_steps) * trips
    ls = settings.line_search
    probes = (-(-ls.max_steps // max(1, ls.chunk)) * trips
              if ls.fused_probe else 0)
    return {"riccati_factor": factors, "riccati_solve_bwd": solves,
            "riccati_solve_fwd": solves, "ls_probe": probes}


def check_launches(label, got, want):
    """Every counter at `want`'s value (0 where `want` has none)."""
    for name, count in got.items():
        exp = want.get(name, 0)
        log(f"launches[{label}][{name}] = {count} (expected {exp})")
        if count != exp:
            raise AssertionError(f"{name}: {count} launches on the {label} "
                                 f"path, expected {exp}")


def riccati_path_records(device, label, T, n, m, seed, data=None):
    """The factor and both solve kernels at a path's shape (B=BATCH,
    horizon T, (n, m)) on random float32 chain data (or `data`): each
    against its twin (FACTOR_TOL, SOLVE_TOL), timed beside its twin and
    bound, with its device ms per launch, launch configuration and ptxas
    line.  Returns {name: record}."""
    import torch
    from sip_optimal_control_tpu_torch.ops import riccati_cuda as rc
    if data is None:
        data = random_chain(T, n, m, BATCH, seed, device)
    factor = "riccati_factor_gram" if n >= rc.GRAM_N else "riccati_factor"
    fact_t = rc.factor_chain_reference(data)
    bwd_in = (data.q, data.r, data.c, data.delta, fact_t.F_chol,
              fact_t.G_chol, fact_t.K, data.A, data.B)
    k_t, v_t = rc.solve_bwd_kernel_reference(*bwd_in)
    x_root = torch.randn(BATCH, n, device=device,
                         generator=torch.Generator(device).manual_seed(seed))
    fwd_in = (x_root, k_t, fact_t.K, data.A, data.B, data.c, data.delta,
              torch.cat([v_t, data.q[:, -1:]], dim=1), fact_t.V,
              fact_t.F_chol)
    cases = {factor: ((data.Q, data.delta, data.A, data.B, data.M, data.R),
                      FACTOR_TOL),
             "riccati_solve_bwd": (bwd_in, SOLVE_TOL),
             "riccati_solve_fwd": (fwd_in, SOLVE_TOL)}
    errs = {}
    for name, (args, tol) in cases.items():
        fn, twin = rc.KERNELS[name][:2]
        errs[name], _ = compare(label, name, fn(*args), twin(*args), tol,
                                slice(None))
    dev = kernel_device_ms([lambda fn=rc.KERNELS[name][0], args=args:
                            fn(*args) for name, (args, _) in cases.items()],
                           "void riccati::",
                           {name: RICCATI_NAMES[name] for name in cases})
    lib = rc.build_library()[0]
    out = {}
    for name, (args, _) in cases.items():
        fn, twin, source, replaces = rc.KERNELS[name]
        cfg = rc.launch_config(rc._library(), name, n, m, BATCH)
        entry = f"{RICCATI_NAMES[name]}ILi{n}ELi{m}E"
        log(f"launch[{name} {label} ({n}, {m})] B={BATCH}: "
            f"{json.dumps(cfg)}; ptxas {ptxas_line(lib, entry)}")
        rec = kernel_record(name, errs[name], fn, twin, args,
                            BATCH * T * _riccati_flops(name, n, m), source,
                            replaces)
        rec["device_ms"] = dev[RICCATI_NAMES[name]]
        log(f"time[{name} {label}] B={BATCH} T={T} n={n} m={m}: kernel "
            f"wrapper {rec['ms']:.4f} ms, device {rec['device_ms']:.4f} ms "
            f"per launch, plain twin {rec['plain_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); max|kernel - "
            f"twin| {errs[name]:.3e}")
        out[name] = rec
    return out


def probe_path_record(device, fspec, fbounds, dims, chunk, label, seed):
    """The chain probe generated for a path's model at the path's chunk,
    B=BATCH, the candidates in the solver's transposed layout: against its
    twin (probe_match), timed beside its twin and bound, with its device
    ms per launch, launch configuration and ptxas line."""
    import torch
    from sip_optimal_control_tpu_torch.ops import ls_probe
    fn = ls_probe.make_fused_probe(fspec, fbounds)

    def twin(*a):
        return ls_probe.probe_reference(fspec, fbounds, *a)

    args = probe_inputs(dims, BATCH, seed, device)
    args = args[:5] + (args[5][:, :chunk].t().contiguous().t(),)
    got, want = fn(*args), twin(*args)
    torch.cuda.synchronize()
    err = probe_match(f"probe[{label}]", got, want)
    lib = ls_probe.build_library(fspec, fbounds)[0]
    log(f"launch[ls_probe {label}] B={BATCH}: "
        f"{json.dumps(ls_probe.launch_config(lib, BATCH))}; ptxas "
        f"{ptxas_line(lib, 'probe_kernel')}")
    source, replaces = ls_probe.KERNELS["ls_probe"]
    rec = kernel_record("ls_probe", err, fn, twin, args,
                        BATCH * chunk * probe_flops(fspec, fbounds), source,
                        replaces)
    rec["device_ms"] = kernel_device_ms(
        [lambda: fn(*args)], "void ls_probe::",
        {"ls_probe": "probe_kernel"}, reps=20)["probe_kernel"]
    log(f"time[ls_probe {label}] B={BATCH} chunk={chunk} "
        f"T={fspec.horizon}: kernel wrapper {rec['ms']:.4f} ms, device "
        f"{rec['device_ms']:.4f} ms per launch, plain twin "
        f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}); max|kernel - twin| {err:.3e}")
    return rec


def kernel_busy_ms(records, launches):
    """The hand-written kernels' device ms over `launches`: launches times
    each kernel's device ms per launch at the path's shape."""
    return sum(launches.get(name, 0) * rec["device_ms"]
               for name, rec in records.items())


def run_quadrotor(device, smi):
    """Phase 8: run_mpc on the quadrotor (BASELINE config 4) at B=BATCH.
    Returns (records {kernel: record at the path's shape}, launches)."""
    import torch
    from sip_optimal_control_tpu_torch import build_problem
    label = "quadrotor run_mpc"
    model, x0s = quad_inputs(device)
    prob = build_problem(*model[:3], x0s, *model[3:])
    if prob.fused_ls is None:
        raise AssertionError("quadrotor: not eligible for the fused probe")
    dims = model[1]
    n, m, T = dims.max_state_dim, dims.max_control_dim, dims.num_edges
    records = riccati_path_records(device, "quadrotor", T, n, m, seed=80)
    settings = quad_settings("cuda")
    records["ls_probe"] = probe_path_record(
        device, *prob.fused_ls[:2], dims, max(1, settings.line_search.chunk),
        "quadrotor_mpc", seed=81)

    # step 1 on the kernels against "scan" with the standard probe
    step1 = {"scan": step1_view(quad_run(model, x0s, "scan", 1, False)),
             "cuda": step1_view(quad_run(model, x0s, "cuda", 1))}
    agree = compare_step1(step1, label=label, iter_tol=QUAD["iter_tol"])
    if agree < SCAN_AGREEMENT:
        raise AssertionError(f"{label}: step-1 agreement {agree} < "
                             f"{SCAN_AGREEMENT}")

    steps = QUAD["steps"]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    t0 = time.perf_counter()
    start.record()
    trace = quad_run(model, x0s, "cuda", steps)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = read_counts()
    ev_s = start.elapsed_time(end) / 1e3

    if tuple(trace.statuses.shape) != (steps, BATCH):
        raise AssertionError(f"statuses shape {tuple(trace.statuses.shape)}")
    if not (torch.isfinite(trace.states).all()
            and torch.isfinite(trace.controls).all()):
        raise AssertionError(f"{label}: non-finite states or controls")
    # trips a step: the loop runs while any scenario is RUNNING
    trips = int(trace.iterations.amax(1).sum())
    check_launches(label, launches, solver_launches(settings, trips))
    use = float(usable(trace).float().mean())
    solved = float((trace.statuses == 0).float().mean())
    target = torch.tensor(QUAD["target"], device=device)
    pos_err = (trace.states[-1, :, :2] - target).norm(dim=-1)
    iters = trace.iterations.float()
    log(f"quality [{label}]: usable on {use:.4f} of the (step, scenario) "
        f"pairs (bar {QUAD_USABLE}), SOLVED on {solved:.4f}; mean "
        f"iterations {float(iters.mean()):.3f} (step 1 "
        f"{float(iters[0].mean()):.3f}, steps 21-100 "
        f"{float(iters[20:].mean()):.3f}); final position error median "
        f"{float(pos_err.median()):.4f} max {float(pos_err.max()):.4f} m")
    if use < QUAD_USABLE:
        raise AssertionError(f"{label}: usable {use} < {QUAD_USABLE}")
    solves = BATCH * steps
    busy = kernel_busy_ms(records, launches)
    log(f"path [{label}] ({smi}): {steps} steps, batch {BATCH}: "
        f"{ev_s:.3f} s CUDA events / {host_s:.3f} s host -> "
        f"{solves / ev_s:.1f} solves/s, {1e3 * ev_s / steps:.2f} ms per MPC "
        f"step, {trips} trips ({trips / steps:.2f} per step, "
        f"{1e3 * ev_s / trips:.2f} ms per trip); the port's kernels "
        f"{busy / steps:.3f} ms of device time per step "
        f"({json.dumps({k: v / steps for k, v in launches.items() if v})} "
        f"launches per step)")

    # run_mpc_timed at a budget that cuts the loop short: its prefix is
    # run_mpc's first steps
    budget = QUAD["budget_share"] * host_s
    cut = quad_run(model, x0s, "cuda", steps, budget=budget)
    k = cut.controls.shape[0]
    if not 0 < k < steps:
        raise AssertionError(f"{label}: run_mpc_timed at {budget:.3f} s ran "
                             f"{k} of {steps} steps")
    if not torch.equal(cut.statuses, trace.statuses[:k]):
        raise AssertionError(f"{label}: run_mpc_timed's statuses differ")
    err, _ = compare(label, "run_mpc_timed prefix states",
                     (cut.states,), (trace.states[:k + 1],), SOLVE_TOL,
                     slice(None))
    log(f"run_mpc_timed [{label}] budget {budget:.3f} s: {k} of {steps} "
        f"steps, statuses identical to run_mpc's, states within "
        f"{err:.3e}")
    log(json.dumps({label: {
        "solves_per_s": solves / ev_s, "step_ms": 1e3 * ev_s / steps,
        "trips_per_step": trips / steps, "kernel_device_ms_per_step":
        busy / steps, "usable_frac": use, "solved_frac": solved,
        "mean_iterations": float(iters.mean()),
        "final_pos_err_median": float(pos_err.median()),
        "step1_agreement": agree, "timed_prefix_steps": k}}))
    return records, launches


def joint_inputs(device, dtype=None):
    """shared_theta_chain at JOINT's horizon in `dtype` (float32) on
    `device` and the bench's start states: standard normal draws with
    seed 0 rounded to float32 (bench.py:357-359)."""
    import torch
    from sip_optimal_control_tpu_torch.models import shared_theta_chain
    dtype = dtype or torch.float32
    model = shared_theta_chain(horizon=JOINT["horizon"], dtype=dtype,
                               device=device)
    x0s = np.random.default_rng(0).standard_normal((BATCH, 2))  # S = BATCH
    return model, torch.as_tensor(x0s.astype(np.float32),
                                  device=device).to(dtype)


def joint_settings(backend):
    """bench.py --mode joint-theta's settings (bench.py:352-353)."""
    from sip_optimal_control_tpu_torch import Settings
    return Settings(max_iterations=100, tol=1e-3, mu_min=1e-5,
                    reg_floor=1e-5, prox_reg=1e-5, riccati_backend=backend)


def joint_call(model, x0s, backend, mesh=None):
    """The coupled solve of `x0s` (this rank's rows on `mesh`)."""
    from sip_optimal_control_tpu_torch import solve_joint_theta
    return solve_joint_theta(*model[:3], x0s, joint_settings(backend), mesh,
                             *model[3:])


def run_joint_theta(device, smi):
    """Phase 9: the coupled joint-θ solve (bench.py --mode joint-theta) at
    S=BATCH.  Returns (records {kernel: record at the path's shape},
    launches, (the float32 and float64 "scan" solves))."""
    import torch
    label = "joint_theta"
    model, x0s = joint_inputs(device)
    dims = model[1]
    n, m, T, p = (dims.max_state_dim, dims.max_control_dim,
                  dims.num_edges, dims.theta_dim)
    records = riccati_path_records(device, label, T, n, m, seed=90)

    warm = joint_call(model, x0s, "cuda")
    scan32 = joint_call(model, x0s, "scan")
    model64, x64 = joint_inputs(device, torch.float64)
    scan64 = joint_call(model64, x64, "scan")
    for name, res in (("cuda", warm), ("scan", scan32),
                      ("scan float64", scan64)):
        th = res.vars.theta
        log(f"solve [{label}] {name}: status SOLVED on "
            f"{float((res.status == 0).float().mean()):.4f}, iterations "
            f"{int(res.iterations[0])}, KKT error "
            f"{float(res.kkt_error[0]):.3e}, theta {float(th[0, 0]):.7f}, "
            f"bit-identical on every scenario {bool((th == th[:1]).all())}")
    if not bool((warm.status == 0).all()):
        raise AssertionError(f"{label}: not every scenario SOLVED")
    if not bool((warm.vars.theta == warm.vars.theta[:1]).all()):
        raise AssertionError(f"{label}: theta differs across scenarios")
    err, detail = compare(label, "theta and controls",
                          (warm.vars.theta, warm.vars.u),
                          (scan32.vars.theta, scan32.vars.u), SOLVE_TOL,
                          slice(None), (scan64.vars.theta, scan64.vars.u))
    log(f"kernels vs scan [{label}]: max|cuda - scan| {err:.3e}{detail}")

    settings = joint_settings("cuda")
    times, want = [], {}
    reset_counts()
    for _ in range(JOINT["calls"]):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = joint_call(model, x0s, "cuda")
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
        # one joint problem: every scenario's iterations are the trips
        for name, v in solver_launches(settings, int(res.iterations[0]),
                                       p).items():
            want[name] = want.get(name, 0) + v
        if not bool((res.status == 0).all()):
            raise AssertionError(f"{label}: a timed call did not solve")
    launches = read_counts()
    check_launches(label, launches, want)
    best = min(times)
    trips = int(res.iterations[0])
    busy = kernel_busy_ms(records, launches) / JOINT["calls"]
    log(f"path [{label}] ({smi}): S={BATCH} coupled scenarios, horizon "
        f"{T}, theta_dim {p}: {trips} trips a solve; seconds per call "
        f"(CUDA events) [{', '.join(f'{t:.4f}' for t in times)}]; best "
        f"{best:.4f} s -> {BATCH / best:.1f} coupled scenarios/s, "
        f"{1e3 * best / trips:.2f} ms per trip; the port's kernels "
        f"{busy:.3f} ms of device time per solve")
    log(json.dumps({label: {
        "coupled_scenarios_per_s": BATCH / best, "solve_ms": 1e3 * best,
        "trips": trips, "kernel_device_ms_per_solve": busy,
        "theta": float(res.vars.theta[0, 0]), "max_err_vs_scan": err}}))
    return records, launches, (scan32, scan64)


# ---------------------------------------------------------------------------
# phase 10: variable dimensions and general constraints
# ---------------------------------------------------------------------------

DT = 0.1


def _stage_dims(state_dims, control_dims, node_c=None, node_g=None):
    from sip_optimal_control_tpu_torch import Dimensions
    N, E = len(state_dims), len(control_dims)
    return Dimensions(theta_dim=0, state_dims=tuple(state_dims),
                      control_dims=tuple(control_dims),
                      node_c_dims=tuple(node_c or (0,) * N),
                      node_g_dims=tuple(node_g or (0,) * N),
                      edge_c_dims=(0,) * E, edge_g_dims=(0,) * E)


def growing_state_problem(horizon):
    """tests/test_variable_dims_frontdoor.py:21-84's growing state at
    `horizon`: nodes before horizon // 2 carry [p, v], the rest add an
    integral state z with z' = z + dt p (costed from there on).  Returns
    (spec, dims, topology, lower, upper) with no bounds."""
    import torch
    from sip_optimal_control_tpu_torch import ModelSpec, Topology
    grow_at = horizon // 2

    def dynamics(x, u, th, i):
        # z's row is dead for children before grow_at; a parent's dead z
        # arrives as 0
        return torch.cat([x[:1] + DT * x[1:2], x[1:2] + DT * u[:1],
                          x[2:3] + DT * x[:1]])

    def node_cost(x, th, i):
        return 0.5 * (x[:1] ** 2 + 0.1 * x[1:2] ** 2 + torch.where(
            i >= grow_at, 0.5 * x[2:3] ** 2, 0.0)).sum()

    def edge_cost(x, u, th, i):
        return 0.05 * (u ** 2).sum()

    dims = _stage_dims([2 if k < grow_at else 3 for k in range(horizon + 1)],
                       [1] * horizon)
    return (ModelSpec(dynamics=dynamics, node_cost=node_cost,
                      edge_cost=edge_cost), dims, Topology.chain(horizon),
            None, None)


def constrained_problem(horizon, dtype, device):
    """tests/test_variable_dims_frontdoor.py:131-168's stage-varying
    constraints at `horizon`: a velocity cap v <= 0.6 at node 2 only, the
    final position pinned at 0.5, |u| <= 20.  Returns (spec, dims,
    topology, lower, upper)."""
    import torch
    from sip_optimal_control_tpu_torch import ModelSpec, Topology, box_bounds

    def dynamics(x, u, th, i):
        return torch.cat([x[:1] + DT * x[1:2], x[1:2] + DT * u[:1]])

    spec = ModelSpec(
        dynamics=dynamics,
        node_cost=lambda x, th, i: 0.5 * (x ** 2).sum(),
        edge_cost=lambda x, u, th, i: 0.05 * (u ** 2).sum(),
        node_ineq=lambda x, th, i: x[1:2] - CAP,
        node_eq=lambda x, th, i: x[:1] - PIN)
    N = horizon + 1
    dims = _stage_dims([2] * N, [1] * horizon,
                       node_c=[1 if k == horizon else 0 for k in range(N)],
                       node_g=[1 if k == 2 else 0 for k in range(N)])
    lower, upper = box_bounds(dims, u_lower=-U_MAX, u_upper=U_MAX,
                              dtype=dtype, device=device)
    return spec, dims, Topology.chain(horizon), lower, upper


# the constrained problem's velocity cap (node 2), pinned final position
# and control bound
CAP, PIN, U_MAX = 0.6, 0.5, 20.0
# phase 10: the padded LQR's (n_max, m_max) and seed; the front-door
# problems' horizon, iteration budget and KKT tolerance; the share of
# scenarios that must be SOLVED and agree with float64 "scan" (controls
# within QUAD's iter_tol (1 + |ref|), phase 8's rule); the pin's bar
VAR = dict(nm=(3, 2), seed=100, horizon=50, iterations=80, tol=1e-3,
           solved=0.99, agree=0.99, pin_tol=1e-3)


def padded_dims(T):
    """Phase 10(a)'s stage dims: node k has 1 + (k mod 3) states, edge e
    1 + (e mod 2) controls."""
    return _stage_dims([1 + k % 3 for k in range(T + 1)],
                       [1 + e % 2 for e in range(T)])


def _double(data):
    return dataclasses.replace(data, **{
        f.name: getattr(data, f.name).double()
        for f in dataclasses.fields(data)})


def check_padded_lqr(device):
    """Phase 10(a): random float32 chain data at (3, 2), padded to the
    stage dims of padded_dims, factored and solved on "scan" and "cuda":
    statuses identical, dead entries of x, u and y exactly 0 on both
    backends, live entries under compare's rule against float64 "scan",
    residuals logged.  Returns (records at the path's shape,
    launches of the "cuda" factor and solve)."""
    import torch
    from sip_optimal_control_tpu_torch import (Topology, compile_topology,
                                               lqr_factor, lqr_residual_norm,
                                               lqr_solve, pad_lqr_data)
    from sip_optimal_control_tpu_torch.ops.lqr import dimension_masks
    label, T = "padded_lqr", HORIZON
    n, m = VAR["nm"]
    dims = padded_dims(T)
    sched = compile_topology(Topology.chain(T))
    data = pad_lqr_data(random_chain(T, n, m, BATCH, VAR["seed"], device),
                        dims, sched)
    sols, status = {}, {}
    for backend in ("scan", "cuda"):
        if backend == "cuda":
            reset_counts()
        fact = lqr_factor(data, sched, backend)
        sols[backend] = lqr_solve(data, fact, sched, backend)
        status[backend] = fact.status
        if backend == "cuda":
            torch.cuda.synchronize()
            launches = read_counts()
    data64 = _double(data)
    ref = lqr_solve(data64, lqr_factor(data64, sched), sched)
    state_mask, control_mask = (torch.as_tensor(a, device=device)
                                for a in dimension_masks(dims))
    ok = status["scan"] == 0
    for backend, sol in sols.items():
        if not torch.equal(status[backend], status["scan"]):
            raise AssertionError(f"{label}: {backend} statuses differ from "
                                 "scan's")
        dead = [sol.x[:, ~state_mask], sol.y[:, ~state_mask],
                sol.u[:, ~control_mask]]
        if any(bool((t != 0).any()) for t in dead):
            raise AssertionError(f"{label}: {backend} has non-zero dead "
                                 "entries")
        detail = ""
        if backend != "scan":
            err, detail = compare(label, f"{backend} solution",
                                  (sol.x, sol.u, sol.y),
                                  (sols["scan"].x, sols["scan"].u,
                                   sols["scan"].y), SOLVE_TOL, ok,
                                  (ref.x, ref.u, ref.y))
            detail = f", max|{backend} - scan| {err:.3e}{detail}"
        res = lqr_residual_norm(data, sol, sched)
        log(f"{label} [{backend}] B={BATCH} T={T} (n, m)=({n}, {m}): "
            f"SUCCESS on {int(ok.sum())}/{BATCH}, dead entries exactly 0 "
            f"({int((~state_mask).sum())} of {state_mask.numel()} state and "
            f"{int((~control_mask).sum())} of {control_mask.numel()} control "
            f"entries a scenario), residual median "
            f"{float(res.median()):.3e} max {float(res.max()):.3e}{detail}")
    check_launches(label, launches, {"riccati_factor": 1,
                                     "riccati_solve_bwd": 1,
                                     "riccati_solve_fwd": 1})
    return riccati_path_records(device, label, T, n, m, VAR["seed"],
                                data=data), launches


def var_settings(backend):
    """Phase 10's front-door settings: convergence-tested, VAR's budget
    and tolerance, the float32 regularization floors of phases 8-9."""
    from sip_optimal_control_tpu_torch import Settings
    return Settings(max_iterations=VAR["iterations"], tol=VAR["tol"],
                    mu_min=1e-5, reg_floor=1e-5, prox_reg=1e-5,
                    riccati_backend=backend)


def var_starts(device, dtype, batch=None):
    """BATCH starts (0, 0) jittered as main_path_inputs jitters (seed 0,
    float32)."""
    import torch
    rng = np.random.default_rng(0)
    x0s = 0.1 * rng.standard_normal((batch or BATCH, 2)).astype(np.float32)
    return torch.as_tensor(x0s, device=device).to(dtype)


def var_solve(problem, x0s, backend, settings=None, **kw):
    from sip_optimal_control_tpu_torch import build_problem, solve
    spec, dims, topo, lower, upper = problem
    return solve(build_problem(spec, dims, topo, x0s, lower, upper),
                 settings or var_settings(backend), **kw)


def var_problem(label, dtype, device):
    T = VAR["horizon"]
    if label == "constrained":
        return constrained_problem(T, dtype, device)
    return growing_state_problem(T)


def run_var_path(device, label, smi, seed, batch=None):
    """Phase 10(b) ("constrained") and (c) ("growing_state") at B=BATCH on
    "cuda" in float32: SOLVED on VAR's share, the constraints on those, the
    controls against float64 "scan" on the same starts, the dead states
    exactly 0, launches as solver_launches counts.  Returns (records at
    the path's shape, launches, result)."""
    import torch
    batch = batch or BATCH
    T = VAR["horizon"]
    problem = var_problem(label, torch.float32, device)
    dims = problem[1]
    n, m = dims.max_state_dim, dims.max_control_dim
    x0s = var_starts(device, torch.float32, batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    res = var_solve(problem, x0s, "cuda")
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    trips = int(res.iterations.max())
    check_launches(label, launches, solver_launches(var_settings("cuda"),
                                                    trips))
    if not all(bool(torch.isfinite(t).all()) for t in res.vars):
        raise AssertionError(f"{label}: non-finite iterate")
    ref = var_solve(var_problem(label, torch.float64, device),
                    x0s.double(), "scan")
    solved = res.status == 0
    agree = ((res.vars.u.double() - ref.vars.u).abs()
             <= QUAD["iter_tol"] * (1 + ref.vars.u.abs())).flatten(1).all(-1)
    x, u = res.vars.x[solved], res.vars.u[solved]
    checks = {}
    if label == "constrained":
        checks = {
            "cap": float((x[:, 2, 1] - CAP).max()),
            "pin": float((x[:, T, 0] - PIN).abs().max()),
            "bound": float((u.abs() - U_MAX).max())}
        if not (checks["cap"] <= VAR["tol"] and checks["bound"] <= 0
                and checks["pin"] <= VAR["pin_tol"]):
            raise AssertionError(f"{label}: constraints violated {checks}")
    else:
        dead = res.vars.x[:, :T // 2, 2]
        checks = {"dead_states_nonzero": int((dead != 0).sum())}
        if checks["dead_states_nonzero"]:
            raise AssertionError(f"{label}: dead states not exactly 0")
    share, share_agree = (float(solved.float().mean()),
                          float(agree.float().mean()))
    ms = start.elapsed_time(end)
    log(f"path [{label}] ({smi}): B={batch} T={T} kernel shape (n, m)=({n}, "
        f"{m}) float32 cuda: SOLVED on {share:.4f} (bar {VAR['solved']}; "
        f"float64 scan {float((ref.status == 0).float().mean()):.4f}), "
        f"controls within {QUAD['iter_tol']} (1 + |ref|) of float64 scan "
        f"on {share_agree:.4f} (bar {VAR['agree']}); {trips} trips, "
        f"mean iterations {float(res.iterations.float().mean()):.3f}; "
        f"{ms:.1f} ms (CUDA events); checks on the SOLVED scenarios "
        f"{json.dumps(checks)}")
    if share < VAR["solved"] or share_agree < VAR["agree"]:
        raise AssertionError(f"{label}: SOLVED {share}, agreement "
                             f"{share_agree}")
    records = riccati_path_records(device, label, T, n, m, seed)
    return records, launches, res


CHANNEL = re.compile(r"derivative check \(central FD, eps=([\d.e+-]+)\): "
                     r"gradient=([\d.e+-]+) jacobian_c=([\d.e+-]+) "
                     r"jacobian_g=([\d.e+-]+) hessian=([\d.e+-]+)")
DERIV_TOL = 1e-6       # tests/test_solver_extras.py:245-247


def check_var_extras(device, constrained):
    """Phase 10(d)-(e): the checkpoint of the constrained result re-solved
    bit for bit, the derivative-check channel at B=1 in float64."""
    import contextlib
    import io
    import tempfile
    import torch
    from sip_optimal_control_tpu_torch import Settings
    from sip_optimal_control_tpu_torch.ops import cuda_build
    from sip_optimal_control_tpu_torch.solver.settings import \
        LoggingSettings
    from sip_optimal_control_tpu_torch.utils import (load_warm_start,
                                                     save_warm_start)

    # (d) checkpoint: a warm re-solve from the loaded file equals the one
    # from the tensors in memory, bit for bit
    problem = var_problem("constrained", torch.float32, device)
    x0s = var_starts(device, torch.float32)
    os.makedirs(cuda_build.BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_ROOT) as tmp:
        path = os.path.join(tmp, "warm.npz")
        save_warm_start(path, constrained.vars, constrained.y)
        vars, y = load_warm_start(path, device=device)
    warm = dataclasses.replace(var_settings("cuda"), max_iterations=10,
                               mu_init=1e-4)
    resumed = var_solve(problem, x0s, "cuda", warm, init_vars=vars,
                        init_y=y)
    mem = var_solve(problem, x0s, "cuda", warm, init_vars=constrained.vars,
                    init_y=constrained.y)
    same = all(torch.equal(a, b) for a, b in
               zip(tuple(vars) + tuple(y),
                   tuple(constrained.vars) + tuple(constrained.y)))
    same_solve = all(torch.equal(a, b) for a, b in
                     zip(tuple(resumed.vars) + (resumed.status,
                                                resumed.iterations),
                         tuple(mem.vars) + (mem.status, mem.iterations)))
    log(f"checkpoint [constrained]: loaded onto {vars.x.device} "
        f"{vars.x.dtype}, equal to the saved tensors {same}; warm re-solve "
        f"from the file equal to the in-memory one, bit for bit, "
        f"{same_solve} (SOLVED on "
        f"{float((resumed.status == 0).float().mean()):.4f})")
    if not (same and same_solve):
        raise AssertionError("checkpoint: the loaded warm start differs")

    # (e) the derivative-check channel, one scenario in float64
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        var_solve(var_problem("constrained", torch.float64, device),
                  var_starts(device, torch.float64, 1), "scan",
                  Settings(max_iterations=VAR["iterations"], logging=
                           LoggingSettings(print_derivative_check_logs=True)))
    lines = CHANNEL.findall(out.getvalue())
    if len(lines) != 1:
        raise AssertionError(f"derivative check: {out.getvalue()!r}")
    errs = [float(v) for v in lines[0][1:]]
    log(f"derivative check [constrained, B=1, float64]: "
        f"{out.getvalue().strip()} (bar {DERIV_TOL})")
    if not max(errs) < DERIV_TOL:
        raise AssertionError(f"derivative check errors {errs}")


# ---------------------------------------------------------------------------
# phase 11: scenario sharding over processes (BASELINE config 5)
# ---------------------------------------------------------------------------

# bench.py --mode scaling (bench.py:288-290, :304-305): cold solves of
# robust_tree h50 (main_path_inputs) from its start jittered by 0.05 with
# seed 0, the tree probe on 6 candidates a chunk; (b) and (c) in RANKS
# gloo processes on the one card, each process group with a timeout (a
# collective that waits longer raises)
SHARD = dict(ranks=4, jitter=0.05, group_timeout_s=60, worker_timeout_s=420)


def shard_settings():
    """bench.py --mode scaling's cold settings (bench.py:288-290) with
    the tree probe kernel (chunk 6)."""
    from sip_optimal_control_tpu_torch import Settings
    from sip_optimal_control_tpu_torch.solver.settings import \
        LineSearchSettings
    return Settings(max_iterations=100, tol=1e-3, mu_min=1e-5,
                    reg_floor=1e-5, prox_reg=1e-5,
                    line_search=LineSearchSettings(fused_probe=True,
                                                   chunk=CHUNK))


def shard_inputs(device):
    """The robust_tree model of the paths and the scaling mode's global
    batch of B=BATCH starts."""
    model, (x0s, _, _) = main_path_inputs(device, BATCH, "robust_tree",
                                          jitter=SHARD["jitter"])
    return model, x0s


def sharded_call(model, x0s, mesh):
    """solve_batch_sharded of this rank's rows `x0s` on `mesh`."""
    from sip_optimal_control_tpu_torch import solve_batch_sharded
    return solve_batch_sharded(*model[1:4], x0s, shard_settings(), mesh,
                               *model[4:])


def events_ms(fn):
    """(fn(), its CUDA-event ms)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _group(backend, store, rank, world, device=None):
    import datetime
    import torch.distributed as dist
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SHARD["group_timeout_s"]),
        device_id=device)


def run_sharded_one(device, smi):
    """Phase 11(a): solve_batch_sharded over NCCL with a world of 1 in this
    process, against solve on the same batch: controls and statuses bit
    for bit, the statistics the host's reductions of that result, usable
    on >= QUALITY_USABLE, the tree probe's launches those of solve.  Both
    solves run in PyTorch's deterministic mode, which adds a tree's
    children into their parent in a fixed order (index_add's CUDA atomics
    otherwise add them in any order).  Returns (the plain solve's result,
    launches of the sharded call)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from sip_optimal_control_tpu_torch import (build_problem, scenario_mesh,
                                               shard_scenarios, solve)
    from sip_optimal_control_tpu_torch.mpc import usable_solutions
    from sip_optimal_control_tpu_torch.ops import cuda_build
    label = "sharded robust_tree (a), NCCL world 1"
    model, x0s = shard_inputs(device)
    os.makedirs(cuda_build.BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_ROOT) as tmp:
        _group("nccl", os.path.join(tmp, "store"), 0, 1, device)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            mesh = scenario_mesh(device=device)
            local = shard_scenarios(x0s, mesh)
            # the stage programs traced once, outside the timed calls
            build_problem(*model[1:4], local, *model[4:])
            reset_counts()
            res, plain_ms = events_ms(lambda: solve(
                build_problem(*model[1:4], local, *model[4:]),
                shard_settings()))
            plain_launches = read_counts()
            reset_counts()
            (u, status, stats), ms = events_ms(
                lambda: sharded_call(model, local, mesh))
            launches = read_counts()
        finally:
            torch.use_deterministic_algorithms(False)
            dist.destroy_process_group()
    same = torch.equal(u, res.vars.u) and torch.equal(status, res.status)
    host = (int((res.status == 0).sum()), float(res.kkt_error.max()),
            float(res.iterations.float().mean()))
    got = (int(stats.total_solved), float(stats.max_kkt_error),
           float(stats.mean_iterations))
    use = float(usable_solutions(res).float().mean())
    solved = float((res.status == 0).float().mean())
    log(f"path [{label}] ({smi}): B={BATCH}, {int(res.iterations.max())} "
        f"trips (mean {host[2]:.3f}); controls and statuses bit-identical "
        f"to solve {same}; stats {got} against the host's {host}; usable "
        f"{use:.4f} (bar {QUALITY_USABLE}), solved_frac {solved:.4f}; "
        f"{ms:.1f} ms per solve sharded, {plain_ms:.1f} ms solve (CUDA "
        f"events, deterministic mode); launches {json.dumps(launches)}, "
        f"solve's {json.dumps(plain_launches)}")
    if not same:
        raise AssertionError(f"{label}: differs from solve")
    if got != host:
        raise AssertionError(f"{label}: stats {got} != host {host}")
    if use < QUALITY_USABLE:
        raise AssertionError(f"{label}: usable {use} < {QUALITY_USABLE}")
    if not (launches["ls_probe_tree"] > 0 and launches == plain_launches):
        raise AssertionError(f"{label}: launches {launches} against "
                             f"solve's {plain_launches}")
    return res, launches


def shard_worker(rank, world, store, out_dir, device="cuda:0"):
    """Phase 11(b)-(c), one rank: gloo on `device` (every rank on the one
    card).
    (b) this rank's rows of phase 11's batch through solve_batch_sharded;
    (c) its rows of phase 9's joint-θ batch as one coupled solve over the
    ranks, after a warm-up call.  Each with the counts set to 0 just
    before it and read just after; saves the results for the parent."""
    import torch
    import torch.distributed as dist
    from sip_optimal_control_tpu_torch import (build_problem, scenario_mesh,
                                               shard_scenarios)
    from sip_optimal_control_tpu_torch.ops import ls_probe
    from sip_optimal_control_tpu_torch.ops import riccati_cuda as rc
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    _group("gloo", store, rank, world)
    try:
        mesh = scenario_mesh(device=device)
        model, x0s = shard_inputs(device)
        local = shard_scenarios(x0s, mesh)
        prob = build_problem(*model[1:4], local, *model[4:])
        # the libraries phase 2 built: loaded, never built here
        for name, built in (("ls_probe_tree",
                             ls_probe.build_library(*prob.fused_ls[:2])),
                            ("riccati", rc.build_library())):
            if built[1] > 0:
                raise AssertionError(f"rank {rank}: built {name}")
        reset_counts()
        (u, status, stats), ms_b = events_ms(
            lambda: sharded_call(model, local, mesh))
        launches_b = read_counts()

        jmodel, jx0s = joint_inputs(device)
        jlocal = shard_scenarios(jx0s, mesh)
        joint_call(jmodel, jlocal, "cuda", mesh)
        reset_counts()
        res, ms_c = events_ms(lambda: joint_call(jmodel, jlocal, "cuda",
                                                 mesh))
        launches_c = read_counts()
    finally:
        dist.destroy_process_group()
    torch.save({"b": dict(u=u.cpu(), status=status.cpu(),
                          stats=[t.cpu() for t in stats], ms=ms_b,
                          launches=launches_b),
                "c": dict(theta=res.vars.theta.cpu(), u=res.vars.u.cpu(),
                          status=res.status.cpu(),
                          it=res.iterations.cpu(), ms=ms_c,
                          launches=launches_c)},
               os.path.join(out_dir, f"rank{rank}.pt"))


def _run_shard_workers(out_dir):
    """Starts the RANKS worker processes of phase 11(b)-(c) and waits for
    them; any failure or timeout raises, and every process is stopped.
    Returns each rank's saved results."""
    import torch
    world = SHARD["ranks"]
    store = os.path.join(out_dir, "store")
    procs, logs = [], []
    try:
        for rank in range(world):
            logs.append(os.path.join(out_dir, f"rank{rank}.log"))
            with open(logs[-1], "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--shard-worker", str(rank), str(world), store,
                     out_dir], stdout=fh, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + SHARD["worker_timeout_s"]
        for rank, proc in enumerate(procs):
            try:
                code = proc.wait(timeout=max(1.0,
                                             deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                code = "timeout"
            if code != 0:
                with open(logs[rank]) as fh:
                    tail = fh.read()[-4000:]
                raise AssertionError(f"phase 11 rank {rank}: exit {code}\n"
                                     f"{tail}")
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    for path in logs:
        with open(path) as fh:
            text = fh.read().strip()
        if text:
            log(f"[{os.path.basename(path)}] {text[-2000:]}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def run_sharded_ranks(device, smi, ref_a, joint_refs):
    """Phase 11(b)-(c) in SHARD["ranks"] gloo processes on cuda:0.  (b):
    statuses equal to (a)'s rows on >= SCAN_AGREEMENT of the scenarios and
    the controls within QUAD's iter_tol (1 + |ref|) on those, every rank's
    statistics identical, the solved count the ranks' sum.  (c): θ, status
    and iterations bit-identical on every rank, θ and the controls within
    phase 9's bar against float64 "scan", each rank's Riccati launches
    solver_launches' count.  Returns each rank's launches of (b) and
    (c)."""
    import tempfile
    import torch
    from sip_optimal_control_tpu_torch.ops import cuda_build
    world = SHARD["ranks"]
    os.makedirs(cuda_build.BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_ROOT) as tmp:
        ranks = _run_shard_workers(tmp)

    label = f"sharded robust_tree (b), {world} gloo ranks on one card"
    b = [r["b"] for r in ranks]
    status = torch.cat([r["status"] for r in b])
    u = torch.cat([r["u"] for r in b])
    ref_status, ref_u = ref_a.status.cpu(), ref_a.vars.u.cpu()
    same = status == ref_status
    close = ((u - ref_u).abs() <= QUAD["iter_tol"] * (1 + ref_u.abs())) \
        .flatten(1).all(-1)
    agree = float((same & close).float().mean())
    stats_same = all(torch.equal(x, y) for r in b[1:]
                     for x, y in zip(r["stats"], b[0]["stats"]))
    solved = int((status == 0).sum())
    total = int(b[0]["stats"][0])
    log(f"path [{label}] ({smi}): B={BATCH}, {BATCH // world} per rank; "
        f"statuses equal to (a)'s and controls within {QUAD['iter_tol']} "
        f"(1 + |ref|) on {agree:.4f} (bar {SCAN_AGREEMENT}); stats "
        f"identical on every rank {stats_same}: total_solved {total} "
        f"(ranks' SOLVED {solved}), max_kkt_error "
        f"{float(b[0]['stats'][1]):.3e}, mean_iterations "
        f"{float(b[0]['stats'][2]):.3f}; ms per solve by rank (CUDA "
        f"events) {json.dumps([round(r['ms'], 1) for r in b])}; "
        f"ls_probe_tree launches by rank "
        f"{json.dumps([r['launches']['ls_probe_tree'] for r in b])}")
    if agree < SCAN_AGREEMENT or not stats_same or total != solved:
        raise AssertionError(f"{label}: agreement {agree}, stats identical "
                             f"{stats_same}, total {total} vs {solved}")
    for rank, r in enumerate(b):
        want = {"ls_probe_tree": r["launches"]["ls_probe_tree"]}
        if want["ls_probe_tree"] == 0:
            raise AssertionError(f"{label}: rank {rank} ran no tree probe")
        check_launches(f"{label} rank {rank}", r["launches"], want)

    label = f"joint_theta (c), {world} gloo ranks on one card"
    c = [r["c"] for r in ranks]
    ident = all(torch.equal(r[k], c[0][k][:1].expand_as(r[k]))
                for r in c for k in ("theta", "status", "it"))
    theta = torch.cat([r["theta"] for r in c])
    ju = torch.cat([r["u"] for r in c])
    scan32, scan64 = joint_refs
    trips = int(c[0]["it"][0])
    log(f"path [{label}] ({smi}): S={BATCH}, {BATCH // world} per rank; "
        f"theta {float(theta[0, 0]):.7f}, status "
        f"{int(c[0]['status'][0])}, {trips} trips, bit-identical on every "
        f"rank {ident}; SOLVED on "
        f"{float(torch.cat([r['status'] for r in c]).eq(0).float().mean()):.4f}; "
        f"ms per solve by rank (CUDA events) "
        f"{json.dumps([round(r['ms'], 1) for r in c])}")
    if not ident:
        raise AssertionError(f"{label}: theta, status or iterations differ "
                             "across ranks")
    err, detail = compare(label, "theta and controls", (theta, ju),
                          (scan32.vars.theta.cpu(), scan32.vars.u.cpu()),
                          SOLVE_TOL, slice(None),
                          (scan64.vars.theta.cpu(), scan64.vars.u.cpu()))
    log(f"kernels vs scan [{label}]: max|cuda - scan| {err:.3e}{detail}")
    want = solver_launches(joint_settings("cuda"), trips,
                           scan32.vars.theta.shape[-1])
    for rank, r in enumerate(c):
        check_launches(f"{label} rank {rank}", r["launches"], want)
    log(json.dumps({"sharded": {
        "b_ms_per_solve": [r["ms"] for r in b],
        "b_agreement": agree, "b_total_solved": total,
        "c_ms_per_solve": [r["ms"] for r in c], "c_trips": trips,
        "c_theta": float(theta[0, 0]), "c_max_err_vs_scan": err}}))
    return [r["launches"] for r in b], [r["launches"] for r in c]


# ---------------------------------------------------------------------------

# the phase of each path whose Riccati kernel records join the kernels line
PATH_PHASES = {"quadrotor": "8", "joint_theta": "9", "padded_lqr": "10(a)",
               "constrained": "10(b)", "growing_state": "10(c)"}


def build_all(device):
    """Phase 2: every kernel library of the paths and the fused check, one
    nvcc each, all started together."""
    from sip_optimal_control_tpu_torch import build_problem
    from sip_optimal_control_tpu_torch.ops import (cuda_build, fused_iter,
                                                   ls_probe)
    from sip_optimal_control_tpu_torch.ops import riccati_cuda as rc

    jobs = {"riccati": rc.build_library}
    for model in PATHS:
        prob, _ = path_problem(model, device, batch=1)
        fspec, fbounds, _ = prob.fused_ls
        jobs[f"ls_probe[{model}]"] = (
            lambda s=fspec, b=fbounds: ls_probe.build_library(s, b))
    qmodel, qx = quad_inputs(device, batch=1)
    quad = build_problem(*qmodel[:3], qx, *qmodel[3:])
    jobs["ls_probe[quadrotor_mpc]"] = (
        lambda s=quad.fused_ls[0], b=quad.fused_ls[1]:
        ls_probe.build_library(s, b))
    for model in FUSED_MODELS:
        _, ispec, rows = fused_model(model, device)
        jobs[f"fused_iter[{model}]"] = (
            lambda s=ispec, b=rows: fused_iter.build_library(s, b))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(fn) for name, fn in jobs.items()}
        for name, fut in futures.items():
            path, secs = fut.result()
            log(f"build[{name}]: {path} in {secs:.1f} s")
            if secs > 0:
                # ptxas -v: registers and spills
                log(cuda_build.ptxas_report(path))
    log(f"build: {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s "
        "wall")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        import sip_optimal_control_tpu_torch  # noqa: F401
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
    build_all(device)
    phase_done("build")

    # phase 3: kernels against their twins
    kernels = check_riccati(device)
    kernels["ls_probe"] = check_probe(device)
    kernels["ls_probe_tree"] = check_probe_tree(device)
    kernels.update(check_fused(device))
    phase_done("kernels")

    # phases 4 to 7: the paths, each with the counts set to 0 just before
    # its timed calls and read just after
    launches, scan_first = {}, {}
    for fused in (False, True):
        for model in CHAIN_PATHS:
            # the fused path's first call is held against the same scan
            # call as the standard path's (same start state)
            res = run_path(device, model, fused=fused,
                           scan_first=scan_first.get(model))
            scan_first[model] = res["scan_first"]
            q = check_path(res)
            report_path(res, q)
            launches[path_label(res)] = res["launches"]
            phase_done(f"path {path_label(res)}")
    res = run_path(device, "robust_tree")
    report_path(res, check_path(res))
    launches["robust_tree"] = res["launches"]
    phase_done("path robust_tree")

    # phases 8 and 9: the counts set to 0 just before each path's measured
    # run and read just after
    path_records = {}
    path_records["quadrotor"], launches["quadrotor"] = run_quadrotor(device,
                                                                     smi)
    phase_done("path quadrotor")
    path_records["joint_theta"], launches["joint_theta"], joint_refs = \
        run_joint_theta(device, smi)
    phase_done("path joint_theta")

    # phase 10: variable dimensions and general constraints, each run with
    # the counts set to 0 just before it and read just after
    path_records["padded_lqr"], launches["padded_lqr"] = \
        check_padded_lqr(device)
    phase_done("padded_lqr")
    results = {}
    for seed, label in enumerate(("constrained", "growing_state"), 102):
        path_records[label], launches[label], results[label] = \
            run_var_path(device, label, smi, seed)
        phase_done(f"path {label}")
    check_var_extras(device, results["constrained"])
    phase_done("checkpoint, derivative check")

    # phase 11: scenario sharding; each sub-phase with the counts set to 0
    # just before it and read just after (by each rank, in its process)
    ref_a, launches_a = run_sharded_one(device, smi)
    phase_done("sharded (a)")
    launches_b, launches_c = run_sharded_ranks(device, smi, ref_a,
                                               joint_refs)
    phase_done("sharded (b), (c)")

    rows = []
    for kname in ("riccati_factor", "riccati_factor_gram",
                  "riccati_solve_bwd", "riccati_solve_fwd", "ls_probe",
                  "ls_probe_tree", "fused_factor", "fused_solve_bwd",
                  "fused_solve_fwd", "fused_eval"):
        rec = kernels[kname]
        fused = " fused" if kname.startswith("fused") else ""
        first = {"riccati_factor_gram": "chain16",
                 "ls_probe_tree": "robust_tree"}.get(kname, "cartpole")
        rec["launches"] = launches[first + fused][kname]
        if "chain16" in rec:
            rec["chain16"]["launches"] = launches["chain16" + fused][kname]
        if "quadrotor" in rec:
            # the fused kernels' quadrotor check: phase 8's path takes the
            # standard iteration
            rec["quadrotor"]["launches"] = launches["quadrotor"][kname]
            rec["quadrotor"]["path"] = "quadrotor run_mpc (phase 8)"
        # the standard iteration's kernels on phases 8-10, at each path's
        # shape
        for label, recs in path_records.items():
            if kname in recs:
                rec[label] = dict(recs[kname],
                                  launches=launches[label][kname],
                                  path=f"{label} (phase "
                                  f"{PATH_PHASES[label]})")
        # phase 11's launches: (a) this process, (b) and (c) by rank
        rec["phase_11"] = {
            "path": "(a) sharded robust_tree, NCCL world 1; (b) the same "
                    f"over {SHARD['ranks']} gloo ranks; (c) joint theta "
                    f"over {SHARD['ranks']} gloo ranks",
            "a": launches_a[kname],
            "b": [counts[kname] for counts in launches_b],
            "c": [counts[kname] for counts in launches_c]}
        rows.append(rec)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-worker"]:
        # one rank of phase 11(b)-(c), started by _run_shard_workers
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        shard_worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])
        sys.exit(0)
    sys.exit(main())
