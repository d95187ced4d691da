"""The fused trip's line-search prologue (ops/ls_probe.py::ls_prologue).

The twin (``ls_prologue_reference``) against the PyTorch block that
solver/fused_chain.py ran before the prologue kernel, kept here verbatim as
the oracle (``block``): every output bit for bit, NaN where the block's is
NaN, on random float32 data at the cartpole's shape (control bounds only),
a shape with finite state bounds on some rows and chain16's, and with a
lane whose direction is scrubbed to zero, lanes with a NaN, a lane whose
residuals are zero (theta0 == 0) and a lane outside its bounds.

Then csrc/ls_prologue.cu compiled by the host C++ compiler against
tests/host_cuda/cuda_runtime.h (every GPU thread an OS thread, the launch
rewritten into the stand-in's ``emu_launch``) and called through the real
wrapper with CPU tensors: the step limits bit-equal to the twin's, the
sums within 1e-5 of the sum of their terms' magnitudes, NaN and inf where
the twin's are, one launch counted a call, on operands read 16 bytes a
lane and, misaligned, 4 bytes a lane; and one fused cartpole solve through
the kernel against one through the twin.  Skips the host cases without a
C++20 compiler.
"""

import contextlib
import math
import os
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch import models as pm
from sip_optimal_control_tpu_torch._tree import (lane_view, tree_leaves,
                                                 tree_map)
from sip_optimal_control_tpu_torch.ops import cuda_build, ls_probe
from sip_optimal_control_tpu_torch.solver import fused_chain
from sip_optimal_control_tpu_torch.solver.settings import \
    LineSearchSettings as PLS
from sip_optimal_control_tpu_torch.solver.sip import (_EPS, Primal, _lmin,
                                                      _lsum, _tdot, _tsum)

STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "host_cuda")
B, TAU_MIN = 37, 0.99
# the sums' bar: relative to the sum of their terms' magnitudes
SUM_TOL = 1e-5
INF = math.inf

# name -> (T, n, m, lower x, upper x, lower u, upper u): [N, n] / [E, m]
# arrays of the bounds shared by every scenario
SHAPES = {
    # T = 50: 204 state rows, more than a warp's pass of 128; 50 control
    # rows, read 4 bytes a lane
    "cartpole": (50, 4, 1, lambda N, n: np.full((N, n), -INF),
                 lambda N, n: np.full((N, n), INF),
                 lambda E, m: np.full((E, m), -10.0),
                 lambda E, m: np.full((E, m), 10.0)),
    # state bounds on some rows and columns, one-sided control bounds;
    # 27 state rows (4 bytes a lane), 16 control rows (16 bytes a lane)
    "state_bounds": (8, 3, 2,
                     lambda N, n: np.where(
                         (np.arange(N)[:, None] >= 1)
                         & (np.arange(n)[None] == 0), -5.0, -INF),
                     lambda N, n: np.where(
                         (np.arange(N)[:, None] >= 3)
                         & (np.arange(N)[:, None] <= 6)
                         & (np.arange(n)[None] == 2), 4.0, INF),
                     lambda E, m: np.where(np.arange(m)[None] == 1, -1.5,
                                           -INF) + np.zeros((E, m)),
                     lambda E, m: np.where(np.arange(m)[None] == 0, 2.0,
                                           INF) + np.zeros((E, m))),
    "chain16": (50, 16, 4, lambda N, n: np.full((N, n), -INF),
                lambda N, n: np.full((N, n), INF),
                lambda E, m: np.full((E, m), -2.0),
                lambda E, m: np.full((E, m), 2.0)),
}
CASES = ("random", "scrubbed", "nan", "theta0_zero", "infeasible")


# ---------------------------------------------------------------------------
# the oracle: the block solver/fused_chain.py ran before the kernel
# ---------------------------------------------------------------------------

def block(vars, dv, zl, zu, dzl, dzu, gx, gu, cdyn, f, mu, lower, upper,
          tau_min):
    """solver/fused_chain.py's closures and line-search block, verbatim."""
    batch, dtype, device = f.shape[0], f.dtype, f.device
    has_lb = tree_map(torch.isfinite, lower)
    has_ub = tree_map(torch.isfinite, upper)

    def lanes(fill, dt=dtype):
        return torch.full((batch,), fill, dtype=dt, device=device)

    def dist_l(vars):
        return tree_map(lambda v, lb, h: torch.where(h, v - lb, 1.0), vars,
                        lower, has_lb)

    def dist_u(vars):
        return tree_map(lambda v, ub, h: torch.where(h, ub - v, 1.0), vars,
                        upper, has_ub)

    def log_barrier(vars):
        def logs(dists, has):
            return _tsum(tree_map(lambda d, h: torch.where(
                h, torch.log(torch.clamp(d, min=_EPS)), 0.0), dists, has))
        return logs(dist_l(vars), has_lb) + logs(dist_u(vars), has_ub)

    def max_step(val, dval, mask, tau):
        bad = mask & (dval < 0)
        a = torch.where(bad, -lane_view(tau, val) * val
                        / torch.where(bad, dval, -1.0), 1.0)
        return torch.clamp(_lmin(a), max=1.0)

    def min_steps(vals, dvals, msks, tau, sign=1.0):
        out = lanes(1.0)
        for v_, d_, m_ in zip(tree_leaves(vals), tree_leaves(dvals),
                              tree_leaves(msks)):
            out = torch.minimum(out, max_step(v_, sign * d_, m_, tau))
        return out

    dl, du = dist_l(vars), dist_u(vars)
    tau = torch.clamp(1.0 - mu, min=tau_min)
    alpha_p = torch.minimum(min_steps(dl, dv, has_lb, tau),
                            min_steps(du, dv, has_ub, tau, -1.0))
    alpha_d = torch.minimum(min_steps(zl, dzl, has_lb, tau),
                            min_steps(zu, dzu, has_ub, tau))
    theta0 = _lsum(cdyn.abs())
    phi_bar0 = f - mu * log_barrier(vars)
    d_phi = (_tdot(Primal(x=gx, u=gu, theta=vars.theta * 0), dv)
             - mu * _tsum(tree_map(
                 lambda dx_, d, h: torch.where(h, dx_ / d, 0.0), dv, dl,
                 has_lb))
             + mu * _tsum(tree_map(
                 lambda dx_, d, h: torch.where(h, dx_ / d, 0.0), dv, du,
                 has_ub)))
    return alpha_p, alpha_d, theta0, phi_bar0, d_phi


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _misaligned(t):
    """``t`` copied into a contiguous tensor one float past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def prologue_inputs(shape, batch, seed, case="random", device="cpu",
                    misaligned=False):
    """The prologue's arguments at ``shape`` (SHAPES) for ``batch``
    scenarios: iterates inside their bounds (steps of 0.5 N(0, 1) cross
    some), positive multipliers on the bounded entries and 0 elsewhere, as
    the solver keeps them, barrier parameters 10^U(-5, -1).  ``case``
    changes lanes 1-7: "scrubbed" zeroes lane 1's directions; "nan" puts a
    NaN into a bounded control of lane 2, a gradient of lane 3, a bounded
    control's direction of lane 6 and lane 7's mu; "theta0_zero" zeroes
    lane 4's residuals; "infeasible" moves lane 5's first control 1 past
    its upper bound."""
    T, n, m, lox, hix, lou, hiu = SHAPES[shape]
    N, E = T + 1, T
    rng = np.random.default_rng(seed)
    lower = Primal(x=lox(N, n), u=lou(E, m), theta=np.zeros(0))
    upper = Primal(x=hix(N, n), u=hiu(E, m), theta=np.zeros(0))

    def leaf(lo, hi, rows):
        size = (batch,) + rows
        fl, fu = np.isfinite(lo), np.isfinite(hi)
        lo_, hi_ = np.where(fl, lo, 0.0), np.where(fu, hi, 0.0)
        # the room to a bound, and the scale of a step: the box's width
        # where both bounds are finite
        width = np.where(fl & fu, hi_ - lo_, 2.0)
        room = np.where(fl & fu, width * rng.uniform(0.05, 0.95, size),
                        np.exp(rng.standard_normal(size)))
        v = np.where(fl, lo_ + room, np.where(
            fu, hi_ - room, 2.0 * rng.standard_normal(size)))
        z = [np.where(h, 0.1 * np.exp(rng.standard_normal(size)), 0.0)
             for h in (fl, fu)]
        dz = [np.where(h, 0.1 * rng.standard_normal(size), 0.0)
              for h in (fl, fu)]
        return (v, 0.25 * width * rng.standard_normal(size),
                rng.standard_normal(size), z, dz)

    vx, dvx, gx, zx, dzx = leaf(lower.x, upper.x, (N, n))
    vu, dvu, gu, zu_, dzu_ = leaf(lower.u, upper.u, (E, m))
    cdyn = 0.1 * rng.standard_normal((batch, N, n))
    f = 10.0 * rng.standard_normal(batch)
    mu = 10.0 ** rng.uniform(-5, -1, batch)
    if case == "scrubbed":
        for a in (dvx, dvu, *dzx, *dzu_):
            a[1] = 0.0
    elif case == "nan":
        vu[2, 1, 0] = np.nan
        gx[3, 2, 1] = np.nan
        dvu[6, 2, 0] = np.nan
        mu[7] = np.nan
    elif case == "theta0_zero":
        cdyn[4] = 0.0
    elif case == "infeasible":
        vu[5, 0, 0] = upper.u[0, 0] + 1.0
        dvu[5, 0, 0] = abs(dvu[5, 0, 0])

    def t(a):
        out = torch.as_tensor(np.asarray(a, np.float32), device=device)
        return _misaligned(out) if misaligned and out.numel() else out

    def primal(x, u):
        return Primal(x=t(x), u=t(u),
                      theta=torch.zeros(batch, 0, device=device))

    bounds = [Primal(x=t(b.x), u=t(b.u),
                     theta=torch.zeros(0, device=device))
              for b in (lower, upper)]
    return (primal(vx, vu), primal(dvx, dvu), primal(zx[0], zu_[0]),
            primal(zx[1], zu_[1]), primal(dzx[0], dzu_[0]),
            primal(dzx[1], dzu_[1]), t(gx), t(gu), t(cdyn), t(f), t(mu),
            *bounds, TAU_MIN)


def assert_bitwise(got, want):
    """Every output equal, NaN where the other's is NaN."""
    for name, a, b in zip(ls_probe.PROLOGUE_OUTPUTS, got, want):
        assert a.dtype == b.dtype == torch.float32, name
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=name)


def magnitudes(vars, dv, zl, zu, dzl, dzu, gx, gu, cdyn, f, mu, lower,
               upper, tau_min):
    """The sum of the magnitudes of each sum's float64 terms: theta0,
    phi_bar0, d_phi [B]."""
    def d64(t):
        return t.double()

    theta = d64(cdyn).abs().flatten(1).sum(-1)
    logs = torch.zeros_like(theta)
    dot = (d64(gx) * d64(dv.x)).abs().flatten(1).sum(-1) \
        + (d64(gu) * d64(dv.u)).abs().flatten(1).sum(-1)
    inv = torch.zeros_like(theta)
    for v, d_, lo, hi in ((vars.x, dv.x, lower.x, upper.x),
                          (vars.u, dv.u, lower.u, upper.u)):
        for dist, h in ((d64(v) - d64(lo), torch.isfinite(lo)),
                        (d64(hi) - d64(v), torch.isfinite(hi))):
            dist = torch.where(h, dist, 1.0)
            logs = logs + torch.where(h, dist.clamp(min=0).log().abs(),
                                      0.0).flatten(1).sum(-1)
            inv = inv + torch.where(h, (d64(d_) / dist).abs(),
                                    0.0).flatten(1).sum(-1)
    mu = d64(mu).abs()
    return theta, d64(f).abs() + mu * logs, dot + mu * inv


def assert_kernel_match(got, want, args):
    """The kernel's outputs against the twin's: the step limits bit-equal;
    NaN and infinities where the twin's are; the finite sums within SUM_TOL
    of the sum of their terms' magnitudes."""
    assert all(tuple(g.shape) == tuple(w.shape) for g, w in zip(got, want))
    assert_bitwise(got[:2], want[:2])
    for name, a, b, mag in zip(ls_probe.PROLOGUE_OUTPUTS[2:], got[2:],
                               want[2:], magnitudes(*args)):
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        inf = torch.isinf(b)
        assert torch.equal(a[inf], b[inf]), name
        fin = torch.isfinite(b)
        assert bool(torch.isfinite(a[fin]).all()), name
        err = (a.double() - b.double()).abs()[fin]
        bar = SUM_TOL * mag.to(err.device)[fin]
        assert bool((err <= bar).all()), (name, float((err / bar).max()))


def assert_edge_lanes(out, case):
    """What each case makes of its lanes."""
    alpha_p, alpha_d, theta0, phi_bar0, d_phi = out
    if case == "scrubbed":
        assert float(alpha_p[1]) == float(alpha_d[1]) == 1.0
        assert float(d_phi[1]) == 0.0
    elif case == "nan":
        assert math.isnan(float(phi_bar0[2])) and math.isnan(float(d_phi[3]))
        assert math.isnan(float(d_phi[6])) and math.isnan(float(phi_bar0[7]))
        assert not math.isnan(float(alpha_p[6]))   # a NaN step is no limit
        assert math.isnan(float(alpha_p[7]))       # tau is NaN
    elif case == "theta0_zero":
        assert float(theta0[4]) == 0.0
    elif case == "infeasible":
        assert float(phi_bar0[5]) == INF and float(alpha_p[5]) < 0.0
    finite = torch.ones(out[0].shape[0], dtype=torch.bool,
                        device=out[0].device)
    finite[1:8] = False
    for t in out:
        assert bool(torch.isfinite(t[finite]).all())
    assert bool((alpha_p[finite] < 1.0).any())   # some steps cross a bound


# ---------------------------------------------------------------------------
# the twin against the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_twin_matches_block_bit_for_bit(shape, case):
    args = prologue_inputs(shape, B, seed=len(shape) + 7 * len(case),
                           case=case)
    want = block(*args)
    assert_edge_lanes(want, case)
    assert_bitwise(ls_probe.ls_prologue_reference(*args), want)
    assert_bitwise(ls_probe.ls_prologue(*args), want)


def test_ls_prologue_routes_by_device():
    """CPU tensors take the twin (no launch); the kernel's wrapper refuses
    CPU tensors, float64, a theta, non-contiguous operands and mismatched
    shapes before any build."""
    args = prologue_inputs("state_bounds", 9, seed=3)
    ls_probe.reset_launch_counts()
    ls_probe.ls_prologue(*args)
    assert ls_probe.launch_counts["ls_prologue"] == 0
    with pytest.raises(ValueError, match="unsupported device"):
        ls_probe.prologue_kernel(*args)
    f64 = tree_map(lambda t: t.double(), args[:-1])
    with pytest.raises(TypeError, match="float32"):
        ls_probe.prologue_kernel(*f64, TAU_MIN)
    vars = args[0]._replace(theta=torch.zeros(9, 1))
    with pytest.raises(ValueError, match="theta"):
        ls_probe.prologue_kernel(vars, *args[1:])
    gx = args[6].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ls_probe.prologue_kernel(*args[:6], gx, *args[7:])
    with pytest.raises(ValueError, match="shape"):
        ls_probe.prologue_kernel(*args[:8], args[8][:, 1:], *args[9:])
    assert ls_probe.launch_counts["ls_prologue"] == 0


# ---------------------------------------------------------------------------
# the kernel's source on the host
# ---------------------------------------------------------------------------

def _host_source() -> str:
    """csrc/ls_prologue.cu with its launch as an emu_launch call."""
    with open(os.path.join(cuda_build.CSRC, "ls_prologue.cu")) as fh:
        text = fh.read()
    out, n = re.subn(r"([\w:]+)<<<([\s\S]*?)>>>\(",
                     r"emu_launch(\1, EmuCfg(\2), ", text)
    assert n == 1
    return out


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    root = tmp_path_factory.mktemp("ls_prologue_host")
    src = root / "ls_prologue.cpp"
    src.write_text(_host_source())
    lib = root / "libls_prologue.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
         "-I", STUB, "-o", str(lib), str(src)], capture_output=True,
        text=True)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("the host compiler lacks C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr[-4000:]
    return str(lib)


@pytest.fixture
def host_kernel(host_library, monkeypatch):
    """The wrapper ``prologue_kernel`` on the host library (CPU pointers,
    no stream; the device check skipped), counting its launches."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    monkeypatch.setattr(ls_probe, "_check_prologue", lambda *args: None)
    monkeypatch.setattr(ls_probe, "_prologue_entry",
                        lambda: ls_probe._load_prologue(host_library))
    ls_probe.reset_launch_counts()
    yield ls_probe.prologue_kernel
    ls_probe.reset_launch_counts()


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernel_matches_twin_on_host(host_kernel, shape, case, misaligned):
    args = prologue_inputs(shape, B, seed=100 + len(shape) + len(case),
                           case=case, misaligned=misaligned)
    want = ls_probe.ls_prologue_reference(*args)
    got = host_kernel(*args)
    assert ls_probe.launch_counts["ls_prologue"] == 1
    assert_kernel_match(got, want, args)
    assert_edge_lanes(got, case)


def test_fused_solve_through_kernel_on_host(host_kernel, monkeypatch):
    """One fused cartpole solve (5 fixed trips, 16 scenarios) with the
    prologue on the host kernel against one with the twin: one launch a
    trip, statuses and iterations identical, the rest within 1e-5 (the
    sums' roundoff through the line search's decisions)."""
    spec, dims, topo, lo, up, x0 = pm.cartpole_swingup(
        10, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    x0s = torch.as_tensor((x0.numpy() + 0.1 * rng.standard_normal(
        (16, 4))).astype(np.float32))
    settings = P.Settings(
        max_iterations=5, fixed_iterations=True, mu_init=3e-3, tol=1e-3,
        mu_min=1e-5, reg_floor=1e-5, prox_reg=1e-5, max_factor_retries=0,
        fused_iteration=True,
        line_search=PLS(max_steps=6, chunk=6, use_filter_line_search=True,
                        fused_probe=True))
    problem = P.build_problem(spec, dims, topo, x0s, lo, up,
                              hessian_mode="gauss_newton")
    assert fused_chain._eligible(problem, settings)
    twin = P.solve(problem, settings)
    monkeypatch.setattr(fused_chain, "ls_prologue", host_kernel)
    kernel = P.solve(problem, settings)
    assert ls_probe.launch_counts["ls_prologue"] == 5
    assert torch.equal(kernel.status, twin.status)
    assert torch.equal(kernel.iterations, twin.iterations)
    for a, b in zip(tree_leaves((kernel.vars, kernel.y.dyn, kernel.zl,
                                 kernel.zu, kernel.kkt_error)),
                    tree_leaves((twin.vars, twin.y.dyn, twin.zl, twin.zu,
                                 twin.kkt_error))):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
