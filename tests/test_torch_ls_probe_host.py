"""The chain line-search probe kernel's CUDA source, run on the CPU.

A model's generated source (``ops/ls_probe.py::cuda_source``) over
csrc/ls_probe.cuh is compiled by the host C++ compiler against
tests/host_cuda/cuda_runtime.h, which runs every GPU thread as an OS thread,
blocks in turn, the shuffles through an exchange array; the kernel's
``<<<...>>>`` launch is rewritten into the stand-in's ``emu_launch``.  The
real wrapper (``probe_kernel`` and its ``_launch``, which hands the kernel
the strides of ``alphas``) then runs on that library with CPU tensors.  That
holds, without a GPU, the kernel against its plain twin under chip_smoke.py's
``probe_match`` rules (-inf patterns identical, finite entries within 2e-5
relative): cartpole, the quadrotor, chain16 and the chains (8, 3), (16, 5)
and (6, 4) at T = 50, cartpole and chain16 also at T = 4 (teams of 8 lanes,
four scenarios to a warp) and T = 70 (three stages on some lanes), on a
ragged batch (B = 37), with 1 and 6 candidates (and 7 and 13, whose last
pass holds one), the candidates contiguous
and as the solver's transposed view; the sums within (T + 1) float32
epsilons times the sum of their terms' magnitudes of a float64 sequential
sum of the same terms (the kernel adds them over a lane tree); a NaN
confined to its scenario and a -inf to its candidate; the launch
configuration.  Skips without a C++20 compiler.
"""

import concurrent.futures
import contextlib
import functools
import os
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from sip_optimal_control_tpu_torch import models
from sip_optimal_control_tpu_torch.model import fused_probe_model
from sip_optimal_control_tpu_torch.ops import cuda_build, ls_probe
from sip_optimal_control_tpu_torch.ops.stage_codegen import evaluate

STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "host_cuda")
B, PROBE_TOL = 37, 2e-5                 # chip_smoke.py: PROBE_TOL
F32_EPS = float(np.finfo(np.float32).eps)
MODELS = {"cartpole": models.cartpole_swingup,
          "quadrotor": models.planar_quadrotor,
          "chain16": models.synthetic_chain,
          "chain8x3": functools.partial(models.synthetic_chain, state_dim=8,
                                        control_dim=3),
          "chain16x5": functools.partial(models.synthetic_chain,
                                         state_dim=16, control_dim=5),
          # rows of x read as scalars, of u as float4
          "chain6x4": functools.partial(models.synthetic_chain, state_dim=6,
                                        control_dim=4)}
# (model, horizon) of each host library
LIBS = ([(name, 50) for name in MODELS]
        + [(name, T) for name in ("cartpole", "chain16") for T in (4, 70)])


def _compiler():
    return shutil.which("g++") or shutil.which("c++")


@functools.lru_cache(maxsize=None)
def problem(name, T, device="cpu"):
    """(spec, bounds) of the model's fused probe at horizon T."""
    spec, dims, topo, lo, up, _ = MODELS[name](horizon=T,
                                               dtype=torch.float32,
                                               device=device)
    fused = fused_probe_model(spec, dims, topo, lo, up, torch.float32,
                              device, iteration=False)
    assert fused is not None
    return fused[:2]


def probe_inputs(spec, batch, chunk, seed, device="cpu"):
    """chip_smoke.py::probe_inputs at any horizon: iterate, direction, root
    state, candidates [B, chunk]; the first eighth of the scenarios'
    controls scaled by 20, so some of their candidates violate the control
    bounds, and scenario 0's at 100, past every model's bounds."""
    rng = np.random.default_rng(seed)
    T, n, m = spec.horizon, spec.n, spec.m

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    u = 0.3 * rng.standard_normal((batch, T, m))
    u[:batch // 8] *= 20.0
    u[0] = 100.0
    return (t(rng.standard_normal((batch, T + 1, n))),
            t(0.1 * rng.standard_normal((batch, T + 1, n))), t(u),
            t(0.1 * rng.standard_normal((batch, T, m))),
            t(rng.standard_normal((batch, n))),
            t(0.3 * rng.random((batch, chunk))))


def transposed(alphas):
    """The candidates as the solver hands them over: a [B, chunk] view of a
    [chunk, B] tensor (solver/sip.py, solver/fused_chain.py)."""
    return alphas.t().contiguous().t()


def probe_match(got, want):
    """chip_smoke.py's probe_match: -inf patterns identical, finite entries
    within PROBE_TOL relative, some entries finite."""
    for what, a, b in zip(("f", "theta", "logb"), got, want):
        assert torch.equal(torch.isneginf(a), torch.isneginf(b)), what
        fin = torch.isfinite(b)
        assert bool(fin.any()) and bool(torch.isfinite(a[fin]).all()), what
        rel = float(((a - b).abs() / (1 + b.abs()))[fin].max())
        assert rel <= PROBE_TOL, (what, rel)


def stage_terms(spec, bounds, x, dx, u, du, x0, alphas):
    """The float32 terms the kernel adds, through the generated programs:
    f, theta and logb [B, chunk, terms] (stage t's terms at t, the terminal
    node's at T; theta's root row last)."""
    lb_u, ub_u, lb_x, ub_x = bounds
    T = spec.horizon
    a = alphas[..., None]
    th0 = x.new_zeros(alphas.shape + (0,))

    def node(t):
        return x[:, None, t] + a * dx[:, None, t]

    def index(t):
        return torch.tensor(t, dtype=torch.int32, device=x.device)

    def total(terms, like):
        return (functools.reduce(torch.add, terms) if terms
                else torch.zeros_like(like))

    f, th, lb = [], [], []
    for t in range(T):
        xp, xc = node(t), node(t + 1)
        ue = u[:, None, t] + a * du[:, None, t]
        pred = evaluate(spec.dyn_prog, xp, ue, th0, index(t))
        f_t = (evaluate(spec.ncost_prog, xp, th0, index(t))
               + evaluate(spec.ecost_prog, xp, ue, th0, index(t)))
        f.append(f_t)
        th.append(total((pred - xc).abs().unbind(-1), f_t))
        lb.append(total(ls_probe._bound_terms(ue, lb_u, ub_u)
                        + ls_probe._bound_terms(xp, lb_x, ub_x), f_t))
    f.append(evaluate(spec.ncost_prog, node(T), th0, index(T)))
    lb.append(total(ls_probe._bound_terms(node(T), lb_x, ub_x), f[-1]))
    th.append(total((x0[:, None] - node(0)).abs().unbind(-1), f[-1]))
    return [torch.stack(v, -1) for v in (f, th, lb)]


def assert_order_bound(got, terms, T):
    """Each sum within (T + 1) float32 epsilons times the sum of its terms'
    magnitudes of a float64 sequential sum of the same terms; -inf where
    that sum is -inf."""
    for what, a, t in zip(("f", "theta", "logb"), got, terms):
        t64 = t.double()
        seq = functools.reduce(torch.add, t64.unbind(-1))
        fin = torch.isfinite(seq)
        assert torch.equal(torch.isneginf(a), torch.isneginf(seq)), what
        assert bool(fin.any()), what
        err = (a.double() - seq).abs()[fin]
        bar = (T + 1) * F32_EPS * t64.abs().sum(-1)[fin]
        assert bool((err <= bar).all()), (what, float((err / bar).max()))


# ---------------------------------------------------------------------------
# the host build
# ---------------------------------------------------------------------------

def _host_header() -> str:
    """csrc/ls_probe.cuh with its launch as an emu_launch call."""
    with open(os.path.join(cuda_build.CSRC, "ls_probe.cuh")) as fh:
        text = fh.read()
    out, n = re.subn(r"([\w:]+(?:<[^<>]*>)?)<<<([\s\S]*?)>>>\(",
                     r"emu_launch(\1, EmuCfg(\2), ", text)
    assert n == 1
    return out + ("\nnamespace ls_probe {\nalignas(16) float4 smem4[1 << 15];"
                  "\n}\n")


class HostLibraries:
    """Each (model, horizon)'s library of LIBS, built for the host, all at
    once (one compiler each) from the first request on."""

    def __init__(self, root, cxx):
        self.root, self.cxx, self.libs = root, cxx, None
        (root / "ls_probe.cuh").write_text(_host_header())
        for header in ("riccati_tiny.cuh", "team.cuh"):
            shutil.copy(os.path.join(cuda_build.CSRC, header), root)

    def _build(self, name, T):
        spec, bounds = problem(name, T)
        src = self.root / f"{name}_{T}.cpp"
        src.write_text(ls_probe.cuda_source(spec, ls_probe.bounds_key(bounds)))
        lib = self.root / f"lib{name}_{T}.so"
        proc = subprocess.run(
            [self.cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-w", "-I", STUB, "-I", str(self.root), "-o", str(lib),
             str(src)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return str(lib)

    def get(self, name, T):
        if self.libs is None:
            for key in LIBS:             # traced here: make_fx is not
                problem(*key)            # safe across threads
            pool = concurrent.futures.ThreadPoolExecutor(len(LIBS))
            self.libs = {key: pool.submit(self._build, *key) for key in LIBS}
            pool.shutdown(wait=False)
        return self.libs[name, T].result()


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    cxx = _compiler()
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    root = tmp_path_factory.mktemp("ls_probe_host")
    probe = root / "probe.cpp"
    probe.write_text("#include <barrier>\nint main() { std::barrier<> b(1);"
                     " b.arrive_and_wait(); }\n")
    if subprocess.run([cxx, "-std=c++20", "-pthread", "-o",
                       str(root / "probe"), str(probe)],
                      capture_output=True).returncode != 0:
        pytest.skip("the host compiler lacks C++20 <barrier>")
    return HostLibraries(root, cxx)


@pytest.fixture
def host_probe(host_libs, monkeypatch):
    """probe(name, T, *args) -> the kernel's (f, theta, logb) through the
    wrapper ``probe_kernel`` on the host library (CPU pointers, no
    stream), counting its launches."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    monkeypatch.setattr(ls_probe, "_check", lambda *args: None)
    ls_probe.reset_launch_counts()

    def probe(name, T, *args):
        spec, bounds = problem(name, T)
        entry = ls_probe._load(host_libs.get(name, T), "ls_probe_f32")
        return ls_probe.probe_kernel(spec, bounds, *args, entry=entry)
    yield probe
    ls_probe.reset_launch_counts()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

# 1 and 6 candidates (one pass) everywhere; 7 and 13 (a last pass of one)
CASES = ([(name, T, chunk) for name, T in LIBS for chunk in (1, 6)]
         + [("cartpole", 4, 7), ("chain16", 70, 13)])


@pytest.mark.parametrize("name,T,chunk", CASES)
def test_kernel_matches_twin(host_probe, name, T, chunk):
    """The kernel against probe_reference, the candidates contiguous and
    as the solver's transposed view (the same outputs, bit for bit); one
    launch counted per call."""
    spec, bounds = problem(name, T)
    args = probe_inputs(spec, B, chunk, seed=T + chunk)
    want = ls_probe.probe_reference(spec, bounds, *args)
    assert bool(torch.isneginf(want[2]).any())   # some infeasible candidates
    got = host_probe(name, T, *args)
    assert all(tuple(g.shape) == (B, chunk) for g in got)
    probe_match(got, want)
    got_t = host_probe(name, T, *args[:5], transposed(args[5]))
    assert all(torch.equal(a, b) for a, b in zip(got, got_t))
    assert ls_probe.launch_counts == {"ls_probe": 2, "ls_probe_tree": 0,
                                      "ls_prologue": 0}


@pytest.mark.parametrize("name,T", LIBS)
def test_summation_order_bound(host_probe, name, T):
    """The kernel's sums (a lane tree, not the twin's order) within (T + 1)
    float32 epsilons times the sum of the terms' magnitudes of a float64
    sequential sum of the same float32 terms."""
    spec, bounds = problem(name, T)
    args = probe_inputs(spec, B, 6, seed=100 + T)
    got = host_probe(name, T, *args[:5], transposed(args[5]))
    assert_order_bound(got, stage_terms(spec, bounds, *args), T)


@pytest.mark.parametrize("name", ["cartpole", "chain16"])
def test_nan_stays_in_its_scenario(host_probe, name):
    """A NaN in scenario 5's iterate makes its f and theta NaN for every
    candidate and changes no other scenario's outputs."""
    spec, _ = problem(name, 50)
    args = probe_inputs(spec, B, 6, seed=7)
    clean = host_probe(name, 50, *args)
    x = args[0].clone()
    x[5, 20, 1] = float("nan")
    got = host_probe(name, 50, x, *args[1:])
    assert bool(torch.isnan(got[0][5]).all() and torch.isnan(got[1][5]).all())
    keep = torch.arange(B) != 5
    for a, b in zip(got, clean):
        assert torch.equal(a[keep], b[keep])


@pytest.mark.parametrize("name", ["cartpole", "chain16"])
def test_neg_inf_stays_in_its_candidate(host_probe, name):
    """A step far past the control bounds for one candidate (scenario 30,
    candidate 2) makes that candidate's logb -inf and changes no other
    entry of any output."""
    spec, _ = problem(name, 50)
    args = probe_inputs(spec, B, 6, seed=8)
    clean = host_probe(name, 50, *args)
    assert bool(torch.isfinite(clean[2][30]).all())
    alphas = args[5].clone()
    alphas[30, 2] = 1e3
    got = host_probe(name, 50, *args[:5], alphas)
    assert float(got[2][30, 2]) == -np.inf
    keep = torch.ones(B, 6, dtype=torch.bool)
    keep[30, 2] = False
    for a, b in zip(got, clean):
        assert torch.equal(a[keep], b[keep])


def test_launch_config(host_libs):
    """A team of 32 lanes per scenario from T = 31 on (4096 warps at the
    main path's batch, four to a block, in 25,216 B of shared memory at
    chain16: two windows of 33 x 20 and 32 x 4 floats each); 8 lanes at
    T = 4."""
    cfg = ls_probe.launch_config
    assert cfg(host_libs.get("chain16", 50), 4096) == dict(
        grid=1024, block=128, smem=4 * (2 * 33 * 20 + 2 * 32 * 4) * 4,
        lanes=32)
    assert cfg(host_libs.get("cartpole", 50), 1000)["grid"] == 250
    assert cfg(host_libs.get("cartpole", 4), 37) == dict(
        grid=3, block=128, smem=16 * (2 * 9 * 4 + 2 * 8 * 1) * 4, lanes=8)
