"""The chain-Riccati kernels' CUDA source, run on the CPU.

csrc/riccati.cu is compiled by the host C++ compiler against
tests/host_cuda/cuda_runtime.h, which runs every GPU thread as an OS thread,
blocks in turn (barriers for ``__syncthreads`` / ``__syncwarp``, an exchange
array for the shuffles; ``cp.async`` is a plain copy on the host), with the
kernels' ``<<<...>>>`` launches rewritten into the stand-in's
``emu_launch``.  The wrappers of ops/riccati_cuda.py then run on that
library with CPU tensors (``host_kernels`` routes them there), so their
layouts are checked too.  That holds, without a GPU, all four kernels
(explicit-W factor, Gram factor, backward pass, forward rollout) at every
instantiated (n, m) against their plain twins at T = 50 on a ragged batch
(B = 37: a partial block, teams past the batch), statuses identical; a
failed G Cholesky and a NaN confined to their scenario (a NaN in q for the
backward pass, in F_chol for the forward rollout, in Q for the factor of
each form); and every kernel's launch configuration at the main path's
batch.  Host float
arithmetic contracts no multiply-adds, the card's does: the bars are
chip_smoke.py's (factor products 2e-4, solutions 2e-3).  Skips without a
C++20 compiler.
"""

import dataclasses
import math
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sip_optimal_control_tpu_torch import LQRData
from sip_optimal_control_tpu_torch.ops import cuda_build
from sip_optimal_control_tpu_torch.ops import riccati_cuda as rc

STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "host_cuda")
T, B = 50, 37
FACTOR_TOL, SOLVE_TOL = 2e-4, 2e-3
SHAPES = sorted(rc.SUPPORTED_SHAPES)
# one shape of each design: one lane per scenario, a team of 16 lanes
DESIGNS = [(4, 1), (16, 4)]


def _compiler():
    return shutil.which("g++") or shutil.which("c++")


def _host_source() -> str:
    """csrc/riccati.cu with its launches as emu_launch calls, and the
    kernels' dynamic shared memory."""
    with open(os.path.join(cuda_build.CSRC, "riccati.cu")) as fh:
        text = fh.read()
    out, n = re.subn(r"([\w:]+(?:<[^<>]*>)?)<<<([\s\S]*?)>>>\(",
                     r"emu_launch(\1, EmuCfg(\2), ", text)
    assert n == 1  # every kernel launches through launch_team
    return out + ("\nnamespace riccati {\nalignas(16) float4 smem4[1 << 15];"
                  "\n}\n")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/riccati.cu built for the host once; the path of the library."""
    cxx = _compiler()
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    root = tmp_path_factory.mktemp("riccati_host")
    probe = root / "probe.cpp"
    probe.write_text("#include <barrier>\nint main() { std::barrier<> b(1);"
                     " b.arrive_and_wait(); }\n")
    if subprocess.run([cxx, "-std=c++20", "-pthread", "-o",
                       str(root / "probe"), str(probe)],
                      capture_output=True).returncode != 0:
        pytest.skip("the host compiler lacks C++20 <barrier>")
    for header in ("riccati_tiny.cuh", "team.cuh"):
        shutil.copy(os.path.join(cuda_build.CSRC, header), root)
    (root / "riccati.cpp").write_text(_host_source())
    lib = root / "libriccati.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
         "-I", STUB, "-I", str(root), "-o", str(lib),
         str(root / "riccati.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return str(lib)


@pytest.fixture
def host_kernels(host_lib, monkeypatch):
    """The wrappers of ops/riccati_cuda.py on the host library: CPU tensors
    launch the kernels (no stream) instead of taking the twins."""
    monkeypatch.setattr(rc, "build_library", lambda: (host_lib, 0.0))
    monkeypatch.setattr(rc, "_lib", None)

    def route(device, n, m):
        assert (n, m) in rc.SUPPORTED_SHAPES
        return True

    def launch(name, fn, n, m, T_h, Bsz, args, device):
        assert fn(n, m, T_h, Bsz, *[a.data_ptr() for a in args], None) == 0
        rc.launch_counts[name] += 1

    monkeypatch.setattr(rc, "_route", route)
    monkeypatch.setattr(rc, "_launch", launch)
    rc.reset_launch_counts()
    yield rc._library()
    rc.reset_launch_counts()


def _chain(n, m, seed, batch=B):
    """Random chain data as chip_smoke.py::random_chain makes it."""
    rng = np.random.default_rng(seed)

    def spd(count, d):
        s = 0.3 * rng.standard_normal((batch, count, d, d))
        return s @ np.swapaxes(s, -1, -2) + 2.0 * np.eye(d)

    arrays = dict(
        Q=spd(T + 1, n), q=rng.standard_normal((batch, T + 1, n)),
        c=rng.standard_normal((batch, T + 1, n)),
        delta=0.5 + rng.random((batch, T + 1, n)),
        A=0.8 / math.sqrt(n) * rng.standard_normal((batch, T, n, n)),
        B=0.5 * rng.standard_normal((batch, T, n, m)),
        M=0.1 * rng.standard_normal((batch, T, n, m)), R=spd(T, m),
        r=rng.standard_normal((batch, T, m)))
    return LQRData(**{k: torch.as_tensor(v, dtype=torch.float32)
                      for k, v in arrays.items()})


def _close(got, want, tol, what, keep=slice(None)):
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g[keep], w[keep], rtol=tol, atol=tol,
                                   msg=f"{what}[{i}]")


def _bwd_args(data, fact):
    return (data.q, data.r, data.c, data.delta, fact.F_chol, fact.G_chol,
            fact.K, data.A, data.B)


@pytest.mark.parametrize("n,m", SHAPES)
def test_kernels_match_twins(host_kernels, n, m):
    """Every kernel of the shape through its wrapper against its twin: the
    factor of the shape's form, both solve passes on the twin's factor, and
    the chain factor and solve with statuses identical."""
    data = _chain(n, m, seed=n * 10 + m)
    gram = n >= rc.GRAM_N
    factor = "riccati_factor_gram" if gram else "riccati_factor"
    wrapper, twin = rc.KERNELS[factor][:2]
    args = (data.Q, data.delta, data.A, data.B, data.M, data.R)
    _close(wrapper(*args), twin(*args), FACTOR_TOL, factor)
    fact_t = rc.factor_chain_reference(data)
    bwd_in = _bwd_args(data, fact_t)
    k_t, v_t = rc.solve_bwd_kernel_reference(*bwd_in)
    _close(rc.solve_bwd_kernel(*bwd_in), (k_t, v_t), SOLVE_TOL, "solve_bwd")
    v_full = torch.cat([v_t, data.q[:, -1:]], dim=1)
    x_root = torch.as_tensor(
        np.random.default_rng(0).standard_normal((B, n)), dtype=torch.float32)
    fwd_in = (x_root, k_t, fact_t.K, data.A, data.B, data.c, data.delta,
              v_full, fact_t.V, fact_t.F_chol)
    _close(rc.solve_fwd_kernel(*fwd_in),
           rc.solve_fwd_kernel_reference(*fwd_in), SOLVE_TOL, "solve_fwd")
    assert rc.launch_counts == {"riccati_factor": int(not gram),
                                "riccati_factor_gram": int(gram),
                                "riccati_solve_bwd": 1,
                                "riccati_solve_fwd": 1}

    fact = rc.factor_chain_cuda(data)
    assert torch.equal(fact.status, fact_t.status)
    assert bool((fact.status == 0).all())
    for name in ("V", "W", "K", "G_chol", "F_chol"):
        torch.testing.assert_close(getattr(fact, name), getattr(fact_t, name),
                                   rtol=FACTOR_TOL, atol=FACTOR_TOL, msg=name)
    sol = rc.solve_chain_cuda(data, fact)
    sol_t = rc.solve_chain_reference(data, fact_t)
    for name in ("x", "u", "y"):
        torch.testing.assert_close(getattr(sol, name), getattr(sol_t, name),
                                   rtol=SOLVE_TOL, atol=SOLVE_TOL, msg=name)


@pytest.mark.parametrize("n,m", SHAPES)
def test_g_failure_stays_in_its_scenario(host_kernels, n, m):
    """A non-PD R at (scenario 5, edge 20) fails G's Cholesky there: the
    twin's status (and only there), NaN in that scenario's products from
    edge 20 down, the twin's products in every other scenario."""
    data = _chain(n, m, seed=100 + n * 10 + m)
    R = data.R.clone()
    R[5, 20] = -100.0 * torch.eye(m)
    data = dataclasses.replace(data, R=R)
    fact = rc.factor_chain_cuda(data)
    fact_t = rc.factor_chain_reference(data)
    assert torch.equal(fact.status, fact_t.status)
    assert int(fact.status[5]) != 0 and int((fact.status != 0).sum()) == 1
    assert bool(torch.isnan(fact.G_chol[5, 20]).any())
    assert bool(torch.isnan(fact.V[5, :21]).all())
    assert bool(torch.isfinite(fact.V[5, 21:]).all())
    keep = torch.arange(B) != 5
    for name in ("V", "K", "G_chol", "F_chol"):
        torch.testing.assert_close(getattr(fact, name)[keep],
                                   getattr(fact_t, name)[keep],
                                   rtol=FACTOR_TOL, atol=FACTOR_TOL, msg=name)


@pytest.mark.parametrize("n,m", DESIGNS)
def test_nan_stays_in_its_scenario(host_kernels, n, m):
    """A NaN in one scenario's q at edge 30 reaches that scenario's k and v
    from edge 30 down and no other scenario's."""
    data = _chain(n, m, seed=200 + n)
    q = data.q.clone()
    q[7, 30, 0] = float("nan")
    data = dataclasses.replace(data, q=q)
    bwd_in = _bwd_args(data, rc.factor_chain_reference(data))
    k, v = rc.solve_bwd_kernel(*bwd_in)
    want = rc.solve_bwd_kernel_reference(*bwd_in)
    assert bool(torch.isnan(v[7, :31]).any(dim=-1).all())
    assert bool(torch.isfinite(v[7, 31:]).all())
    assert bool(torch.isnan(k[7, :30]).any(dim=-1).all())
    keep = torch.arange(B) != 7
    assert bool(torch.isfinite(k[keep]).all() and torch.isfinite(v[keep])
                .all())
    _close((k, v), want, SOLVE_TOL, "solve_bwd", keep)


@pytest.mark.parametrize("n,m", DESIGNS)
def test_rollout_nan_stays_in_its_scenario(host_kernels, n, m):
    """A NaN in one scenario's F_chol at node 21 reaches that scenario's x
    and y from edge 20 on, and its u from edge 21 on, and no other
    scenario's; the other scenarios match the twin."""
    data = _chain(n, m, seed=300 + n)
    fact = rc.factor_chain_reference(data)
    k, v_par = rc.solve_bwd_kernel_reference(*_bwd_args(data, fact))
    F_chol = fact.F_chol.clone()
    F_chol[9, 21, n - 1, 0] = float("nan")
    x_root = torch.as_tensor(
        np.random.default_rng(1).standard_normal((B, n)), dtype=torch.float32)
    fwd_in = (x_root, k, fact.K, data.A, data.B, data.c, data.delta,
              torch.cat([v_par, data.q[:, -1:]], dim=1), fact.V, F_chol)
    u, x, y = rc.solve_fwd_kernel(*fwd_in)
    want = rc.solve_fwd_kernel_reference(*fwd_in)
    for a in (x, y):
        assert bool(torch.isfinite(a[9, :20]).all())
        assert bool(torch.isnan(a[9, 20:]).any(dim=-1).all())
    assert bool(torch.isfinite(u[9, :21]).all())
    assert bool(torch.isnan(u[9, 21:]).any(dim=-1).all())
    keep = torch.arange(B) != 9
    assert all(bool(torch.isfinite(a[keep]).all()) for a in (u, x, y))
    _close((u, x, y), want, SOLVE_TOL, "solve_fwd", keep)
    _close((u[9, :20], x[9, :20], y[9, :20]),
           (want[0][9, :20], want[1][9, :20], want[2][9, :20]), SOLVE_TOL,
           "solve_fwd before the NaN")


@pytest.mark.parametrize("n,m", DESIGNS)
def test_factor_nan_stays_in_its_scenario(host_kernels, n, m):
    """A NaN in one scenario's Q at node 30 reaches, through the factor of
    the shape's form (explicit W at n < 8, Gram form at n >= 8), that
    scenario's products from edge 30 down and no other scenario's; edges
    past it and every other scenario match the twin."""
    data = _chain(n, m, seed=400 + n)
    Q = data.Q.clone()
    Q[11, 30, 0, 0] = float("nan")
    args = (Q, data.delta, data.A, data.B, data.M, data.R)
    name = "riccati_factor_gram" if n >= rc.GRAM_N else "riccati_factor"
    wrapper, twin = rc.KERNELS[name][:2]
    got, want = wrapper(*args), twin(*args)
    v_par = got[0]
    assert bool(torch.isnan(v_par[11, :31]).any(dim=(-2, -1)).all())
    assert bool(torch.isnan(got[-1][11, :30]).any(dim=(-2, -1)).all())
    keep = torch.arange(B) != 11
    for a in got:
        assert bool(torch.isfinite(a[keep]).all())
        assert bool(torch.isfinite(a[11, 31:]).all())
    _close(got, want, FACTOR_TOL, name, keep)
    _close([a[11, 31:] for a in got], [a[11, 31:] for a in want],
           FACTOR_TOL, f"{name} past the NaN")


@pytest.mark.parametrize("n,m", SHAPES)
def test_launch_config_fills_the_card(host_kernels, n, m):
    """At the main path's batch of 4096 each kernel of the shape (the
    factor of its form, both solves) launches 16 scenarios per block, 256
    blocks, at least one per SM of an H100 (132), within a block's 227 KB
    of shared memory; at cartpole and chain16 two blocks share an SM (one
    wave), as the block's share of the SM allows.  The factor of the other
    form reports zeros."""
    gram = n >= rc.GRAM_N
    other = "riccati_factor" if gram else "riccati_factor_gram"
    for name in rc.TEAM_KERNELS:
        cfg = rc.launch_config(host_kernels, name, n, m, 4096)
        if name == other:
            assert cfg == dict(grid=0, block=0, smem=0)
            continue
        assert cfg["grid"] == 4096 // 16 and cfg["grid"] >= 132
        assert cfg["block"] == 16 * (4 if n < rc.GRAM_N else 16 if n > 8
                                     else 8)
        assert cfg["smem"] <= 232448
        if (n, m) in ((16, 4), (4, 1)):
            assert 2 * (cfg["smem"] + 1024) <= 233472
        assert rc.launch_config(host_kernels, name, n, m, 1)["grid"] == 1
