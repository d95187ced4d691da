"""The fused factor and eval kernels' CUDA source, run on the CPU.

csrc/fused_iter.cuh and a model's generated entry points
(``ops/fused_iter.py::cuda_source``) are compiled by the host C++ compiler
against tests/host_cuda/cuda_runtime.h, which runs every GPU thread as an OS
thread, blocks in turn (barriers for ``__syncthreads`` / ``__syncwarp``, an
exchange array for the shuffles; ``cp.async`` is a plain copy on the host).
The kernels' ``<<<...>>>`` launches are rewritten into the stand-in's
``emu_launch``.  That checks, without a GPU, the kernels' arithmetic, their
indexing, the shared-memory map, the team synchronization and the block's
staged writes: the factor (one thread per scenario at n < 8, a team of
lanes above, for any m: chain models at (n, m) = (8, 3), (16, 4) and, in
the exact Hessian mode, (16, 5)) and eval kernels against the plain twins
at T = 50 on a ragged batch (B = 37), a failed Cholesky and a NaN confined
to their scenario, and the launch configuration at the main path's batch.  Host float arithmetic contracts no multiply-adds, the card's
does: the bars are the GPU tests' (factor 2e-4, eval 2e-3, the objective
4 (T + 1) float32 epsilons relative).  Skips without a C++20 compiler.
"""

import functools
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sip_optimal_control_tpu_torch import models
from sip_optimal_control_tpu_torch.ops import cuda_build
from sip_optimal_control_tpu_torch.ops import fused_iter as fi
from sip_optimal_control_tpu_torch.ops.ls_probe import bounds_key

STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "host_cuda")
T, B = 50, 37
FACTOR_TOL, SOLVE_TOL = 2e-4, 2e-3
F32_EPS = float(np.finfo(np.float32).eps)
CASES = {"cartpole": (models.cartpole_swingup, "gauss_newton"),
         "quadrotor": (models.planar_quadrotor, "exact"),
         "chain16": (models.synthetic_chain, "gauss_newton"),
         # m * m above the team's 8 lanes; n + m above two columns per lane
         "chain8x3": (functools.partial(models.synthetic_chain, state_dim=8,
                                        control_dim=3), "gauss_newton"),
         "chain16x5": (functools.partial(models.synthetic_chain,
                                         state_dim=16, control_dim=5),
                       "exact")}
ITERATE = ("x", "u", "y", "r1x", "r1u", "delta")
EVAL = ("x", "u", "y", "x0", "zlx", "zlu", "zux", "zuu")


def _compiler():
    return shutil.which("g++") or shutil.which("c++")


class HostLibraries:
    """Each model's entry points, built for the host once, in ``root``."""

    def __init__(self, root):
        self.root, self.libs = root, {}

    def get(self, name):
        if name not in self.libs:
            self.libs[name] = _build(self.root, name)
        return self.libs[name]


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    cxx = _compiler()
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    root = tmp_path_factory.mktemp("fused_host")
    probe = root / "probe.cpp"
    probe.write_text("#include <barrier>\nint main() { std::barrier<> b(1);"
                     " b.arrive_and_wait(); }\n")
    if subprocess.run([cxx, "-std=c++20", "-pthread", "-o",
                       str(root / "probe"), str(probe)],
                      capture_output=True).returncode != 0:
        pytest.skip("the host compiler lacks C++20 <barrier>")
    return HostLibraries(root)


def _host_header() -> str:
    """csrc/fused_iter.cuh with its launches as emu_launch calls."""
    with open(os.path.join(cuda_build.CSRC, "fused_iter.cuh")) as fh:
        text = fh.read()
    out, n = re.subn(r"(\S+)<<<([\s\S]*?)>>>\(",
                     r"emu_launch(\1, EmuCfg(\2), ", text)
    assert n == 4
    return out


@functools.lru_cache(maxsize=None)
def _problem(name):
    make, mode = CASES[name]
    spec_m, dims, _, lo, up, _ = make(horizon=T, dtype=torch.float32,
                                      device="cpu")
    spec = fi.build_fused_iter_spec(
        spec_m.dynamics, spec_m.node_cost, spec_m.edge_cost, T,
        dims.max_state_dim, dims.max_control_dim, mode, torch.float32, "cpu")
    assert spec is not None
    return spec, tuple(b[0].numpy() for b in (lo.u, up.u, lo.x, up.x))


def _build(root, name):
    """The model's entry points, compiled for the host under ``root``."""
    spec, bounds = _problem(name)
    out = root / name
    out.mkdir()
    (out / "fused_iter.cuh").write_text(_host_header())
    shutil.copy(os.path.join(cuda_build.CSRC, "riccati_tiny.cuh"), out)
    src = fi.cuda_source(spec, bounds_key(bounds))
    src += ("\nnamespace fused_iter {\nalignas(16) float4 smem4[1 << 15];"
            "\n}\n")
    (out / "lib.cpp").write_text(src)
    lib = out / "lib.so"
    proc = subprocess.run(
        [_compiler(), "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-w", "-I", STUB, "-I", str(out), "-o", str(lib),
         str(out / "lib.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return fi._load(str(lib))


def _inputs(spec, seed):
    n, m = spec.n, spec.m
    rng = np.random.default_rng(seed)
    a = dict(x=0.5 * rng.standard_normal((B, T + 1, n)),
             u=0.5 * rng.standard_normal((B, T, m)),
             y=0.1 * rng.standard_normal((B, T + 1, n)),
             r1x=0.5 + rng.random((B, T + 1, n)),
             r1u=0.5 + rng.random((B, T, m)), delta=np.full(B, 0.01),
             x0=rng.standard_normal((B, n)),
             zlx=rng.random((B, T + 1, n)), zlu=rng.random((B, T, m)),
             zux=rng.random((B, T + 1, n)), zuu=rng.random((B, T, m)))
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in a.items()}


def _ptrs(tensors):
    return [0 if t is None else t.data_ptr() for t in tensors]


def _factor(fns, spec, a):
    n, m = spec.n, spec.m
    s, small = fi.nsym(n), n < fi.GRAM_N

    def empty(*shape):
        return torch.full(shape, float("nan"))
    fac = fi.FusedFactor(
        vc=empty(T, s, B), fc=empty(T, s, B), k=empty(T, m * n, B),
        g=empty(T, m * m, B), a=empty(T, n * n, B) if small else None,
        b=empty(T, n * m, B) if small else None, vroot=empty(s, B))
    assert fns["fused_factor"](B, *_ptrs([a[k] for k in ITERATE]
                                         + list(fac)), None) == 0
    return fac


def _eval(fns, spec, a):
    n, m = spec.n, spec.m
    out = [torch.full(shape, float("nan")) for shape in (
        (B,), (B, T + 1, n), (B, T, m), (B, T + 1, n), (B, T, m),
        (B, T + 1, n), (B, 6))]
    f, gx, gu, ctx, ctu, cdyn, res = out
    assert fns["fused_eval"](B, *_ptrs([a[k] for k in EVAL]
                                       + [gx, gu, ctx, ctu, cdyn, f, res]),
                             None) == 0
    return out


def _close(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, rtol=tol, atol=tol,
                                   msg=f"{what}[{i}]")


@pytest.mark.parametrize("name", sorted(CASES))
def test_factor_kernel_matches_twin(host_libs, name):
    spec, _ = _problem(name)
    fns = host_libs.get(name)
    a = _inputs(spec, seed=1)
    _close(_factor(fns, spec, a),
           fi.factor_reference(spec, *[a[k] for k in ITERATE]), FACTOR_TOL,
           "factor")


@pytest.mark.parametrize("name", sorted(CASES))
def test_factor_failure_stays_in_its_scenario(host_libs, name):
    """A terminal Q far from positive definite fails F's Cholesky in one
    scenario: NaN there, the twin's products everywhere else."""
    spec, _ = _problem(name)
    fns = host_libs.get(name)
    a = _inputs(spec, seed=2)
    a["r1x"][5, T, 0] = -1e4
    got = _factor(fns, spec, a)
    want = fi.factor_reference(spec, *[a[k] for k in ITERATE])
    assert bool(torch.isnan(got.fc[-1][:, 5]).any())
    keep = torch.arange(B) != 5
    _close([t[..., keep] for t in got if t is not None],
           [t[..., keep] for t in want if t is not None], FACTOR_TOL,
           "factor")


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_kernel_matches_twin(host_libs, name):
    spec, bounds = _problem(name)
    fns = host_libs.get(name)
    a = _inputs(spec, seed=3)
    args = [a[k] for k in EVAL]
    got = _eval(fns, spec, a)
    want = fi.eval_reference(spec, bounds, *args)
    _close(got[1:], want[1:], SOLVE_TOL, "eval")
    assert float(((got[0] - want[0]).abs() / want[0].abs()).max()) \
        <= 4 * (T + 1) * F32_EPS
    # the codegen route sums the objective in the kernel's order
    route = fi.eval_codegen(spec, bounds, *args)
    torch.testing.assert_close(got[0], route[0], rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_nan_stays_in_its_scenario(host_libs, name):
    spec, bounds = _problem(name)
    fns = host_libs.get(name)
    a = _inputs(spec, seed=4)
    a["x"][7, 3, 1] = float("nan")
    got = _eval(fns, spec, a)
    want = fi.eval_reference(spec, bounds, *[a[k] for k in EVAL])
    assert bool(torch.isnan(got[-1][7, :2]).all())
    keep = torch.arange(B) != 7
    assert bool(torch.isfinite(got[-1][keep]).all())
    _close([t[keep] for t in got[1:]], [t[keep] for t in want[1:]],
           SOLVE_TOL, "eval")


@pytest.mark.parametrize("name", sorted(CASES))
def test_launch_config_fills_the_card(host_libs, name):
    """At the main path's batch both kernels launch at least one block per
    SM of an H100 (132), within a block's 227 KB of shared memory."""
    fns = host_libs.get(name)
    for kernel in ("fused_factor", "fused_eval"):
        cfg = fi.launch_config(fns, kernel, 4096)
        assert cfg["grid"] >= 132 and cfg["grid"] * cfg["block"] >= 4096
        assert cfg["smem"] <= 232448 and cfg["block"] % 32 == 0
    small = fi.launch_config(fns, "fused_factor", 1)
    assert small["grid"] == 1
