"""The tree line-search probe kernel's CUDA source, run on the CPU.

A tree model's generated source (``ops/ls_probe.py::cuda_source_tree``)
over csrc/ls_probe_tree.cuh is compiled by the host C++ compiler against
tests/host_cuda/cuda_runtime.h, as tests/test_torch_ls_probe_host.py
compiles the chain probe's (every GPU thread an OS thread, blocks in turn,
the shuffles through an exchange array, the ``<<<...>>>`` launch rewritten
into ``emu_launch``).  The real wrapper (``probe_tree_kernel`` and its
``_launch``, which hands the kernel the strides of ``alphas``) then runs on
that library with CPU tensors, held to the plain twin
``probe_reference_tree`` under chip_smoke.py's ``probe_match`` rules (-inf
patterns identical, finite entries within 2e-5 relative).  Trees:
robust_tree at horizon 50 (51 nodes, one window of 64 edges), robust_tree
with 2 shared edges and 3 branches of 3 (a team of 16 lanes, two scenarios
to a warp), a tree rooted at node 2 with two- and three-way branches and
state bounds (tests/test_torch_tree_probe_gpu.py's), and fans of 1 shared
edge and 40 or 80 branches of 1 (node 1 the parent of 40 edges in one
window, of 80 in two windows); a ragged batch (B = 37), 1, 6 and 7
candidates (the last a pass of one), the candidates contiguous and as the
solver's transposed view; the sums within (E + 1) float32 epsilons times
the sum of their terms' magnitudes of a float64 sequential sum of the same
terms; a NaN confined to its scenario and a -inf to its candidate; the
launch configuration.  Skips without a C++20 compiler.
"""

import concurrent.futures
import contextlib
import functools
import os
import re
import subprocess
import types

import numpy as np
import pytest
import torch

import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.model import fused_probe_model
from sip_optimal_control_tpu_torch.models import robust_scenario_tree
from sip_optimal_control_tpu_torch.ops import cuda_build, ls_probe
from sip_optimal_control_tpu_torch.ops.stage_codegen import evaluate

from test_torch_ls_probe_host import (STUB, _compiler, assert_order_bound,
                                      probe_match, transposed)

B = 37


def small_tree(root, parents, children):
    """A tree of n = 3, m = 2 on the given edges, with stage functions that
    read the stage index and finite state bounds on both sides: a maker of
    (spec, dims, topology, lower, upper) at (dtype, device)."""
    return functools.partial(_small_tree, root, parents, children)


def _small_tree(root, parents, children, dtype=torch.float32, device="cpu"):
    topo = P.Topology.tree(root, parents, children)
    n, m = 3, 2
    w = torch.linspace(0.5, 1.5, len(parents) + 1, dtype=dtype,
                       device=device)

    def weight(i):
        return w[i] if isinstance(i, int) else torch.index_select(
            w, 0, i.reshape(1).long())[0]

    spec = P.ModelSpec(
        dynamics=lambda x, u, th, i: torch.cat(
            [x[:1] + 0.1 * torch.sin(x[1:2]) * weight(i),
             x[1:2] + 0.1 * u[:1], x[2:3] - 0.05 * u[1:2] * x[:1]]),
        node_cost=lambda x, th, i: weight(i) * torch.sum(x ** 2),
        edge_cost=lambda x, u, th, i: 0.1 * torch.sum(u ** 2)
        + 0.01 * torch.sum(x[:1] * u[:1]))
    dims = P.Dimensions.uniform(num_edges=len(parents), state_dim=n,
                                control_dim=m)
    lo, up = P.box_bounds(dims, x_lower=[-3.0, -float("inf"), -2.5],
                          x_upper=[3.0, 4.0, float("inf")],
                          u_lower=-1.0, u_upper=[1.0, 2.0], dtype=dtype,
                          device=device)
    return spec, dims, topo, lo, up


def _robust(**shape):
    def make(dtype=torch.float32, device="cpu"):
        return robust_scenario_tree(**shape, dtype=dtype, device=device)[:5]
    return make


# name -> (spec, dims, topology, lower, upper) at (dtype, device)
TREES = {"robust50": _robust(),
         "robust3x3": _robust(t_shared=2, n_branches=3, t_branch=3),
         # rooted at node 2, two- and three-way branches
         "rooted2": small_tree(2, [2, 2, 0, 0, 0, 1], [0, 1, 3, 4, 5, 6]),
         # teams of 8 lanes, more than the 2 to 4 items of a candidate
         "edge1": small_tree(1, [1], [0]),       # not a chain: root 1
         "fork2": small_tree(0, [0, 0], [1, 2]),
         "fork3": small_tree(0, [0, 0, 1], [1, 2, 3]),
         "fan40": _robust(t_shared=1, n_branches=40, t_branch=1),
         # 81 edges: two windows of 64, node 1 the parent in both
         "fan80": _robust(t_shared=1, n_branches=80, t_branch=1)}


@functools.lru_cache(maxsize=None)
def problem(name, device="cpu"):
    """(spec, bounds) of the tree's fused probe."""
    fused = fused_probe_model(*TREES[name](torch.float32, device),
                              torch.float32, device, iteration=False)
    assert fused is not None and isinstance(fused[0], ls_probe.TreeLSSpec)
    return fused[:2]


def tree_inputs(spec, batch, chunk, seed, device="cpu"):
    """Iterate, direction, root state, candidates [B, chunk]; the first
    eighth of the scenarios' controls scaled by 20, so some of their
    candidates violate the control bounds, and scenario 0's at 100, past
    every model's bounds."""
    rng = np.random.default_rng(seed)
    N, E, n, m = spec.num_nodes, len(spec.parents), spec.n, spec.m

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    u = 0.3 * rng.standard_normal((batch, E, m))
    u[:batch // 8] *= 20.0
    u[0] = 100.0
    return (t(rng.standard_normal((batch, N, n))),
            t(0.1 * rng.standard_normal((batch, N, n))), t(u),
            t(0.1 * rng.standard_normal((batch, E, m))),
            t(rng.standard_normal((batch, n))),
            t(0.3 * rng.random((batch, chunk))))


def tree_terms(spec, bounds, x, dx, u, du, x0, alphas):
    """The float32 terms the kernel adds, through the generated programs:
    f, theta and logb [B, chunk, terms], the items (edge e with its child
    node) in edge order, then the root's."""
    lb_u, ub_u, lb_x, ub_x = bounds
    a = alphas[..., None]
    th0 = x.new_zeros(alphas.shape + (0,))

    def node(i):
        return x[:, None, i] + a * dx[:, None, i]

    def total(terms, like):
        return (functools.reduce(torch.add, terms) if terms
                else torch.zeros_like(like))

    f, th, lb = [], [], []
    for e, (p, c) in enumerate(zip(spec.parents, spec.children)):
        xp, xc = node(p), node(c)
        ue = u[:, None, e] + a * du[:, None, e]
        pred = evaluate(spec.dyn_progs[e], xp, ue, th0)
        f.append(evaluate(spec.ecost_progs[e], xp, ue, th0)
                 + evaluate(spec.node_progs[c], xc, th0))
        th.append(total((pred - xc).abs().unbind(-1), f[-1]))
        lb.append(total(ls_probe._bound_terms(ue, lb_u, ub_u)
                        + ls_probe._bound_terms(xc, lb_x, ub_x), f[-1]))
    xr = node(spec.root)
    f.append(evaluate(spec.node_progs[spec.root], xr, th0))
    th.append(total((x0[:, None] - xr).abs().unbind(-1), f[-1]))
    lb.append(total(ls_probe._bound_terms(xr, lb_x, ub_x), f[-1]))
    return [torch.stack(v, -1) for v in (f, th, lb)]


# ---------------------------------------------------------------------------
# the host build
# ---------------------------------------------------------------------------

def _host_tree_header() -> str:
    """csrc/ls_probe_tree.cuh with its launch as an emu_launch call."""
    with open(os.path.join(cuda_build.CSRC, "ls_probe_tree.cuh")) as fh:
        text = fh.read()
    out, n = re.subn(r"([\w:]+(?:<[^<>]*>)?)<<<([\s\S]*?)>>>\(",
                     r"emu_launch(\1, EmuCfg(\2), ", text)
    assert n == 1
    return out + ("\nnamespace ls_probe_tree {\nalignas(16) float4 "
                  "smem4[1 << 15];\n}\n")


class HostLibraries:
    """Each tree's library, built for the host, all at once (one compiler
    each) from the first request on."""

    def __init__(self, root, cxx):
        self.root, self.cxx, self.libs = root, cxx, None
        (root / "ls_probe_tree.cuh").write_text(_host_tree_header())

    def _build(self, name):
        spec, bounds = problem(name)
        src = self.root / f"{name}.cpp"
        src.write_text(ls_probe.cuda_source_tree(spec,
                                                 ls_probe.bounds_key(bounds)))
        lib = self.root / f"lib{name}.so"
        proc = subprocess.run(
            [self.cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-w", "-I", STUB, "-I", str(self.root), "-o", str(lib),
             str(src)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return str(lib)

    def get(self, name):
        if self.libs is None:
            for key in TREES:            # traced here: make_fx is not
                problem(key)             # safe across threads
            pool = concurrent.futures.ThreadPoolExecutor(len(TREES))
            self.libs = {key: pool.submit(self._build, key) for key in TREES}
            pool.shutdown(wait=False)
        return self.libs[name].result()


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    cxx = _compiler()
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    root = tmp_path_factory.mktemp("ls_probe_tree_host")
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
    """probe(name, *args) -> the kernel's (f, theta, logb) through the
    wrapper ``probe_tree_kernel`` on the host library (CPU pointers, no
    stream), counting its launches."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    monkeypatch.setattr(ls_probe, "_check_tree", lambda *args: None)
    ls_probe.reset_launch_counts()

    def probe(name, *args):
        spec, bounds = problem(name)
        entry = ls_probe._load(host_libs.get(name), "ls_probe_tree_f32")
        return ls_probe.probe_tree_kernel(spec, bounds, *args, entry=entry)
    yield probe
    ls_probe.reset_launch_counts()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 6, 7])
@pytest.mark.parametrize("name", list(TREES))
def test_kernel_matches_twin(host_probe, name, chunk):
    """The kernel against probe_reference_tree, the candidates contiguous
    and as the solver's transposed view (the same outputs, bit for bit);
    one launch counted per call."""
    spec, bounds = problem(name)
    args = tree_inputs(spec, B, chunk, seed=len(spec.parents) + chunk)
    want = ls_probe.probe_reference_tree(spec, bounds, *args)
    assert bool(torch.isneginf(want[2]).any())   # some infeasible candidates
    got = host_probe(name, *args)
    assert all(tuple(g.shape) == (B, chunk) for g in got)
    probe_match(got, want)
    got_t = host_probe(name, *args[:5], transposed(args[5]))
    assert all(torch.equal(a, b) for a, b in zip(got, got_t))
    assert ls_probe.launch_counts == {"ls_probe": 0, "ls_probe_tree": 2,
                                      "ls_prologue": 0}


@pytest.mark.parametrize("name", list(TREES))
def test_summation_order_bound(host_probe, name):
    """The kernel's sums (a lane tree, not the twin's order) within (E + 1)
    float32 epsilons times the sum of the terms' magnitudes of a float64
    sequential sum of the same float32 terms."""
    spec, bounds = problem(name)
    args = tree_inputs(spec, B, 6, seed=100)
    got = host_probe(name, *args[:5], transposed(args[5]))
    assert_order_bound(got, tree_terms(spec, bounds, *args),
                       len(spec.parents))


@pytest.mark.parametrize("name,node", [("robust50", 20), ("robust3x3", 7),
                                       ("fan80", 1)])
def test_nan_stays_in_its_scenario(host_probe, name, node):
    """A NaN in scenario 5's iterate (fan80: at node 1, the parent row of
    both windows) makes its f and theta NaN for every candidate and changes
    no other scenario's outputs, also of the scenario sharing its warp
    (robust3x3: teams of 16 lanes)."""
    spec, _ = problem(name)
    args = tree_inputs(spec, B, 6, seed=7)
    clean = host_probe(name, *args)
    x = args[0].clone()
    x[5, node, 1] = float("nan")
    got = host_probe(name, x, *args[1:])
    assert bool(torch.isnan(got[0][5]).all() and torch.isnan(got[1][5]).all())
    keep = torch.arange(B) != 5
    for a, b in zip(got, clean):
        assert torch.equal(a[keep], b[keep])


@pytest.mark.parametrize("name", ["robust50", "robust3x3", "fork2"])
def test_neg_inf_stays_in_its_candidate(host_probe, name):
    """A step far past the control bounds for one candidate (scenario 30,
    candidate 2) makes that candidate's logb -inf and changes no other
    entry of any output."""
    spec, _ = problem(name)
    args = tree_inputs(spec, B, 6, seed=8)
    clean = host_probe(name, *args)
    assert bool(torch.isfinite(clean[2][30]).all())
    alphas = args[5].clone()
    alphas[30, 2] = 1e3
    got = host_probe(name, *args[:5], alphas)
    assert float(got[2][30, 2]) == -np.inf
    keep = torch.ones(B, 6, dtype=torch.bool)
    keep[30, 2] = False
    for a, b in zip(got, clean):
        assert torch.equal(a[keep], b[keep])


def test_launch_config(host_libs):
    """A team of 32 lanes per scenario from E = 31 on (4096 warps at the
    main path's batch, four to a block), in 15,872 B of shared memory at
    robust_tree: one window of 64 edges (x and dx: 128 rows each, padded
    to 3 floats; u and du: 64 rows) and the lanes' 96 sums; 16 lanes and
    windows of 16 edges at E = 11, 8 at E = 6 (rows of 3 floats for n = 3
    and m = 2)."""
    cfg = ls_probe.launch_config
    assert cfg(host_libs.get("robust50"), 4096) == dict(
        grid=1024, block=128, smem=4 * (2 * 128 * 3 + 2 * 64 + 96) * 4,
        lanes=32)
    assert cfg(host_libs.get("robust50"), 1000)["grid"] == 250
    assert cfg(host_libs.get("fan80"), 4096)["lanes"] == 32
    assert cfg(host_libs.get("robust3x3"), B) == dict(
        grid=5, block=128, smem=8 * (2 * 32 * 3 + 2 * 16 + 48) * 4, lanes=16)
    assert cfg(host_libs.get("rooted2"), B) == dict(
        grid=3, block=128, smem=16 * (2 * 16 * 3 + 2 * 8 * 3 + 24) * 4,
        lanes=8)
    assert cfg(host_libs.get("fork2"), B) == dict(
        grid=3, block=128, smem=16 * (2 * 8 * 3 + 2 * 4 * 3 + 24) * 4,
        lanes=8)
    assert cfg(host_libs.get("edge1"), B)["lanes"] == 8
