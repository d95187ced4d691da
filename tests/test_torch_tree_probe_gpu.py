"""The tree line-search probe kernel on the card (csrc/ls_probe_tree.cuh):
the wrapper against its plain twin, both generated variants, launch
counting, a tree rooted elsewhere than node 0 with state bounds, the
robust_tree MPC path, and the cases of tests/test_torch_tree_probe_host.py
at the main path's batch (4096) and a ragged one (1000): every tree of that
file (the fan too), 1, 6 and 7 candidates in both layouts, the summation
order's bound, a NaN and a -inf confined.  Needs a CUDA GPU and skips
without one; imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu \
        tests/test_torch_tree_probe_gpu.py

The probe's bar is tests/test_pallas_ls.py's: -inf patterns identical,
finite entries within 2e-5 relative.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.models import robust_scenario_tree
from sip_optimal_control_tpu_torch.ops import fused_iter, ls_probe
from sip_optimal_control_tpu_torch.ops import riccati_cuda as rc
from sip_optimal_control_tpu_torch.solver.settings import LineSearchSettings

from test_torch_ls_probe_host import (assert_order_bound, probe_match,
                                      transposed)
from test_torch_tree_probe_host import TREES, tree_inputs, tree_terms
from test_torch_tree_probe_host import problem as tree_problem

pytestmark = pytest.mark.gpu
TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _inputs(N, E, n, m, batch, chunk, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=torch.float32, device=device)

    u = t(batch, E, m, scale=0.3)
    u[0] *= 40.0                    # scenario 0: every candidate infeasible
    return (t(batch, N, n), t(batch, N, n, scale=0.1), u,
            t(batch, E, m, scale=0.1), t(batch, n),
            torch.as_tensor(0.3 * rng.random((batch, chunk)),
                            dtype=torch.float32, device=device))


def _assert_match(got, want):
    for a, b in zip(got, want):
        assert torch.equal(torch.isneginf(a), torch.isneginf(b))
        fin = torch.isfinite(b)
        assert bool(fin.any())
        err = ((a - b).abs() / (1 + b.abs()))[fin].max()
        assert float(err) < TOL, float(err)


def test_tree_probe_kernel_matches_twin(cuda):
    """robust_tree at the bench's horizon 50 (51 nodes, 50 edges)."""
    spec, dims, topo, lo, up, x0 = robust_scenario_tree(
        dtype=torch.float32, device=cuda)
    prob = P.build_problem(spec, dims, topo, x0[None], lo, up)
    tspec, tbounds, _ = prob.fused_ls
    args = _inputs(dims.num_nodes, dims.num_edges, 2, 1, 300, 6, cuda)
    ls_probe._entry(tspec, tbounds)          # built before the count
    ls_probe.reset_launch_counts()
    # the solver hands the candidates over as a transposed view
    alphas = args[5].t().contiguous().t()
    got = ls_probe.probe_tree_kernel(tspec, tbounds, *args[:5], alphas)
    torch.cuda.synchronize()
    assert ls_probe.launch_counts == {"ls_probe": 0, "ls_probe_tree": 1}
    want = ls_probe.probe_reference_tree(tspec, tbounds, *args)
    assert bool(torch.isneginf(want[2][0]).all())
    _assert_match(got, want)
    with pytest.raises(TypeError, match="float32"):
        ls_probe.make_fused_probe(tspec, tbounds)(
            *(a.double() for a in args))


def test_tree_probe_kernel_root_and_state_bounds(cuda):
    """A tree rooted at node 2 with two- and three-way branches, a model
    whose stage functions read the stage index, and finite state bounds
    on both sides: the generated node list, bound terms and root row."""
    parents, children = [2, 2, 0, 0, 0, 1], [0, 1, 3, 4, 5, 6]
    topo = P.Topology.tree(2, parents, children)
    n, m = 3, 2
    w = torch.linspace(0.5, 1.5, len(parents) + 1, device=cuda)

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
                          u_lower=-1.0, u_upper=[1.0, 2.0],
                          dtype=torch.float32, device=cuda)
    prob = P.build_problem(spec, dims, topo,
                           torch.zeros(1, n, device=cuda), lo, up)
    tspec, tbounds, _ = prob.fused_ls
    assert tspec.root == 2
    args = _inputs(dims.num_nodes, dims.num_edges, n, m, 257, 5, cuda, 1)
    got = ls_probe.make_fused_probe(tspec, tbounds)(*args)
    torch.cuda.synchronize()
    _assert_match(got, ls_probe.probe_reference_tree(tspec, tbounds, *args))


def test_robust_tree_mpc_launches_only_the_tree_probe(cuda):
    """Two MPC steps of K=2 trips at a small batch: the tree probe launches
    once per trip and no Riccati, fused or chain probe kernel launches.
    Against the standard probe the merit values differ by float32
    roundoff, which can flip a near-tie line-search decision: statuses
    must agree on 95% of the (step, scenario) pairs, and every scenario
    must stay usable."""
    spec, dims, topo, lo, up, x0 = robust_scenario_tree(
        t_branch=3, dtype=torch.float32, device=cuda)
    N, E, batch = dims.num_nodes, dims.num_edges, 64
    gen = torch.Generator(cuda).manual_seed(0)
    x = x0 + 0.1 * torch.randn(batch, 2, device=cuda, generator=gen)
    z = dict(dtype=torch.float32, device=cuda)

    def run(fused_probe):
        settings = P.Settings(
            max_iterations=2, fixed_iterations=True, mu_init=3e-3, tol=1e-3,
            mu_min=1e-5, reg_floor=1e-5, prox_reg=1e-5,
            max_factor_retries=0, riccati_backend="cuda",
            rti_freeze_ev=False,
            line_search=LineSearchSettings(max_steps=6, chunk=6,
                                           use_filter_line_search=True,
                                           fused_probe=fused_probe))
        return P.mpc_steps(
            spec, dims, topo, lo, up, settings, x,
            P.Primal(x[:, None].expand(batch, N, 2).contiguous(),
                     torch.zeros(batch, E, 1, **z),
                     torch.zeros(batch, 0, **z)),
            P.YVec(torch.zeros(batch, N, 2, **z),
                   torch.zeros(batch, N, 0, **z),
                   torch.zeros(batch, E, 0, **z)),
            2, hessian_mode="gauss_newton", noise=0.05)

    for module in (rc, ls_probe, fused_iter):
        module.reset_launch_counts()
    fused = run(True)
    torch.cuda.synchronize()
    counts = {**rc.launch_counts, **ls_probe.launch_counts,
              **fused_iter.launch_counts}
    assert counts == {name: (4 if name == "ls_probe_tree" else 0)
                      for name in counts}
    standard = run(False)
    same = (fused.statuses == standard.statuses).float().mean()
    assert float(same) >= 0.95, float(same)
    assert bool(((fused.statuses == 0) | (fused.statuses == 1)).all())
    assert bool(torch.isfinite(fused.x).all())


# ---------------------------------------------------------------------------
# tests/test_torch_tree_probe_host.py's cases on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree_libs():
    """The card, with every host-test tree's library built, one nvcc each,
    all at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    device = torch.device("cuda", 0)
    specs = [tree_problem(name, device) for name in TREES]
    with concurrent.futures.ThreadPoolExecutor(len(specs)) as pool:
        list(pool.map(lambda sb: ls_probe.build_library(*sb), specs))
    return device


@pytest.mark.parametrize("batch", [4096, 1000])
@pytest.mark.parametrize("name", list(TREES))
def test_tree_kernel_cases_on_card(tree_libs, name, batch):
    """1, 6 and 7 candidates: one launch counted, the twin's -inf patterns
    and values, the same outputs from either layout of the candidates;
    with 6, the summation order's bound from 6 edges on.  Below that the
    bound, (E + 1) float32 epsilons, is smaller than the rounding by which
    the kernel's terms (nvcc contracts them into FMAs) differ from
    PyTorch's, so it would test the terms, not the order: the host test
    holds those trees to it with the same terms."""
    spec, bounds = tree_problem(name, tree_libs)
    E = len(spec.parents)
    for chunk in (1, 6, 7):
        args = tree_inputs(spec, batch, chunk, E + chunk, tree_libs)
        alphas_t = transposed(args[5])
        ls_probe.reset_launch_counts()
        got = ls_probe.probe_tree_kernel(spec, bounds, *args[:5], alphas_t)
        torch.cuda.synchronize()
        assert ls_probe.launch_counts == {"ls_probe": 0, "ls_probe_tree": 1}
        probe_match(got, ls_probe.probe_reference_tree(spec, bounds, *args))
        got_c = ls_probe.probe_tree_kernel(spec, bounds, *args)
        assert all(torch.equal(a, b) for a, b in zip(got, got_c))
        if chunk == 6 and E >= 6:
            assert_order_bound(got, tree_terms(spec, bounds, *args), E)


@pytest.mark.parametrize("batch", [4096, 1000])
@pytest.mark.parametrize("name,node", [("robust50", 20), ("robust3x3", 7),
                                       ("fan80", 1), ("fork2", 1)])
def test_tree_nan_and_neg_inf_confined_on_card(tree_libs, name, node,
                                               batch):
    """A NaN in scenario 5's iterate makes its f and theta NaN for every
    candidate and changes no other scenario's outputs; a step far past the
    control bounds for a feasible scenario's candidate 2 makes that logb
    -inf and changes no other entry."""
    spec, bounds = tree_problem(name, tree_libs)
    args = tree_inputs(spec, batch, 6, 7, tree_libs)
    clean = ls_probe.probe_tree_kernel(spec, bounds, *args)
    x = args[0].clone()
    x[5, node, 1] = float("nan")
    got = ls_probe.probe_tree_kernel(spec, bounds, x, *args[1:])
    assert bool(torch.isnan(got[0][5]).all() and torch.isnan(got[1][5]).all())
    keep = torch.arange(batch, device=tree_libs) != 5
    for a, b in zip(got, clean):
        assert torch.equal(a[keep], b[keep])
    # the last scenario with every candidate feasible (past the eighth
    # with scaled controls; the state bounds of the small trees make some
    # infeasible)
    s = int(torch.isfinite(clean[2]).all(1).nonzero()[-1])
    assert s >= batch // 8
    alphas = args[5].clone()
    alphas[s, 2] = 1e3
    got = ls_probe.probe_tree_kernel(spec, bounds, *args[:5], alphas)
    assert float(got[2][s, 2]) == -np.inf
    keep = torch.ones(batch, 6, dtype=torch.bool, device=tree_libs)
    keep[s, 2] = False
    for a, b in zip(got, clean):
        assert torch.equal(a[keep], b[keep])
