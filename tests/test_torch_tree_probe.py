"""The tree line-search probe (ops/ls_probe.py, trees) against the JAX package.

Both routes of the port run here on the CPU: the plain twin
(``probe_reference_tree``, the original stage closures) and the kernel's
loop through the per-stage baked programs (``probe_codegen_tree``, the
arithmetic the CUDA kernel runs).  The JAX side is
``_probe_reference_tree`` under ``vmap`` and the Pallas kernel
``_probe_pallas_batched_tree`` in interpret mode, on the inputs of
tests/test_pallas_ls.py:184-210 (robust_tree with 2 shared edges and 3
branches of 3, B=8, chunk 5).  The Pallas kernel runs on the smallest fan
(1 shared edge, 3 branches of 1: node 1 has three children), since
interpret mode costs ~9 s on any tree and ~17 s on the larger one, and
JAX's own tests hold it to its reference at the larger shape.  Random
probe points violate the control
bounds on some candidates: the -inf patterns must be identical, and finite
entries agree within 2e-5 relative (the bar of tests/test_pallas_ls.py).
"""

import numpy as np
import pytest
import jax
import torch

import sip_optimal_control_tpu as J
from sip_optimal_control_tpu.models import robust_scenario_tree as j_rt
from sip_optimal_control_tpu.ops.pallas_ls import (_probe_pallas_batched_tree,
                                                   _probe_reference_tree)
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.model import fused_probe_model
from sip_optimal_control_tpu_torch.models import robust_scenario_tree as p_rt
from sip_optimal_control_tpu_torch.ops import ls_probe

from test_pallas_ls import _random_probe_inputs

TOL = 2e-5
SHAPE = dict(t_shared=2, n_branches=3, t_branch=3)
PALLAS_SHAPE = dict(t_shared=1, n_branches=3, t_branch=1)


def _assert_match(got, want, label):
    for name, a, b in zip(("f", "theta", "logb"), got, want):
        a, b = a.double().numpy(), np.asarray(b, np.float64)
        assert a.shape == b.shape, (label, name)
        assert np.array_equal(np.isneginf(a), np.isneginf(b)), (label, name)
        assert not np.isnan(a).any(), (label, name)
        fin = np.isfinite(b)
        err = np.max(np.abs(a[fin] - b[fin]) / (1.0 + np.abs(b[fin])),
                     initial=0.0)
        assert err < TOL, (label, name, err)


def _port_spec(**shape):
    ps, pd, pt, pl, pu, px0 = p_rt(**shape, dtype=torch.float32,
                                   device="cpu")
    prob = P.build_problem(ps, pd, pt, px0[None], pl, pu)
    assert isinstance(prob.fused_ls[0], ls_probe.TreeLSSpec)
    return prob.fused_ls[:2]


def test_tree_probe_routes_match_jax():
    for shape, pallas in ((SHAPE, False), (PALLAS_SHAPE, True)):
        spec, dims, topo, lower, upper, x0 = j_rt(**shape)
        prob = J.build_problem(spec, dims, topo, initial_state=x0,
                               lower=lower, upper=upper)
        tspec, tbounds, _ = prob.fused_ls
        args = _random_probe_inputs(np.random.default_rng(3), dims, B=8,
                                    chunk=5)
        want = {"reference": jax.vmap(lambda *a: _probe_reference_tree(
            tspec, tbounds, *a))(*args)}
        if pallas:
            want["pallas"] = _probe_pallas_batched_tree(
                tspec, tbounds, *args, interpret=True)
        # the candidates cross the control bounds in some scenarios
        assert np.isneginf(np.asarray(want["reference"][2])).any()
        pspec, pbounds = _port_spec(**shape)
        targs = [torch.as_tensor(np.array(a)) for a in args]
        got = {"twin": ls_probe.probe_reference_tree(pspec, pbounds, *targs),
               "codegen": ls_probe.probe_codegen_tree(pspec, pbounds,
                                                      *targs)}
        for gname, g in got.items():
            for wname, w in want.items():
                _assert_match(g, w, f"{shape} {gname} vs JAX {wname}")
        # the solver's CPU route is the twin
        probe = ls_probe.make_fused_probe(pspec, pbounds)
        for a, b in zip(probe(*targs), got["twin"]):
            assert torch.equal(a, b)


def test_tree_eligibility():
    """robust_tree gets a TreeLSSpec (a program per stage, the index
    baked); a tree model with constraint functions, declared constraint
    rows or stage-varying bounds gets none, as JAX model.py:329-355
    decides."""
    spec, dims, topo, lo, up, x0 = p_rt(**SHAPE, dtype=torch.float32,
                                        device="cpu")
    payload = fused_probe_model(spec, dims, topo, lo, up, torch.float32,
                                "cpu")
    tspec, rows, ispec = payload
    assert ispec is None                  # no whole-iteration payload
    assert (len(tspec.node_progs), len(tspec.dyn_progs)) == (
        dims.num_nodes, dims.num_edges)
    assert tspec.parents == topo.edge_parents and tspec.root == 0
    np.testing.assert_array_equal(rows[0], [-2.0])
    constrained = P.ModelSpec(
        dynamics=spec.dynamics, node_cost=spec.node_cost,
        edge_cost=spec.edge_cost,
        node_ineq=lambda x, th, i: x[:1] - 5.0)
    cdims = P.Dimensions.uniform(num_edges=dims.num_edges, state_dim=2,
                                 control_dim=1, node_g_dim=1)
    assert fused_probe_model(constrained, cdims, topo, lo, up,
                             torch.float32, "cpu") is None
    rows_dims = P.Dimensions.uniform(num_edges=dims.num_edges, state_dim=2,
                                     control_dim=1, edge_c_dim=1)
    assert fused_probe_model(spec, rows_dims, topo, lo, up, torch.float32,
                             "cpu") is None
    varying = P.Primal(x=lo.x, u=lo.u.clone(), theta=lo.theta)
    varying.u[3] = -1.0
    assert fused_probe_model(spec, dims, topo, varying, up, torch.float32,
                             "cpu") is None
    prob = P.build_problem(constrained, cdims, topo, x0[None], lo, up)
    assert prob.fused_ls is None


def test_tree_cuda_source_deduplicates_stage_functions():
    """The bench's robust_tree (horizon 50: 51 nodes, 50 edges) has 2
    distinct node costs, 2 edge costs and 5 dynamics; each is emitted once
    and reached through one switch per kind, and the tree's tables carry
    every parent and child index and each edge's function indices."""
    pspec, pbounds = _port_spec(t_shared=2, n_branches=4, t_branch=12)
    src = ls_probe.cuda_source_tree(pspec, ls_probe.bounds_key(pbounds))
    for prefix, count in (("node_cost", 2), ("edge_cost", 2),
                          ("dynamics", 5)):
        defs = [ln for ln in src.splitlines()
                if ln.startswith(f"__device__ __forceinline__ void {prefix}_")]
        assert len(defs) == count, (prefix, defs)
    assert "kNodes = 51, kEdges = 50, N = 2, M = 1, kRoot = 0" in src
    # edge 14: node 2 -> node 15, the first edge of branch 1
    parents = ", ".join(map(str, pspec.parents))
    assert f"tree_parent[50] = {{{parents}}};" in src
    assert pspec.parents[14] == 2 and pspec.children[14] == 15
    assert "tree_child[50] = {" + ", ".join(map(str, range(1, 51))) in src
    assert "tree_dynamics[50] = {0, 0, " + "1, " * 12 + "2, " in src
    # the switches: 2 + 2 + 5 functions, the last of each the default
    assert src.count("      case ") == 1 + 1 + 4
    assert src.count("      default: ") == 3
    # the state is unbounded: no node bound terms; the controls' two
    assert "safe_log(x[" not in src
    assert src.count("ls_probe_tree::safe_log(u[0] - (-2.0f)) + "
                     "ls_probe_tree::safe_log((2.0f) - u[0])") == 1


def test_tree_kernel_wrapper_refuses_cpu_and_float64():
    pspec, pbounds = _port_spec(**SHAPE)
    N, E = pspec.num_nodes, len(pspec.parents)
    args = [torch.zeros(4, N, 2), torch.zeros(4, N, 2), torch.zeros(4, E, 1),
            torch.zeros(4, E, 1), torch.zeros(4, 2), torch.zeros(4, 6)]
    with pytest.raises(ValueError, match="device"):
        ls_probe.probe_tree_kernel(pspec, pbounds, *args)
    with pytest.raises(TypeError, match="float32"):
        ls_probe.probe_tree_kernel(pspec, pbounds,
                                   *(a.double() for a in args))
    with pytest.raises(ValueError, match="shape"):
        ls_probe.probe_tree_kernel(pspec, pbounds, args[0][:, 1:], *args[1:])
