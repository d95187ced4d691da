"""The port's host-side types and settings against the JAX package.

Schedules are integer arrays and settings are plain values, so every
comparison here is exact."""

import dataclasses

import numpy as np
import pytest

import sip_optimal_control_tpu as J
from sip_optimal_control_tpu.solver import settings as jset
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.solver import settings as pset

_SCHEDULE_FIELDS = ("child_offsets", "child_edges", "preorder", "postorder",
                    "depth", "parent_edge", "parent_node")


@pytest.mark.parametrize("edges", [
    ("chain", 50),
    ("tree", (0, [0, 0, 1, 1, 2], [1, 2, 3, 4, 5])),
    ("tree", (2, [2, 2, 0, 0], [0, 1, 3, 4])),
])
def test_compiled_schedules_equal_jax(edges):
    kind, spec = edges
    if kind == "chain":
        jt, pt = J.Topology.chain(spec), P.Topology.chain(spec)
    else:
        jt, pt = J.Topology.tree(*spec), P.Topology.tree(*spec)
    js, ps = J.compile_topology(jt), P.compile_topology(pt)
    for name in _SCHEDULE_FIELDS:
        np.testing.assert_array_equal(getattr(ps, name), getattr(js, name),
                                      err_msg=name)
    assert len(ps.levels_nodes) == len(js.levels_nodes)
    for a, b in zip(ps.levels_nodes + ps.levels_edges,
                    js.levels_nodes + js.levels_edges):
        np.testing.assert_array_equal(a, b)
    assert ps.topology.is_chain == js.topology.is_chain


def test_validation_and_invalid_topologies_match_jax():
    dims_kw = dict(theta_dim=0, state_dims=(2, 1, 3), control_dims=(1, 2),
                   node_c_dims=(0, 1, 0), node_g_dims=(1, 0, 2),
                   edge_c_dims=(2, 1), edge_g_dims=(1, 3))
    for parents, children in (([0, 0], [1, 2]), ([0, 1], [2, 2]),
                              ([0, 1], [1, 2])):
        j = J.validate_input(J.Dimensions(**dims_kw),
                             J.Topology.tree(0, parents, children))
        p = P.validate_input(P.Dimensions(**dims_kw),
                             P.Topology.tree(0, parents, children))
        assert int(p) == int(j)
    with pytest.raises(P.TopologyError):
        P.compile_topology(P.Topology.tree(0, [0, 1], [2, 2]))
    sched, status = P.try_compile_topology(P.Topology.tree(0, [1], [1]))
    assert sched is None and status == P.FactorStatus.INVALID_TOPOLOGY


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_settings_defaults_equal_jax():
    jd, pd = _fields(jset.Settings()), _fields(pset.Settings())
    # matmul_precision addresses the TPU's bf16 passes; the port keeps TF32
    # off instead and drops the field
    assert jd.pop("matmul_precision") == "highest"
    jls, pls = jd.pop("line_search"), pd.pop("line_search")
    jlog, plog = jd.pop("logging"), pd.pop("logging")
    assert pd == jd
    assert _fields(pls) == _fields(jls)
    assert _fields(plog) == _fields(jlog)
    assert {int(s): s.name for s in pset.SIPStatus} == {
        int(s): s.name for s in jset.SIPStatus}


def test_settings_reject_unported_paths():
    with pytest.raises(ValueError, match="cuda"):
        pset.Settings(riccati_backend="pallas")
    with pytest.raises(ValueError):
        pset.Settings(riccati_backend="assoc")
    with pytest.raises(NotImplementedError):
        pset.Settings(fused_iteration=True)
    with pytest.raises(NotImplementedError):
        pset.LineSearchSettings(fused_probe=True)
    assert pset.Settings(riccati_backend="cuda").riccati_backend == "cuda"
