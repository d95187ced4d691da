"""compile_topology's ``use_native`` keyword against the JAX package's
native (C++) and NumPy graph builders.

The port has the NumPy builder only and accepts ``use_native`` so that
calls written for the JAX package run unchanged.  Mirrors
tests/test_native_topology.py (:28 every shape, :43 the same invalid
topologies rejected, :60 large random trees): the port's schedule with
either value of the keyword equals JAX's from both of its builders.  Index
arrays are compared exactly.
"""

import numpy as np
import pytest

import sip_optimal_control_tpu as J
import sip_optimal_control_tpu_torch as P

FIELDS = ("child_offsets", "child_edges", "preorder", "postorder", "depth",
          "parent_edge", "parent_node")


def _shapes():
    yield "chain", (0, list(range(7)), list(range(1, 8)))
    yield "single_node", (0, [], [])
    yield "shallow_wide", (0, [0, 0, 0, 0], [1, 2, 3, 4])
    yield "binary", (0, [(k - 1) // 2 for k in range(1, 8)],
                     list(range(1, 8)))
    yield "nonzero_root", (2, [2, 2, 1], [1, 0, 3])
    yield "shuffled_edges", (0, [1, 0, 1, 3], [2, 1, 3, 4])


def _random_tree(rng, n_edges):
    parents = [0] + [int(rng.integers(0, k + 1)) for k in range(1, n_edges)]
    return 0, parents, list(range(1, n_edges + 1))


def _same(a, b, name):
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=f"{name}:{field}")
    assert len(a.levels_nodes) == len(b.levels_nodes), name
    for x, y in zip(a.levels_nodes + a.levels_edges,
                    b.levels_nodes + b.levels_edges):
        np.testing.assert_array_equal(x, y, err_msg=name)


def _same_as_jax(topo, root, parents, children, name):
    """The port's schedule, with use_native either way, equals JAX's from
    its native builder and from its NumPy one."""
    jtopo = J.Topology.tree(root, parents, children)
    for use_native in (True, False):
        got = P.compile_topology(topo, use_native=use_native)
        for j_native in (True, False):
            _same(got, J.compile_topology(jtopo, use_native=j_native),
                  f"{name} (port {use_native}, jax {j_native})")


def test_native_matches_numpy_and_jax_on_all_shapes():
    for name, (root, parents, children) in _shapes():
        topo = P.Topology.tree(root, parents, children)
        _same_as_jax(topo, root, parents, children, name)


def test_native_rejects_invalid_topologies():
    bad = [
        (5, [0], [1]),                      # root out of range
        (0, [0], [0]),                      # self loop
        (0, [0, 1], [1, 1]),                # in-degree 2
        (0, [0, 2], [1, 2]),                # self-referential
        (1, [1, 2], [2, 1]),                # root has a parent
        (0, [0, 3], [1, 2]),                # edge out of range
    ]
    for root, parents, children in bad:
        topo = P.Topology.tree(root, parents, children)
        for use_native in (True, False):
            with pytest.raises(P.TopologyError):
                P.compile_topology(topo, use_native=use_native)


def test_large_random_trees_agree():
    rng = np.random.default_rng(0)
    for _ in range(5):
        root, parents, children = _random_tree(rng, 200)
        topo = P.Topology.tree(root, parents, children)
        _same_as_jax(topo, root, parents, children, "random")
