"""The port's flat-vector interop (ops/flatten.py) against the JAX
package's.

Mirrors tests/test_flatten.py (:26 offsets against the reference layout,
:46 primal round trip, :61 KKT round trip and batching, :78 the dense
flat-coordinate KKT oracle against the stagewise solve) on the same
variable-dimension problem with θ, holding every layout array and flat
vector equal to JAX's (gathers and scatters move values exactly), the
dense KKT matrix to JAX's at fp64 roundoff (1e-12) and the dense solve to
the port's kkt_solve at the JAX test's 1e-9.
"""

import dataclasses

import numpy as np
import jax
import torch

import sip_optimal_control_tpu as J
from sip_optimal_control_tpu.ops import flatten as JF
from sip_optimal_control_tpu.ops import kkt as JK
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.ops import flatten as PF
from sip_optimal_control_tpu_torch.ops import kkt as PK

from test_kkt import make_regs, random_rhs, synthetic_model

VD = dict(theta_dim=2, state_dims=(2, 1, 3), control_dims=(1, 2),
          node_c_dims=(1, 0, 2), node_g_dims=(0, 2, 1),
          edge_c_dims=(1, 2), edge_g_dims=(2, 1))
PARENTS, CHILDREN = [0, 0], [1, 2]
LAYOUT_FIELDS = ("x_state_offsets", "x_control_offsets", "y_dyn_offsets",
                 "y_node_c_offsets", "y_edge_c_offsets", "z_node_offsets",
                 "z_edge_offsets", "primal_gather", "y_gather", "z_gather")


def _stack(trees):
    """Per-scenario JAX containers -> one batched numpy container."""
    return jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]),
                        *trees)


def _rhs_batch(seeds):
    jdims = J.Dimensions(**VD)
    jmasks = JK.ConstraintMasks.build(jdims)
    return [random_rhs(jdims, jmasks, np.random.default_rng(s))
            for s in seeds]


def test_offsets_match_reference_layout_and_jax():
    layout = PF.build_flat_layout(P.Dimensions(**VD))
    want = JF.build_flat_layout(J.Dimensions(**VD))
    for name in LAYOUT_FIELDS:
        np.testing.assert_array_equal(getattr(layout, name),
                                      getattr(want, name), err_msg=name)
    # hand-computed against populate_workspace_metadata
    # (reference: types.cpp:33-63)
    assert layout.x_state_offsets.tolist() == [0, 3, 6]
    assert layout.x_control_offsets.tolist() == [2, 4]
    assert layout.theta_offset == want.theta_offset == 9
    assert (layout.x_dim, layout.y_dim, layout.z_dim) == (11, 12, 6)
    assert layout.kkt_dim == want.kkt_dim == 29


def test_primal_roundtrip_variable_dims():
    rng = np.random.default_rng(0)
    masks = JK.ConstraintMasks.build(J.Dimensions(**VD))
    B = 2
    x = rng.standard_normal((B, 3, 3)) * masks.state
    u = rng.standard_normal((B, 2, 2)) * masks.control
    th = rng.standard_normal((B, 2))
    jlayout = JF.build_flat_layout(J.Dimensions(**VD))
    want = np.stack([np.asarray(JF.flatten_primal(jlayout, x[b], u[b],
                                                  th[b])) for b in range(B)])
    layout = PF.build_flat_layout(P.Dimensions(**VD))
    flat = PF.flatten_primal(layout, *map(torch.as_tensor, (x, u, th)))
    assert tuple(flat.shape) == (B, 11)
    np.testing.assert_array_equal(flat.numpy(), want)
    for got, ref in zip(PF.unflatten_primal(layout, flat), (x, u, th)):
        np.testing.assert_array_equal(got.numpy(), ref)


def test_kkt_roundtrip_and_batching():
    jvs = _rhs_batch((1, 2, 3))
    jlayout = JF.build_flat_layout(J.Dimensions(**VD))
    want = np.stack([np.asarray(JF.flatten_kkt(jlayout, v)) for v in jvs])
    layout = PF.build_flat_layout(P.Dimensions(**VD))
    v = P.from_jax_numpy(PK.KKTVector, _stack(jvs))
    flat = PF.flatten_kkt(layout, v)
    assert tuple(flat.shape) == (3, layout.kkt_dim)
    np.testing.assert_array_equal(flat.numpy(), want)
    back = PF.unflatten_kkt(layout, flat)
    for f in dataclasses.fields(back):
        assert torch.equal(getattr(back, f.name), getattr(v, f.name)), f.name
    # every scenario of the batch on its own gives its row
    one = PF.flatten_kkt(layout, PK.KKTVector(**{
        f.name: getattr(v, f.name)[1:2] for f in dataclasses.fields(v)}))
    assert torch.equal(one[0], flat[1])


def test_dense_flat_kkt_matches_jax_and_stagewise_solve():
    """K in flat coordinates against JAX's, solved densely against the
    port's condensed stagewise kkt_solve, θ Schur path included."""
    jdims = J.Dimensions(**VD)
    jtopo = J.Topology.tree(0, PARENTS, CHILDREN)
    jsched = J.compile_topology(jtopo)
    jmasks = JK.ConstraintMasks.build(jdims)
    jlayout = JF.build_flat_layout(jdims)
    models, regss, rhss, wants = [], [], [], []
    for seed in (2, 3):
        rng = np.random.default_rng(seed)
        models.append(synthetic_model(jdims, jtopo, rng))
        regss.append(make_regs(jdims, jmasks, rng))
        rhss.append(random_rhs(jdims, jmasks, rng))
        wants.append(np.asarray(JF.dense_kkt_matrix(
            jlayout, models[-1], regss[-1], jsched)))

    dims = P.Dimensions(**VD)
    sched = P.compile_topology(P.Topology.tree(0, PARENTS, CHILDREN))
    layout = PF.build_flat_layout(dims)
    model = P.from_jax_numpy(PK.StageModelData, _stack(models))
    regs = P.from_jax_numpy(PK.Regularizations, _stack(regss))
    rhs = P.from_jax_numpy(PK.KKTVector, _stack(rhss))
    K = PF.dense_kkt_matrix(layout, model, regs, sched)
    assert tuple(K.shape) == (2, 29, 29)
    np.testing.assert_allclose(K.numpy(), np.stack(wants), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(K, K.transpose(1, 2), rtol=0, atol=1e-12)

    dense = torch.linalg.solve(K, PF.flatten_kkt(layout, rhs))
    fact = PK.kkt_factor(model, regs, PK.ConstraintMasks.build(dims), sched)
    assert fact.status.tolist() == [0, 0]
    sol = PK.kkt_solve(fact, model, rhs, sched)
    torch.testing.assert_close(PF.flatten_kkt(layout, sol), dense, rtol=0,
                               atol=1e-9)
