"""The port's KKT condensation, solve and operators against the JAX package.

Random θ-free stage data with positive regularizations in [0.3, 1.5]
(tests/test_kkt.py's generators) is well conditioned, so parity with JAX is
fp64 roundoff: 1e-12.  The round trip ||K sol - rhs|| keeps the JAX test's
1e-9 bar.
"""

import dataclasses

import numpy as np
import pytest
import jax
import torch

import sip_optimal_control_tpu as J
from sip_optimal_control_tpu.ops import kkt as JK
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.ops import kkt as PK
from sip_optimal_control_tpu_torch._tree import tree_leaves

from test_kkt import make_regs, random_rhs, synthetic_model

_TOL = 1e-12

CASES = {
    # reference: variable_dimensions_test.cpp:265-290 (variable dims)
    "variable_dims": dict(theta_dim=0, state_dims=(2, 1, 3),
                          control_dims=(1, 2), node_c_dims=(1, 0, 2),
                          node_g_dims=(0, 2, 1), edge_c_dims=(1, 2),
                          edge_g_dims=(2, 1)),
    "uniform": dict(theta_dim=0, state_dims=(4,) * 7, control_dims=(2,) * 6,
                    node_c_dims=(2,) * 7, node_g_dims=(2,) * 7,
                    edge_c_dims=(1,) * 6, edge_g_dims=(3,) * 6),
}


def _stack(trees):
    """Per-scenario JAX containers -> one batched numpy container."""
    return jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]),
                        *trees)


@pytest.mark.parametrize("case", sorted(CASES))
def test_factor_solve_parity_and_round_trip(case):
    jdims = J.Dimensions(**CASES[case])
    jtopo = J.Topology.chain(jdims.num_edges)
    jsched = J.compile_topology(jtopo)
    jmasks = JK.ConstraintMasks.build(jdims)
    models, regss, rhss, sols = [], [], [], []
    for seed in (10, 11):
        rng = np.random.default_rng(seed)
        model = synthetic_model(jdims, jtopo, rng)
        regs = make_regs(jdims, jmasks, rng)
        rhs = random_rhs(jdims, jmasks, rng)
        fact = JK.kkt_factor(model, regs, jmasks, jsched)
        assert int(fact.status) == 0
        sols.append(JK.kkt_solve(fact, model, rhs, jsched))
        models.append(model)
        regss.append(regs)
        rhss.append(rhs)

    dims = P.Dimensions(**CASES[case])
    sched = P.compile_topology(P.Topology.chain(dims.num_edges))
    masks = PK.ConstraintMasks.build(dims)
    model = P.from_jax_numpy(PK.StageModelData, _stack(models))
    regs = P.from_jax_numpy(PK.Regularizations, _stack(regss))
    rhs = P.from_jax_numpy(PK.KKTVector, _stack(rhss))
    fact = PK.kkt_factor(model, regs, masks, sched)
    assert fact.status.tolist() == [0, 0]
    sol = PK.kkt_solve(fact, model, rhs, sched)

    want = P.from_jax_numpy(PK.KKTVector, _stack(sols))
    for f in dataclasses.fields(sol):
        torch.testing.assert_close(getattr(sol, f.name), getattr(want, f.name),
                                   rtol=_TOL, atol=_TOL, msg=f.name)
    resid = (PK.apply_K(model, regs, sol, sched) - rhs).norm()
    assert float(resid.max()) < 1e-9, resid


def test_operators_match_jax():
    jdims = J.Dimensions(**CASES["uniform"])
    jtopo = J.Topology.chain(jdims.num_edges)
    jsched = J.compile_topology(jtopo)
    rng = np.random.default_rng(12)
    jmodel = synthetic_model(jdims, jtopo, rng)
    jv = random_rhs(jdims, JK.ConstraintMasks.build(jdims), rng)
    sched = P.compile_topology(P.Topology.chain(jdims.num_edges))
    model = P.from_jax_numpy(PK.StageModelData, _stack([jmodel]))
    v = P.from_jax_numpy(PK.KKTVector, _stack([jv]))
    for name in ("apply_H", "apply_C", "apply_CT", "apply_G", "apply_GT"):
        want = P.from_jax_numpy(PK.KKTVector, _stack(
            [getattr(JK, name)(jmodel, jv, jsched)]))
        got = getattr(PK, name)(model, v, sched)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(a, b, rtol=_TOL, atol=_TOL, msg=name)

