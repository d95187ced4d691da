"""The port's batched MPC step against the benchmark's JAX program.

``mpc_steps`` is the package form of ``bench.py::build_mpc_scan`` with
``steps_per_call > 1``: same failsafe, reset, shift warm start and
fixed-seed disturbance.  Three steps at batch 4 in fp64; statuses and
iteration counts identical, everything else within rtol = atol = 1e-6 (the
per-solve ~1e-8 relative drift of test_torch_solver.py, compounded over
three closed-loop steps).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

import bench
from sip_optimal_control_tpu import Settings as JSettings
from sip_optimal_control_tpu.mpc import _shift_warm_start as j_shift
from sip_optimal_control_tpu.solver.settings import \
    LineSearchSettings as JLS
from sip_optimal_control_tpu.solver.sip import Primal as JPrimal
from sip_optimal_control_tpu.solver.sip import YVec as JYVec
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.models import cartpole_swingup as p_cartpole
from sip_optimal_control_tpu_torch.mpc import _shift_warm_start, \
    mpc_disturbance
from sip_optimal_control_tpu_torch.solver.settings import \
    LineSearchSettings as PLS
from sip_optimal_control_tpu_torch._tree import tree_leaves

H, BATCH, STEPS = 10, 4, 3
# the benchmark's RTI settings (bench.py:860-918), K = 3 trips
KW = dict(max_iterations=3, fixed_iterations=True, mu_init=3e-3, tol=1e-3,
          mu_min=1e-5, reg_floor=1e-5, prox_reg=1e-5, max_factor_retries=0)
LS = dict(max_steps=6, chunk=6, use_filter_line_search=True)


def test_mpc_steps_matches_bench_program():
    spec, dims, topo, lo, up, x0 = bench.get_model("cartpole", H)
    N, E, n = dims.num_nodes, dims.num_edges, dims.max_state_dim
    rng = np.random.default_rng(0)
    x0s = np.tile(np.asarray(x0), (BATCH, 1)) \
        + 0.1 * rng.standard_normal((BATCH, n))
    wv = JPrimal(jnp.tile(x0s[:, None], (1, N, 1)), jnp.zeros((BATCH, E, 1)),
                 jnp.zeros((BATCH, 0)))
    wy = JYVec(jnp.zeros((BATCH, N, n)), jnp.zeros((BATCH, N, 0)),
               jnp.zeros((BATCH, E, 0)))
    step = bench.build_mpc_scan(
        spec, dims, topo, lo, up, JSettings(**KW, line_search=JLS(**LS)),
        "gauss_newton", steps_per_call=STEPS, noise=0.05, batch=BATCH)
    want = [np.asarray(a) for a in jax.tree.leaves(
        step(jnp.asarray(x0s), wv, wy))]

    spec, dims, topo, lo, up, _ = p_cartpole(H)
    x = torch.as_tensor(x0s)
    f64 = dict(dtype=torch.float64)
    got = P.mpc_steps(
        spec, dims, topo, lo, up, P.Settings(**KW, line_search=PLS(**LS)),
        x, P.Primal(x[:, None].expand(BATCH, N, n).clone(),
                    torch.zeros(BATCH, E, 1, **f64),
                    torch.zeros(BATCH, 0, **f64)),
        P.YVec(torch.zeros(BATCH, N, n, **f64),
               torch.zeros(BATCH, N, 0, **f64),
               torch.zeros(BATCH, E, 0, **f64)),
        STEPS, hessian_mode="gauss_newton", noise=0.05)
    assert tuple(got.statuses.shape) == (STEPS, BATCH)
    np.testing.assert_array_equal(got.statuses.numpy(), want[-3])
    np.testing.assert_array_equal(got.iterations.numpy(), want[-2])
    got_leaves = tree_leaves((got.x, got.vars, got.y, got.kkt_errors))
    want_leaves = want[:-3] + want[-1:]
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6)


def test_shift_warm_start_and_disturbance_match_jax():
    rng = np.random.default_rng(1)
    x, u = rng.standard_normal((2, 5, 3)), rng.standard_normal((2, 4, 1))
    dyn = rng.standard_normal((2, 5, 3))
    jv, jy = jax.vmap(j_shift)(
        JPrimal(x, u, np.zeros((2, 0))),
        JYVec(dyn, np.zeros((2, 5, 0)), np.zeros((2, 4, 0))))
    t = torch.as_tensor
    pv, py = _shift_warm_start(
        P.Primal(t(x), t(u), torch.zeros(2, 0)),
        P.YVec(t(dyn), torch.zeros(2, 5, 0), torch.zeros(2, 4, 0)))
    for a, b in zip(tree_leaves((pv, py)), jax.tree.leaves((jv, jy))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the benchmark's disturbance: seed 12345, rounded to float32
    want = (0.05 * np.random.default_rng(12345).standard_normal(
        (25, 8, 4))).astype(np.float32)
    got = mpc_disturbance(25, 8, 4, 0.05, torch.float64, "cpu")
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float64))
