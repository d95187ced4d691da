"""The fused line-search probe (ops/ls_probe.py) against the JAX package.

Both routes of the port run here on the CPU: the plain twin
(``probe_reference``, the original stage closures) and the kernel's loop
through the generated scalar programs (``probe_codegen``, the arithmetic the
CUDA kernel runs).  The JAX side is ``_probe_reference`` under ``vmap`` and,
on one small case, the Pallas kernel in interpret mode, on the inputs of
tests/test_pallas_ls.py.  Random probe points violate bounds on some
candidates: the -inf patterns must be identical, and finite entries agree
within 2e-5 relative (the bar of tests/test_pallas_ls.py:60-67; the JAX
models' closures are float64 under this suite's x64, the port's float32).
"""

import numpy as np
import pytest
import jax
import torch

import sip_optimal_control_tpu as J
from sip_optimal_control_tpu import models as jm
from sip_optimal_control_tpu.ops.pallas_ls import (_probe_pallas_batched,
                                                   _probe_reference)
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch import models as pm
from sip_optimal_control_tpu_torch.ops import ls_probe

from test_pallas_ls import _random_probe_inputs

TOL = 2e-5
MODELS = ["cartpole_swingup", "planar_quadrotor", "synthetic_chain"]


def _problems(name, horizon, dtype=torch.float32):
    js, jd, jt, jl, ju, jx0 = getattr(jm, name)(horizon=horizon)
    jprob = J.build_problem(js, jd, jt, initial_state=jx0, lower=jl,
                            upper=ju)
    ps, pd, pt, pl, pu, px0 = getattr(pm, name)(horizon=horizon, dtype=dtype,
                                                device="cpu")
    pprob = P.build_problem(ps, pd, pt, px0[None], pl, pu)
    assert jprob.fused_ls is not None and pprob.fused_ls is not None
    return jprob, pprob, jd


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


def _both_routes(pprob, args):
    fspec, fbounds, _ = pprob.fused_ls
    targs = [torch.as_tensor(np.array(a)) for a in args]
    return {"twin": ls_probe.probe_reference(fspec, fbounds, *targs),
            "codegen": ls_probe.probe_codegen(fspec, fbounds, *targs)}


@pytest.mark.parametrize("u_scale", [1.0, 8.0])
@pytest.mark.parametrize("name", MODELS)
def test_probe_matches_jax_reference(name, u_scale):
    jprob, pprob, dims = _problems(name, 8)
    rng = np.random.default_rng(0)
    args = list(_random_probe_inputs(rng, dims))
    # scaled controls in scenario 0 push its candidates past the bounds
    args[2] = args[2].at[0].multiply(u_scale)
    fspec, fbounds, _ = jprob.fused_ls
    want = jax.vmap(lambda *a: _probe_reference(fspec, fbounds, *a))(*args)
    for route, out in _both_routes(pprob, args).items():
        _assert_match(out, want, (name, route))
    if u_scale > 1:
        lb = np.asarray(want[2])
        assert np.isneginf(lb[0]).all() and np.isfinite(lb).any()


def test_probe_matches_pallas_kernel_interpret():
    jprob, pprob, dims = _problems("cartpole_swingup", 5)
    args = _random_probe_inputs(np.random.default_rng(2), dims, B=8,
                                chunk=4)
    fspec, fbounds, _ = jprob.fused_ls
    want = _probe_pallas_batched(fspec, fbounds, *args, interpret=True)
    for route, out in _both_routes(pprob, args).items():
        _assert_match(out, want, route)


def test_ragged_batch():
    """B = 5 with 3 candidates (the TPU kernel pads to 1024 lanes; the CUDA
    kernel masks its last block)."""
    jprob, pprob, dims = _problems("cartpole_swingup", 5)
    args = _random_probe_inputs(np.random.default_rng(1), dims, B=5,
                                chunk=3)
    fspec, fbounds, _ = jprob.fused_ls
    want = jax.vmap(lambda *a: _probe_reference(fspec, fbounds, *a))(*args)
    for route, out in _both_routes(pprob, args).items():
        assert tuple(out[0].shape) == (5, 3)
        _assert_match(out, want, route)


def test_make_fused_probe_routes_by_device():
    """CPU tensors take the twin (no launch); anything else launches the
    kernel or raises; the kernel takes float32 only."""
    _, pprob, dims = _problems("cartpole_swingup", 4)
    fspec, fbounds, _ = pprob.fused_ls
    args = [torch.as_tensor(np.array(a)) for a in _random_probe_inputs(
        np.random.default_rng(3), dims, B=3, chunk=2)]
    ls_probe.reset_launch_counts()
    probe = ls_probe.make_fused_probe(fspec, fbounds)
    for a, b in zip(probe(*args), ls_probe.probe_reference(fspec, fbounds,
                                                           *args)):
        assert torch.equal(a, b)
    assert ls_probe.launch_counts == {"ls_probe": 0, "ls_probe_tree": 0,
                                      "ls_prologue": 0}
    with pytest.raises(ValueError, match="unsupported device"):
        probe(*(a.to("meta") for a in args))
    with pytest.raises(TypeError, match="float32"):
        ls_probe.probe_kernel(fspec, fbounds, *(a.double() for a in args))
    with pytest.raises(ValueError, match="shape"):
        ls_probe.probe_kernel(fspec, fbounds, args[0][:, 1:], *args[1:])


def test_eligibility_gate():
    """As the JAX package's gate (model.py:356-376): constraint functions,
    declared constraint rows and stage-varying bounds make a chain
    ineligible; a plain chain with stage-constant bounds is eligible."""
    x0 = torch.ones(2, 1, dtype=torch.float32)
    dyn = lambda x, u, th, i: x + u                       # noqa: E731
    dims = P.Dimensions(theta_dim=0, state_dims=(1, 1), control_dims=(1,),
                        node_c_dims=(0, 0), node_g_dims=(0, 0),
                        edge_c_dims=(0,), edge_g_dims=(1,))
    spec = P.ModelSpec(dynamics=dyn, edge_ineq=lambda x, u, th, i: u - 1.0)
    assert P.build_problem(spec, dims, P.Topology.chain(1),
                           x0).fused_ls is None
    dims_b = P.Dimensions(theta_dim=0, state_dims=(1, 1), control_dims=(1,),
                          node_c_dims=(0, 0), node_g_dims=(1, 1),
                          edge_c_dims=(0,), edge_g_dims=(0,))
    assert P.build_problem(P.ModelSpec(dynamics=dyn), dims_b,
                           P.Topology.chain(1), x0).fused_ls is None

    dims_c = P.Dimensions.uniform(num_edges=3, state_dim=1, control_dim=1)
    lo, up = P.box_bounds(dims_c, u_lower=-1.0, u_upper=1.0,
                          dtype=torch.float32, device="cpu")
    spec_c = P.ModelSpec(dynamics=dyn)
    prob = P.build_problem(spec_c, dims_c, P.Topology.chain(3), x0, lo, up)
    assert prob.fused_ls is not None
    assert [list(b) for b in prob.fused_ls[1]] == [[-1.0], [1.0],
                                                   [-np.inf], [np.inf]]
    varying = P.Primal(x=lo.x, u=lo.u.clone(), theta=lo.theta)
    varying.u[1] = -2.0
    assert P.build_problem(spec_c, dims_c, P.Topology.chain(3), x0, varying,
                           up).fused_ls is None


def test_bound_copies_follow_in_place_edits():
    """build_problem reads the box bounds at every build (mpc_steps hands
    it the payload it worked out once): an in-place edit of a bound is seen
    by the next build."""
    x0 = torch.ones(2, 1, dtype=torch.float32)
    dims = P.Dimensions.uniform(num_edges=3, state_dim=1, control_dim=1)
    lo, up = P.box_bounds(dims, u_lower=-1.0, u_upper=1.0,
                          dtype=torch.float32, device="cpu")
    spec = P.ModelSpec(dynamics=lambda x, u, th, i: x + u)

    def build():
        return P.build_problem(spec, dims, P.Topology.chain(3), x0, lo,
                               up).fused_ls

    assert build()[1][0].tolist() == [-1.0]
    assert build()[1][0].tolist() == [-1.0]
    lo.u.fill_(-3.0)
    assert build()[1][0].tolist() == [-3.0]
    lo.u[1] = -2.0
    assert build() is None
