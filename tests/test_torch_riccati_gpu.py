"""The CUDA kernels on the card: the Riccati kernels (explicit-W and Gram
factor, solve backward and forward) and the fused line-search probe, each
wrapper against its plain twin, launch counting, a failed scenario or a NaN
kept to its scenario, and the wrappers' refusals.  Needs a CUDA GPU and skips
without one; imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu \
        tests/test_torch_riccati_gpu.py

Float32 kernels against float32 twins in a different operation order (FMA
contraction): rtol = atol = 2e-4 on factor products, 2e-3 on solutions, the
bars of the TPU kernel's own tests.  The probe: -inf patterns identical,
finite entries within 2e-5 relative (tests/test_pallas_ls.py's bar).
"""

import dataclasses

import numpy as np
import pytest
import torch

from sip_optimal_control_tpu_torch import LQRData, build_problem
from sip_optimal_control_tpu_torch import models
from sip_optimal_control_tpu_torch.ops import ls_probe
from sip_optimal_control_tpu_torch.ops import riccati_cuda as rc

pytestmark = pytest.mark.gpu
FACTOR_TOL, SOLVE_TOL = 2e-4, 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _chain(T, n, m, batch, device, seed=0):
    rng = np.random.default_rng(seed)

    def spd(count, d):
        s = 0.3 * rng.standard_normal((batch, count, d, d))
        return s @ np.swapaxes(s, -1, -2) + 2.0 * np.eye(d)

    arrays = dict(
        Q=spd(T + 1, n), q=rng.standard_normal((batch, T + 1, n)),
        c=rng.standard_normal((batch, T + 1, n)),
        delta=0.5 + rng.random((batch, T + 1, n)),
        A=0.4 * rng.standard_normal((batch, T, n, n)),
        B=0.5 * rng.standard_normal((batch, T, n, m)),
        M=0.1 * rng.standard_normal((batch, T, n, m)), R=spd(T, m),
        r=rng.standard_normal((batch, T, m)))
    return LQRData(**{k: torch.as_tensor(v, dtype=torch.float32,
                                         device=device)
                      for k, v in arrays.items()})


@pytest.mark.parametrize("n,m", sorted(rc.SUPPORTED_SHAPES))
def test_kernels_match_twins(cuda, n, m):
    T, batch = 7, 300                       # batch not a multiple of 128
    data = _chain(T, n, m, batch, cuda)
    rc.reset_launch_counts()
    fact = rc.factor_chain_cuda(data)
    sol = rc.solve_chain_cuda(data, fact)
    torch.cuda.synchronize()
    gram = n >= rc.GRAM_N                   # the factor's form at this n
    assert rc.launch_counts == {"riccati_factor": int(not gram),
                                "riccati_factor_gram": int(gram),
                                "riccati_solve_bwd": 1,
                                "riccati_solve_fwd": 1}
    want_f = rc.factor_chain_reference(data)
    want_s = rc.solve_chain_reference(data, want_f)
    assert torch.equal(fact.status, want_f.status)
    for name in ("V", "W", "K", "G_chol", "F_chol"):
        torch.testing.assert_close(getattr(fact, name), getattr(want_f, name),
                                   rtol=FACTOR_TOL, atol=FACTOR_TOL, msg=name)
    for name in ("x", "u", "y"):
        torch.testing.assert_close(getattr(sol, name), getattr(want_s, name),
                                   rtol=SOLVE_TOL, atol=SOLVE_TOL, msg=name)


def test_wrappers_refuse_unsupported_inputs(cuda):
    data = _chain(4, 4, 1, 16, cuda)
    args = (data.Q, data.delta, data.A, data.B, data.M, data.R)
    with pytest.raises(TypeError, match="float32"):
        rc.factor_kernel(*(a.double() for a in args))
    with pytest.raises(ValueError, match="contiguous"):
        rc.factor_kernel(data.Q.transpose(-1, -2), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        rc.factor_kernel(data.Q, data.delta[:, 1:].contiguous(), *args[2:])
    with pytest.raises(ValueError, match="expected cuda"):
        rc.factor_kernel(data.Q, data.delta.cpu(), *args[2:])
    for n, m in ((5, 1), (8, 2)):
        big = _chain(3, n, m, 4, cuda)
        with pytest.raises(NotImplementedError):
            rc.factor_chain_cuda(big)


def test_failure_status_isolated_on_card(cuda):
    data = _chain(6, 4, 1, 64, cuda, seed=3)
    R = data.R.clone()
    R[5, 2] = -100.0
    data = dataclasses.replace(data, R=R)
    got = rc.factor_chain_cuda(data).status
    want = rc.factor_chain_reference(data).status
    assert torch.equal(got, want)
    assert int(got[5]) != 0 and int((got != 0).sum()) == 1


def test_gram_failure_status_isolated_on_card(cuda):
    data = _chain(6, 16, 4, 64, cuda, seed=4)
    R = data.R.clone()
    R[7, 3] = -torch.eye(4, device=cuda)
    data = dataclasses.replace(data, R=R)
    got = rc.factor_chain_cuda(data).status
    want = rc.factor_chain_reference(data).status
    assert torch.equal(got, want)
    assert int(got[7]) != 0 and int((got != 0).sum()) == 1


@pytest.mark.parametrize("n,m", [(4, 1), (16, 4)])
def test_rollout_nan_isolated_on_card(cuda, n, m):
    """A NaN in one scenario's F_chol at node 4 reaches that scenario's x
    from edge 3 on and no other scenario's (one computing lane per scenario
    at n = 4, a team of lanes at n = 16)."""
    T, batch = 7, 300
    data = _chain(T, n, m, batch, cuda, seed=5)
    fact = rc.factor_chain_reference(data)
    k, v_par = rc.solve_bwd_kernel_reference(
        data.q, data.r, data.c, data.delta, fact.F_chol, fact.G_chol, fact.K,
        data.A, data.B)
    F_chol = fact.F_chol.clone()
    F_chol[9, 4, n - 1, 0] = float("nan")
    x_root = torch.randn(batch, n, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(0))
    args = (x_root, k, fact.K, data.A, data.B, data.c, data.delta,
            torch.cat([v_par, data.q[:, -1:]], dim=1), fact.V, F_chol)
    got = rc.solve_fwd_kernel(*args)
    want = rc.solve_fwd_kernel_reference(*args)
    x = got[1]
    assert bool(torch.isfinite(x[9, :3]).all())
    assert bool(torch.isnan(x[9, 3:]).any(dim=-1).all())
    keep = torch.arange(batch, device=cuda) != 9
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a[keep]).all())
        torch.testing.assert_close(a[keep], b[keep], rtol=SOLVE_TOL,
                                   atol=SOLVE_TOL)


@pytest.mark.parametrize("name", ["cartpole_swingup", "planar_quadrotor",
                                  "synthetic_chain"])
def test_probe_kernel_matches_twin(cuda, name):
    T, batch, chunk = 50, 300, 6
    spec, dims, topo, lo, up, x0 = getattr(models, name)(
        horizon=T, dtype=torch.float32, device=cuda)
    prob = build_problem(spec, dims, topo, x0[None], lo, up)
    fspec, fbounds, _ = prob.fused_ls
    n, m = dims.max_state_dim, dims.max_control_dim
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=torch.float32, device=cuda)

    u = t(batch, T, m, scale=0.3)
    u[0] *= 40.0                    # scenario 0: every candidate infeasible
    args = (t(batch, T + 1, n), t(batch, T + 1, n, scale=0.1), u,
            t(batch, T, m, scale=0.1), t(batch, n),
            torch.as_tensor(0.3 * rng.random((batch, chunk)),
                            dtype=torch.float32, device=cuda))
    ls_probe.reset_launch_counts()
    got = ls_probe.make_fused_probe(fspec, fbounds)(*args)
    torch.cuda.synchronize()
    assert ls_probe.launch_counts == {"ls_probe": 1, "ls_probe_tree": 0}
    want = ls_probe.probe_reference(fspec, fbounds, *args)
    assert bool(torch.isneginf(want[2][0]).all())
    for a, b in zip(got, want):
        assert torch.equal(torch.isneginf(a), torch.isneginf(b))
        fin = torch.isfinite(b)
        assert bool(fin.any())
        err = ((a - b).abs() / (1 + b.abs()))[fin].max()
        assert float(err) < 2e-5
    with pytest.raises(TypeError, match="float32"):
        ls_probe.make_fused_probe(fspec, fbounds)(
            *(a.double() for a in args))


def test_probe_kernel_generic_ops(cuda):
    """The generated CUDA of a stage function over much of the code
    generator's rule table builds and matches the twin."""
    from test_torch_stage_codegen import _many_ops

    T, batch, chunk = 20, 300, 4
    rng = np.random.default_rng(1)
    W = torch.as_tensor(rng.standard_normal((3, 3)), dtype=torch.float32,
                        device=cuda)
    dyn = _many_ops(W)

    def node_cost(x, th, i):
        return 0.5 * torch.where(i == T, 10.0, 1.0).to(x.dtype) * (x ** 2).sum()

    def edge_cost(x, u, th, i):
        return 0.1 * (u ** 2).sum() + torch.exp(-x.abs()).sum()

    fspec = ls_probe.build_fused_spec(dyn, node_cost, edge_cost, T, 3, 1,
                                      torch.float32, cuda)
    assert fspec is not None
    bounds = (np.array([-2.0]), np.array([2.0]),
              np.array([-np.inf, -3.0, -np.inf]), np.array([np.inf, np.inf,
                                                            3.0]))

    def t(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=torch.float32, device=cuda)

    args = (t(batch, T + 1, 3), t(batch, T + 1, 3, scale=0.1),
            t(batch, T, 1, scale=0.3), t(batch, T, 1, scale=0.1),
            t(batch, 3), torch.as_tensor(0.3 * rng.random((batch, chunk)),
                                         dtype=torch.float32, device=cuda))
    got = ls_probe.probe_kernel(fspec, bounds, *args)
    want = ls_probe.probe_reference(fspec, bounds, *args)
    for a, b in zip(got, want):
        assert torch.equal(torch.isneginf(a), torch.isneginf(b))
        fin = torch.isfinite(b)
        assert bool(fin.any())
        assert float(((a - b).abs() / (1 + b.abs()))[fin].max()) < 2e-5
