"""The CUDA Riccati kernels on the card: each wrapper against its plain twin,
launch counting, and the wrappers' refusals.  Needs a CUDA GPU and skips
without one; imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu \
        tests/test_torch_riccati_gpu.py

Float32 kernels against float32 twins in a different operation order (FMA
contraction): rtol = atol = 2e-4 on factor products, 2e-3 on solutions, the
bars of the TPU kernel's own tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sip_optimal_control_tpu_torch import LQRData
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
    assert rc.launch_counts == {"riccati_factor": 1, "riccati_solve_bwd": 1,
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
