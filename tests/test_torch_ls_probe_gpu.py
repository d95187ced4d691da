"""The chain line-search probe kernel on the card (csrc/ls_probe.cuh): the
cases of tests/test_torch_ls_probe_host.py at the main path's batch (4096)
and a ragged one (1000), the candidates as the solver hands them over (a
transposed view) and contiguous.  Needs a CUDA GPU and skips without one;
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu \
        tests/test_torch_ls_probe_gpu.py

The bars are the host test's: -inf patterns identical and finite entries
within 2e-5 relative of the plain twin (tests/test_pallas_ls.py's bar), each
sum within (T + 1) float32 epsilons times the sum of its terms' magnitudes
of a float64 sequential sum of the same terms.
"""

import concurrent.futures

import pytest
import torch

from sip_optimal_control_tpu_torch.ops import ls_probe

from test_torch_ls_probe_host import (LIBS, assert_order_bound, probe_inputs,
                                      probe_match, problem, stage_terms,
                                      transposed)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    """The card, with every (model, horizon)'s library built, one nvcc
    each, all at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    device = torch.device("cuda", 0)
    specs = [problem(name, T, device) for name, T in LIBS]
    with concurrent.futures.ThreadPoolExecutor(len(specs)) as pool:
        list(pool.map(lambda sb: ls_probe.build_library(*sb), specs))
    return device


@pytest.mark.parametrize("batch", [4096, 1000])
@pytest.mark.parametrize("name,T", LIBS)
def test_kernel_matches_twin_on_card(cuda, name, T, batch):
    """1, 6 and 7 candidates: one launch counted, the twin's -inf patterns and
    values, the same outputs from either layout of the candidates; with 6,
    the summation order's bound."""
    spec, bounds = problem(name, T, cuda)
    ls_probe._entry(spec, bounds)
    for chunk in (1, 6, 7):
        args = probe_inputs(spec, batch, chunk, T + chunk, cuda)
        alphas_t = transposed(args[5])
        ls_probe.reset_launch_counts()
        got = ls_probe.probe_kernel(spec, bounds, *args[:5], alphas_t)
        torch.cuda.synchronize()
        assert ls_probe.launch_counts == {"ls_probe": 1, "ls_probe_tree": 0,
                                          "ls_prologue": 0}
        probe_match(got, ls_probe.probe_reference(spec, bounds, *args))
        got_c = ls_probe.probe_kernel(spec, bounds, *args)
        assert all(torch.equal(a, b) for a, b in zip(got, got_c))
        if chunk == 6:
            assert_order_bound(got, stage_terms(spec, bounds, *args), T)


@pytest.mark.parametrize("name", ["cartpole", "chain16"])
def test_nan_and_neg_inf_confined_on_card(cuda, name):
    """A NaN in scenario 5's iterate stays in scenario 5 (its f and theta
    NaN for every candidate); a step far past the control bounds for
    (scenario 30, candidate 2) makes that logb -inf; no other entry
    moves."""
    spec, bounds = problem(name, 50, cuda)
    args = probe_inputs(spec, 4096, 6, 9, cuda)
    clean = ls_probe.probe_kernel(spec, bounds, *args)
    x = args[0].clone()
    x[5, 20, 1] = float("nan")
    alphas = args[5].clone()
    alphas[30, 2] = 1e3
    got = ls_probe.probe_kernel(spec, bounds, x, *args[1:5], alphas)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[0][5]).all() and torch.isnan(got[1][5]).all())
    assert float(got[2][30, 2]) == float("-inf")
    keep = torch.ones(4096, 6, dtype=torch.bool, device=cuda)
    keep[5] = False
    keep[30, 2] = False
    for a, b in zip(got, clean):
        assert torch.equal(a[keep], b[keep])


def test_launch_config_on_card(cuda):
    """4096 warps at the main path's shape, four to a block."""
    spec, bounds = problem("chain16", 50, cuda)
    path = ls_probe.build_library(spec, bounds)[0]
    cfg = ls_probe.launch_config(path, 4096)
    assert (cfg["grid"], cfg["block"], cfg["lanes"]) == (1024, 128, 32)
