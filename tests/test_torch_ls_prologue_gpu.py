"""The fused trip's line-search prologue kernel on the card
(csrc/ls_prologue.cu): tests/test_torch_ls_prologue.py's shapes and cases
(cartpole T=50 with control bounds only, chain16, a shape with state
bounds; scrubbed, NaN, theta0 == 0 and infeasible lanes) at the main
path's batch (4096), operands aligned and misaligned, against the plain
twin run on the card: the step limits bit-equal, NaN and inf where the
twin's are, the sums within 1e-5 of the sum of their terms' magnitudes;
then one fused cartpole solve at B=4096 through the kernel against one
through the twin.  Needs a CUDA GPU and skips without one; imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu \
        tests/test_torch_ls_prologue_gpu.py
"""

import numpy as np
import pytest
import torch

import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch import models as pm
from sip_optimal_control_tpu_torch._tree import tree_leaves
from sip_optimal_control_tpu_torch.ops import ls_probe
from sip_optimal_control_tpu_torch.solver import fused_chain
from sip_optimal_control_tpu_torch.solver.settings import \
    LineSearchSettings as PLS

from test_torch_ls_prologue import (CASES, SHAPES, assert_edge_lanes,
                                    assert_kernel_match, prologue_inputs)

pytestmark = pytest.mark.gpu
BATCH = 4096
# tests/test_torch_fused_chain.py's bar: float32 in another operation
# order, relative to 1 + |twin|
E2E_TOL = 1e-3


@pytest.fixture(scope="module")
def cuda():
    """The card, with the prologue's library built."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    ls_probe.build_prologue()
    return torch.device("cuda", 0)


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernel_matches_twin_on_card(cuda, shape, case, misaligned):
    args = prologue_inputs(shape, BATCH, seed=200 + len(shape) + len(case),
                           case=case, device=cuda, misaligned=misaligned)
    ls_probe.reset_launch_counts()
    got = ls_probe.ls_prologue(*args)
    torch.cuda.synchronize()
    assert ls_probe.launch_counts["ls_prologue"] == 1
    assert_kernel_match(got, ls_probe.ls_prologue_reference(*args), args)
    assert_edge_lanes(got, case)


def test_fused_solve_through_kernel_on_card(cuda, monkeypatch):
    """One fused cartpole solve (T=50, the benchmark's 5 fixed trips,
    B=4096) through the kernel against one through the twin on the card:
    one launch a trip, statuses and iterations identical, iterates,
    multipliers and KKT errors within E2E_TOL."""
    spec, dims, topo, lo, up, x0 = pm.cartpole_swingup(
        50, dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(11)
    x0s = torch.as_tensor((x0.cpu().numpy() + 0.1 * rng.standard_normal(
        (BATCH, 4))).astype(np.float32), device=cuda)
    settings = P.Settings(
        max_iterations=5, fixed_iterations=True, mu_init=3e-3, tol=1e-3,
        mu_min=1e-5, reg_floor=1e-5, prox_reg=1e-5, max_factor_retries=0,
        fused_iteration=True,
        line_search=PLS(max_steps=6, chunk=6, use_filter_line_search=True,
                        fused_probe=True))
    problem = P.build_problem(spec, dims, topo, x0s, lo, up,
                              hessian_mode="gauss_newton")
    assert fused_chain._eligible(problem, settings)
    ls_probe.reset_launch_counts()
    kernel = P.solve(problem, settings)
    torch.cuda.synchronize()
    assert ls_probe.launch_counts["ls_prologue"] == 5
    monkeypatch.setattr(fused_chain, "ls_prologue",
                        ls_probe.ls_prologue_reference)
    twin = P.solve(problem, settings)
    assert torch.equal(kernel.status, twin.status)
    assert torch.equal(kernel.iterations, twin.iterations)
    for a, b in zip(tree_leaves((kernel.vars, kernel.y.dyn, kernel.zl,
                                 kernel.zu, kernel.kkt_error)),
                    tree_leaves((twin.vars, twin.y.dyn, twin.zl, twin.zu,
                                 twin.kkt_error))):
        assert bool(((a - b).abs() <= E2E_TOL * (1 + b.abs())).all())
