"""The whole-iteration fused kernels on the card (ops/fused_iter.py,
csrc/fused_iter.cuh): each kernel's wrapper against its plain twin on the
three models that cover every branch (cartpole Gauss-Newton: n=4, explicit
W, full layout; quadrotor exact: n=6, explicit W, packed; chain16
Gauss-Newton: n=16, Gram form, packed, A and B recomputed), the fused
Newton step against ``factor_solve_reference``, launch counting and the
wrappers' refusals.  Needs a CUDA GPU and skips without one; imports no
JAX:

    python -m pytest --noconftest -o addopts="" -m gpu \
        tests/test_torch_fused_iter_gpu.py

Well-conditioned float32 data (delta 0.01, r1 in [0.5, 1.5]): factor
products within rtol = atol = 2e-4, solve products and the eval outputs
within 2e-3 (float32 in another operation order, FMA contraction).  The
Newton step against ``factor_solve_reference`` (the chain LQR's per-row
W form, another float32 formulation) is held, relative to 1 + |reference|,
to COND_FACTOR times the error of the kernels' chained plain twins
(``factor_solve_plain``, their algorithm in plain float32 PyTorch) plus the
JAX package's own bar (tests/test_fused_iter.py: 2e-5 cartpole, 5e-5
quadrotor exact, 2e-4 chain16): at T = 7 the explicit W's cancellation
compounds past the bar set at T = 4 (4.3e-5 on cartpole), in the twins as
in the kernels.

The redesigned factor and eval (the terminal node in the kernel, a team of
lanes per scenario, the eval parallel over nodes) are also held at the main
path's shape (T = 50, B = 4096) and a ragged B = 1000; the team factor
also at chain models of other (n, m); a failed Cholesky and a NaN stay in
their scenario; and the wrappers never reach the torch.func terminal
pieces.  The eval's
objective sums in another order than the twin's: it is held within
4 (T + 1) float32 epsilons relative (both sums of T + 1 nonnegative float32
terms), the other outputs at SOLVE_TOL.
"""

import numpy as np
import pytest
import torch

from sip_optimal_control_tpu_torch import models
from sip_optimal_control_tpu_torch.ops import fused_iter as fi

pytestmark = pytest.mark.gpu
FACTOR_TOL, SOLVE_TOL = 2e-4, 2e-3
COND_FACTOR = 4
CASES = {"cartpole": (models.cartpole_swingup, "gauss_newton", 2e-5),
         "quadrotor": (models.planar_quadrotor, "exact", 5e-5),
         "chain16": (models.synthetic_chain, "gauss_newton", 2e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _problem(name, T, device):
    make, mode, tol = CASES[name]
    spec_m, dims, _, lo, up, _ = make(horizon=T, dtype=torch.float32,
                                      device=device)
    n, m = dims.max_state_dim, dims.max_control_dim
    spec = fi.build_fused_iter_spec(spec_m.dynamics, spec_m.node_cost,
                                    spec_m.edge_cost, T, n, m, mode,
                                    torch.float32, device)
    assert spec is not None
    bounds = tuple(b[0].cpu().numpy() for b in (lo.u, up.u, lo.x, up.x))
    return spec, bounds, tol


def _inputs(spec, B, device, seed=0):
    T, n, m = spec.horizon, spec.n, spec.m
    rng = np.random.default_rng(seed)
    arrays = dict(
        x=0.5 * rng.standard_normal((B, T + 1, n)),
        u=0.5 * rng.standard_normal((B, T, m)),
        y=0.1 * rng.standard_normal((B, T + 1, n)),
        r1x=0.5 + rng.random((B, T + 1, n)), r1u=0.5 + rng.random((B, T, m)),
        delta=np.full(B, 0.01), q=rng.standard_normal((B, T + 1, n)),
        r=rng.standard_normal((B, T, m)), c=rng.standard_normal((B, T + 1, n)),
        x0=rng.standard_normal((B, n)), zlx=rng.random((B, T + 1, n)),
        zlu=rng.random((B, T, m)), zux=rng.random((B, T + 1, n)),
        zuu=rng.random((B, T, m)))
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in arrays.items()}


def _close(got, want, tol, what):
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None:
            assert b is None
            continue
        torch.testing.assert_close(a, b, rtol=tol, atol=tol,
                                   msg=f"{what}[{i}]")


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_match_twins(cuda, name):
    T, B = 7, 300                          # batch not a multiple of 128
    spec, bounds, _ = _problem(name, T, cuda)
    a = _inputs(spec, B, cuda)
    it = (a["x"], a["u"], a["y"], a["r1x"], a["r1u"], a["delta"])
    fi.reset_launch_counts()
    fac = fi.factor_kernel(spec, *it, bounds=bounds)
    fac_t = fi.factor_reference(spec, *it)
    _close(fac, fac_t, FACTOR_TOL, "factor")
    assert (fac.a is None) == (spec.n >= fi.GRAM_N)
    back = fi.solve_bwd_kernel(spec, fac_t, a["x"], a["u"], a["q"], a["r"],
                               a["c"], a["delta"], bounds=bounds)
    back_t = fi.solve_bwd_reference(spec, fac_t, a["x"], a["u"], a["q"],
                                    a["r"], a["c"], a["delta"])
    _close(back, back_t, SOLVE_TOL, "solve_bwd")
    fwd = fi.solve_fwd_kernel(spec, fac_t, back_t, a["x"], a["u"], a["c"],
                              a["delta"], bounds=bounds)
    fwd_t = fi.solve_fwd_reference(spec, fac_t, back_t, a["x"], a["u"],
                                   a["c"], a["delta"])
    _close(fwd, fwd_t, SOLVE_TOL, "solve_fwd")
    ev_args = [a[k] for k in ("x", "u", "y", "x0", "zlx", "zlu", "zux",
                              "zuu")]
    ev = fi.eval_kernel(spec, bounds, *ev_args)
    ev_t = fi.eval_reference(spec, bounds, *ev_args)
    _close(ev, ev_t, SOLVE_TOL, "eval")
    torch.cuda.synchronize()
    assert fi.launch_counts == {"fused_factor": 1, "fused_solve_bwd": 1,
                                "fused_solve_fwd": 1, "fused_eval": 1}


@pytest.mark.parametrize("name", sorted(CASES))
def test_newton_step_matches_reference(cuda, name):
    T, B = 7, 300
    spec, bounds, tol = _problem(name, T, cuda)
    a = _inputs(spec, B, cuda, seed=1)
    args = [a[k] for k in ("x", "u", "y", "r1x", "r1u", "delta", "q", "r",
                           "c")]
    step = fi.make_fused_factor_solve(spec, bounds)
    got = step(*args)
    plain = fi.factor_solve_plain(spec, *args)
    want = fi.factor_solve_reference(spec, *args)
    torch.cuda.synchronize()

    def rel(a, b):
        return max(float(((x - y).abs() / (1 + y.abs())).max())
                   for x, y in zip(a[:3], b[:3]))
    assert rel(got, want) <= COND_FACTOR * rel(plain, want) + tol
    assert torch.equal(got[3], want[3])
    assert bool((want[3] == 0).all())


def test_statuses_flag_a_failed_factor(cuda):
    """A non-PD control Hessian in one scenario fails that scenario only,
    as the twin says."""
    T, B = 7, 256
    spec, bounds, _ = _problem("cartpole", T, cuda)
    a = _inputs(spec, B, cuda, seed=2)
    a["r1u"][3, 2] = -100.0
    args = [a[k] for k in ("x", "u", "y", "r1x", "r1u", "delta", "q", "r",
                           "c")]
    got = fi.factor_solve_kernel(spec, *args, bounds=bounds)[3]
    want = fi.factor_solve_plain(spec, *args)[3]
    assert torch.equal(got, want)
    assert int((got != 0).sum()) == 1 and int(got[3]) != 0


def test_wrappers_refuse(cuda):
    T = 5
    spec, bounds, _ = _problem("cartpole", T, cuda)
    a = _inputs(spec, 4, cuda)
    ev_args = [a[k] for k in ("x", "u", "y", "x0", "zlx", "zlu", "zux",
                              "zuu")]
    with pytest.raises(TypeError):
        fi.eval_kernel(spec, bounds, ev_args[0].double(), *ev_args[1:])
    with pytest.raises(ValueError):
        fi.eval_kernel(spec, bounds, ev_args[0][:, :-1], *ev_args[1:])
    with pytest.raises(ValueError):
        fi.factor_kernel(spec, a["x"].transpose(0, 1).contiguous()
                         .transpose(0, 1), *[a[k] for k in
                                             ("u", "y", "r1x", "r1u",
                                              "delta")], bounds=bounds)


F32_EPS = float(np.finfo(np.float32).eps)
ITERATE = ("x", "u", "y", "r1x", "r1u", "delta")
EVAL = ("x", "u", "y", "x0", "zlx", "zlu", "zux", "zuu")


def _check_eval(spec, bounds, a, entries, T):
    args = [a[k] for k in EVAL]
    got = fi.eval_kernel(spec, bounds, *args, entries=entries)
    want = fi.eval_reference(spec, bounds, *args)
    _close(got[1:], want[1:], SOLVE_TOL, "eval")
    f_rel = ((got[0] - want[0]).abs() / want[0].abs()).max()
    assert float(f_rel) <= 4 * (T + 1) * F32_EPS


@pytest.mark.parametrize("B", [4096, 1000])
@pytest.mark.parametrize("name", sorted(CASES))
def test_factor_and_eval_at_main_path_shape(cuda, name, B):
    T = 50
    spec, bounds, _ = _problem(name, T, cuda)
    a = _inputs(spec, B, cuda, seed=3)
    it = [a[k] for k in ITERATE]
    fac_t = fi.factor_reference(spec, *it)
    entries = fi._entries(spec, bounds)
    cfg = fi.launch_config(entries, "fused_factor", B)
    assert cfg["grid"] * cfg["block"] >= B
    if B == 4096:
        assert cfg["grid"] >= 132
        assert fi.launch_config(entries, "fused_eval", B)["grid"] >= 132
    fac = fi.factor_kernel(spec, *it, entries=entries)
    _close(fac, fac_t, FACTOR_TOL, "factor")
    _check_eval(spec, bounds, a, entries, T)


@pytest.mark.parametrize("n,m,mode", [(8, 3, "gauss_newton"),
                                      (16, 5, "exact")])
def test_team_factor_at_other_dims(cuda, n, m, mode):
    """The team design where m * m exceeds the team's lanes (8, 3) and
    n + m two columns per lane (16, 5): products and statuses as the
    twins' on a ragged batch."""
    T, B = 50, 1000
    spec_m, _, _, lo, up, _ = models.synthetic_chain(
        horizon=T, state_dim=n, control_dim=m, dtype=torch.float32,
        device=cuda)
    spec = fi.build_fused_iter_spec(spec_m.dynamics, spec_m.node_cost,
                                    spec_m.edge_cost, T, n, m, mode,
                                    torch.float32, cuda)
    bounds = tuple(b[0].cpu().numpy() for b in (lo.u, up.u, lo.x, up.x))
    a = _inputs(spec, B, cuda, seed=6)
    args = [a[k] for k in ITERATE + ("q", "r", "c")]
    entries = fi._entries(spec, bounds)
    _close(fi.factor_kernel(spec, *args[:6], entries=entries),
           fi.factor_reference(spec, *args[:6]), FACTOR_TOL, "factor")
    assert torch.equal(fi.factor_solve_kernel(spec, *args,
                                              entries=entries)[3],
                       fi.factor_solve_plain(spec, *args)[3])


@pytest.mark.parametrize("name", sorted(CASES))
def test_failed_cholesky_stays_in_its_scenario(cuda, name):
    """A terminal Q with a large negative eigenvalue fails F's Cholesky in
    scenario 3 only: its status, and every other scenario's products and
    status as the twin's."""
    T, B = 7, 300
    spec, bounds, _ = _problem(name, T, cuda)
    a = _inputs(spec, B, cuda, seed=4)
    a["r1x"][3, T, 0] = -1e4
    args = [a[k] for k in ITERATE + ("q", "r", "c")]
    fac_t = fi.factor_reference(spec, *args[:6])
    ok = torch.ones(B, dtype=torch.bool, device=cuda)
    ok[3] = False
    entries = fi._entries(spec, bounds)
    got = fi.factor_solve_kernel(spec, *args, entries=entries)[3]
    want = fi.factor_solve_plain(spec, *args)[3]
    assert torch.equal(got, want)
    assert int(got[3]) != 0 and bool((got[ok] == 0).all())
    fac = fi.factor_kernel(spec, *args[:6], entries=entries)
    _close([t[..., ok] for t in fac if t is not None],
           [t[..., ok] for t in fac_t if t is not None], FACTOR_TOL,
           "factor")


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_nan_stays_in_its_scenario(cuda, name):
    T, B = 7, 300
    spec, bounds, _ = _problem(name, T, cuda)
    a = _inputs(spec, B, cuda, seed=5)
    a["x"][5, 3, 1] = float("nan")
    args = [a[k] for k in EVAL]
    got = fi.eval_kernel(spec, bounds, *args)
    want = fi.eval_reference(spec, bounds, *args)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[-1][5, :2]).all())
    ok = torch.ones(B, dtype=torch.bool, device=cuda)
    ok[5] = False
    assert bool(torch.isfinite(got[-1][ok]).all())
    _close([t[ok] for t in got[1:]], [t[ok] for t in want[1:]], SOLVE_TOL,
           "eval")


def test_wrappers_skip_torch_func_terminal_pieces(cuda, monkeypatch):
    """The CUDA wrappers form the terminal node in the kernels: with
    ``_terminal_q`` and every torch.func entry point of ops/fused_iter.py
    made to raise, the solver's entry points still run and agree with the
    twins (computed before)."""
    T, B = 7, 300
    spec, bounds, _ = _problem("cartpole", T, cuda)
    a = _inputs(spec, B, cuda, seed=6)
    step_args = [a[k] for k in ITERATE + ("q", "r", "c")]
    ev_args = [a[k] for k in EVAL]
    want_step = fi.factor_solve_plain(spec, *step_args)
    want_ev = fi.eval_reference(spec, bounds, *ev_args)
    step = fi.make_fused_factor_solve(spec, bounds)
    evaluate = fi.make_fused_eval(spec, bounds)

    def refuse(*args, **kwargs):
        raise AssertionError("torch.func terminal piece reached")

    for name in ("_terminal_q", "grad", "hessian", "jacfwd", "jvp", "vmap"):
        monkeypatch.setattr(fi, name, refuse)
    got_step = step(*step_args)
    got_ev = evaluate(*ev_args)
    torch.cuda.synchronize()
    assert torch.equal(got_step[3], want_step[3])
    _close(got_step[:3], want_step[:3], SOLVE_TOL, "step")
    _close(got_ev[1:], want_ev[1:], SOLVE_TOL, "eval")
    with pytest.raises(AssertionError, match="terminal piece"):
        fi.factor_reference(spec, *step_args[:6])
