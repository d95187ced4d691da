"""Solver settings and statuses.

PyTorch port of ``sip_optimal_control_tpu/solver/settings.py``: the same
fields with the same defaults, minus ``matmul_precision`` (float32 matrix
products on the GPU run in full float32 as long as TF32 stays off, which is
PyTorch's default for matmuls).

The reference's sip::Settings is only visible through its call sites
(reference: tests/variable_dimensions_test.cpp:18-25, 428-432:
max_iterations, line_search.use_filter_line_search, logging.print_*); the
solver itself is external, so this is a from-scratch design: a slack-based,
dual-regularized (proximal) barrier interior-point method whose Newton-KKT
matrix is exactly the operator of ops/kkt.py:

    K = [[H + r1, C^T, G^T], [C, -r2, 0], [G, 0, -(w + r3)]],  w = s/z.
"""

from __future__ import annotations

import dataclasses
import enum

RICCATI_BACKENDS = ("scan", "cuda")


class SIPStatus(enum.IntEnum):
    SOLVED = 0
    MAX_ITERATIONS = 1
    FACTORIZATION_FAILURE = 2
    # KKT error exceeded Settings.diverged_kkt: the iterates are running
    # away, typically an infeasible problem (equality multipliers blow up
    # while primal steps collapse)
    DIVERGED = 3
    # Settings.max_consecutive_rejections successive steps were rejected
    # (failed factorization or exhausted line search even under inflated
    # regularization): the iterate cannot make progress from its current
    # point — callers should re-initialize rather than re-warm-start
    STALLED = 4
    # internal sentinel while iterating
    RUNNING = 99


@dataclasses.dataclass(frozen=True)
class LineSearchSettings:
    # Merit (Armijo on the nu-penalized barrier merit) by default; the
    # filter option mirrors the reference's
    # line_search.use_filter_line_search flag
    # (reference: tests/variable_dimensions_test.cpp:21-22).
    use_filter_line_search: bool = False
    # Backtracking depth cap.  The batched search runs every trip for all
    # scenarios, so depth bounds the per-iteration probe cost; an exhausted
    # search rejects the step and inflates the carried regularization
    # instead (Settings.reg_boost_*).
    max_steps: int = 10
    backtrack: float = 0.5
    # Candidate alphas evaluated per line-search trip (one widened probe
    # over a chunk axis instead of `chunk` sequential probes).  The
    # accepted alpha is identical to the sequential search (the largest
    # in-budget candidate passing the test).  chunk = max_steps makes the
    # whole search one probe (the MPC main path's setting).
    chunk: int = 1
    # Fused line-search probe kernel (the JAX package's ops/pallas_ls.py).
    # Not ported yet: True raises instead of silently using the standard
    # probe.
    fused_probe: bool = False
    eta: float = 1e-6          # Armijo slope fraction
    nu_min: float = 1.0        # merit penalty floor
    nu_rho: float = 0.1        # penalty margin: nu >= D/((1-rho) theta)
    # filter parameters (Waechter-Biegler style margins)
    gamma_theta: float = 1e-5
    gamma_phi: float = 1e-5

    def __post_init__(self):
        if self.fused_probe:
            raise NotImplementedError(
                "fused_probe: the fused line-search probe kernel is not "
                "ported to this package yet; use fused_probe=False")


@dataclasses.dataclass(frozen=True)
class LoggingSettings:
    print_logs: bool = False
    print_line_search_logs: bool = False
    print_search_direction_logs: bool = False
    print_derivative_check_logs: bool = False


@dataclasses.dataclass(frozen=True)
class Settings:
    max_iterations: int = 60
    tol: float = 1e-8
    # Fixed-trip (real-time-iteration) outer loop: run EXACTLY
    # max_iterations trips with no convergence test between trips and no
    # host synchronisation.  A scenario's state freezes once its status
    # leaves RUNNING, so per-scenario results equal the convergence-tested
    # loop whenever the scenario terminates within the budget.  Intended
    # for warm-started MPC re-solves with small max_iterations; truncated
    # scenarios report MAX_ITERATIONS and carry their warm state to the
    # next re-solve (the classic RTI contract).
    fixed_iterations: bool = False
    # barrier schedule (monotone Fiacco-McCormick)
    mu_init: float = 1e-1
    mu_min: float = 1e-13
    kappa_mu: float = 0.2      # linear decrease factor
    theta_mu: float = 1.5      # superlinear decrease power
    kappa_eps: float = 10.0    # barrier subproblem tolerance = kappa_eps*mu
    tau_min: float = 0.99      # fraction-to-boundary floor
    # regularization: r2 = r3 = gamma_reg*mu + reg_floor (dual prox);
    # r1 = prox_reg + bound weights (primal prox).
    gamma_reg: float = 1e-6
    reg_floor: float = 1e-8
    prox_reg: float = 1e-8
    max_factor_retries: int = 3
    retry_scale: float = 100.0
    # Step-rejection safeguard (Levenberg-style): when the factorization
    # still fails after the in-iteration retries, or the line search
    # exhausts its backtracking budget, the step is REJECTED (alpha = 0)
    # and a carried multiplier on the primal proximal regularization is
    # inflated for the next iteration; it decays back toward 1 after
    # accepted steps.  FACTORIZATION_FAILURE is only declared once the
    # boost is saturated at reg_boost_max.
    reg_boost_scale: float = 100.0
    reg_boost_decay: float = 0.1
    reg_boost_max: float = 1e12
    # consecutive rejected steps before declaring STALLED
    max_consecutive_rejections: int = 8
    # safeguards
    diverged_kkt: float = 1e10  # declare DIVERGED above this KKT error
    kappa_sigma: float = 1e10  # z-reset corridor around mu/s
    bound_push: float = 1e-2   # initial interior push for bounded variables
    # Interior push applied to EXPLICIT warm starts (solve(init_vars=...)),
    # kept tiny so a saturated control is not dragged off its bound every
    # MPC re-solve; cold starts keep the standard kappa_1-style push.
    warm_bound_push: float = 1e-6
    # Absolute slack floor.  0 disables.
    slack_min: float = 0.0
    # After every accepted iterate, report scenarios whose iterate, model
    # evaluation or KKT error is non-finite.  Debug only: the check reads
    # values on the host every iteration.
    debug_check_finite: bool = False
    # extra rounds of K-residual correction per Newton solve, using the
    # apply_K operator (reference: helpers.cpp:953-977)
    iterative_refinement_steps: int = 0
    # Chain-Riccati backend: "scan" (plain PyTorch recursion over the
    # horizon) or "cuda" (the hand-written Hopper kernels of
    # ops/riccati_cuda.py; CPU tensors take their plain twins).
    riccati_backend: str = "scan"
    # Whole-iteration fusion (the JAX package's ops/fused_iter.py).  Not
    # ported yet: True raises instead of silently running the standard
    # iteration.
    fused_iteration: bool = False
    # Fixed-trip mode only: include the carried model evaluation in the
    # per-trip freeze-select (the default, exactly equal to the
    # convergence-tested loop).  False lets the carried evaluation of a
    # frozen scenario keep advancing, so SolveResult.f on such a scenario
    # reports a post-freeze iterate's objective.
    rti_freeze_ev: bool = True
    line_search: LineSearchSettings = LineSearchSettings()
    logging: LoggingSettings = LoggingSettings()

    def __post_init__(self):
        if self.riccati_backend == "pallas":
            raise ValueError(
                "riccati_backend='pallas' names the TPU kernels; this "
                "package's kernel backend is 'cuda'")
        if self.riccati_backend not in RICCATI_BACKENDS:
            raise ValueError(
                f"unknown riccati_backend {self.riccati_backend!r}; "
                f"expected one of {RICCATI_BACKENDS}")
        if self.fused_iteration:
            raise NotImplementedError(
                "fused_iteration: the whole-iteration fused kernels are not "
                "ported to this package yet; use fused_iteration=False")
