"""SIP-style interior-point solver for stagewise NLPs, batched over scenarios.

PyTorch port of ``sip_optimal_control_tpu/solver/sip.py`` (the standard
iteration, ``_solve_impl``).  The reference delegates the outer loop to
the external `@sip//sip` library, visible only through its callback
interface (reference: sip_optimal_control.cpp:182-208); this module
implements that solver for a batch of independent scenarios: every tensor
leads with the scenario axis, every scalar of the JAX solver is a [B]
tensor, and the per-scenario control flow of a vmapped
``lax.while_loop`` becomes per-lane masks and selects.

``solve(coupled=True)`` (JAX's ``coupled_axes``) makes the batch ONE joint
NLP whose scenarios share θ: every scalar coupling (merit, residual norms,
step limits, θ stationarity) is a sum, max or min over the batch axis,
broadcast back to every scenario, and the θ Schur system is summed over
the batch and solved once (ops/kkt.py).  ``solve(coupled=mesh)`` with a
``ScenarioMesh`` makes every rank's rows of the batch that one NLP: the
same reductions run over the local rows and then over the mesh's process
group.

Method: slack-based primal-dual barrier with proximal (dual) regularization
(cf. PAPERS.md: "Dual-Regularized Riccati Recursions for Interior-Point
Optimal Control", arXiv 2509.16370):

  minimize f(v)  s.t.  c(v) = 0,  g(v) + s = 0,  s >= 0,  lb <= v <= ub,

with v = (x nodes, u edges, theta).  Each iteration solves

  [[H + r1, C^T, G^T], [C, -r2, 0], [G, 0, -(w + r3)]] (dv, dy, dz) = b,

with w = s / z, r1 = prox + bound-barrier diagonal zl/(v-lb) + zu/(ub-v),
r2 = r3 = O(mu) dual proximal regularization.  Steps are globalized by a
fraction-to-boundary rule plus an Armijo or filter line search on the
barrier merit; mu follows a monotone Fiacco-McCormick schedule.

In fixed-trip mode (``Settings.fixed_iterations``) the iteration body reads
nothing back to the host: no ``.item()``, no tensor in a Python condition,
so a trip is a fixed sequence of device work.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .._mesh import ScenarioMesh, local_mesh
from .._tree import lane_view, tree_leaves, tree_map, tree_select
from ..ops.kkt import (ConstraintMasks, KKTVector, Regularizations,
                       StageModelData, apply_C, apply_CT, apply_G, apply_GT,
                       apply_H, apply_K, kkt_factor, kkt_solve,
                       zero_kkt_vector)
from ..ops.ls_probe import make_fused_probe
from ..types import Dimensions, TopologySchedule
from .settings import Settings, SIPStatus

_EPS = 1e-300


# ---------------------------------------------------------------------------
# variable containers (scenario batch leading)
# ---------------------------------------------------------------------------

class Primal(NamedTuple):
    """Primal variables: node states, edge controls, global theta."""

    x: torch.Tensor      # [B, N, n]
    u: torch.Tensor      # [B, E, m]
    theta: torch.Tensor  # [B, p]


class YVec(NamedTuple):
    """Equality (y) space: root+dynamics rows per node, node-c, edge-c rows
    (flat layout equivalent, reference: types.cpp:43-53)."""

    dyn: torch.Tensor    # [B, N, n]
    nc: torch.Tensor     # [B, N, cn]
    ec: torch.Tensor     # [B, E, ce]


class ZVec(NamedTuple):
    """Inequality (z) space (reference layout: types.cpp:55-63)."""

    n: torch.Tensor      # [B, N, gn]
    e: torch.Tensor      # [B, E, ge]


class ModelEval(NamedTuple):
    """Everything the IPM needs at the current iterate: objective [B],
    gradient, stacked residuals and derivative/Hessian stage data
    (reference: sip_optimal_control.cpp:13-127).  The Hessian blocks in
    `stage` are Lagrangian Hessians at the given (y, z)."""

    f: torch.Tensor
    grad: Primal
    c: YVec           # assembled equality residuals (root row included)
    g: ZVec
    stage: StageModelData


@dataclasses.dataclass(frozen=True)
class OCProblem:
    """A batch of trajectory-optimization problem instances (static part).

    The equivalent of the reference's Input (reference: types.hpp:128-151)
    with torch callables instead of C callbacks.  `eval_model` is the full
    derivative evaluation; `eval_fcg` is the cheap residual-only evaluation
    used by line-search probes (the reference's `new_x=false` path) and
    accepts extra leading axes.  `masks` hold tensors on the problem's
    device; `lower`/`upper` are shared by all scenarios."""

    dims: Dimensions
    sched: TopologySchedule
    masks: ConstraintMasks
    eval_model: Callable[[Primal, YVec, ZVec], ModelEval]
    eval_fcg: Callable[[Primal], tuple]      # -> (f, c: YVec, g: ZVec)
    lower: Primal                            # -inf where unbounded
    upper: Primal                            # +inf where unbounded
    # Residual scalings: a scalar float OR a per-element container
    # (reference: ResidualScaling, types.hpp:144-148).
    scale_dual: object = 1.0
    scale_equality: object = 1.0
    scale_bound: object = 1.0
    # default primal initialization when solve() gets no warm start
    default_init: Optional[Primal] = None
    # Fused line-search and whole-iteration payloads (spec, stage-constant
    # bounds, initial state [B, n]) set by build_problem for eligible
    # chains (ops/ls_probe.py, ops/fused_iter.py).
    fused_ls: Optional[tuple] = None
    fused_iter: Optional[tuple] = None


class SolveResult(NamedTuple):
    vars: Primal
    s: ZVec
    y: YVec
    z: ZVec
    zl: Primal
    zu: Primal
    f: torch.Tensor
    status: torch.Tensor         # [B] int32 SIPStatus
    iterations: torch.Tensor     # [B] int32
    kkt_error: torch.Tensor      # [B]
    mu: torch.Tensor             # [B]


class _IPMState(NamedTuple):
    vars: Primal
    s: ZVec
    y: YVec
    z: ZVec
    zl: Primal
    zu: Primal
    mu: torch.Tensor
    nu: torch.Tensor
    it: torch.Tensor
    status: torch.Tensor
    kkt_error: torch.Tensor
    # Levenberg-style multiplier on the primal proximal regularization
    # (settings.reg_boost_*)
    reg_boost: torch.Tensor
    # consecutive rejected steps (drives the STALLED status)
    consec_rej: torch.Tensor
    # model evaluation AT the current iterate, so the body tests
    # convergence at the end of each step
    ev: ModelEval
    # filter line-search memory: (theta, phi) pairs, one slot per iteration
    filt_th: torch.Tensor
    filt_ph: torch.Tensor


# ---------------------------------------------------------------------------
# per-scenario reductions: every tensor leads with `lead` batch axes
# ---------------------------------------------------------------------------

def _lane_reduce(t: torch.Tensor, lead: int, op, empty: float):
    if t.dim() == lead:
        return t
    flat = t.flatten(lead)
    if flat.shape[-1] == 0:
        return flat.new_full(flat.shape[:-1], empty)
    return op(flat)


def _lsum(t, lead=1):
    return _lane_reduce(t, lead, lambda a: a.sum(-1), 0.0)


def _lmax(t, lead=1):
    return _lane_reduce(t, lead, lambda a: a.amax(-1), -math.inf)


def _lmin(t, lead=1):
    return _lane_reduce(t, lead, lambda a: a.amin(-1), math.inf)


def _tsum(tree, lead=1) -> torch.Tensor:
    return sum(_lsum(leaf, lead) for leaf in tree_leaves(tree))


def _tinf(tree, lead=1) -> torch.Tensor:
    """Per-scenario max-abs over every leaf (0 when all are empty)."""
    out = None
    for leaf in tree_leaves(tree):
        v = torch.clamp(_lmax(leaf.abs(), lead), min=0.0)
        out = v if out is None else torch.maximum(out, v)
    return out


def _tdot(a, b, lead=1) -> torch.Tensor:
    return sum(_lsum(x * y, lead)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _kkt_from_duals(template: KKTVector, y: YVec, z: ZVec) -> KKTVector:
    return dataclasses.replace(template, y_dyn=y.dyn, y_nc=y.nc, y_ec=y.ec,
                               z_n=z.n, z_e=z.e)


def _primal_of(v: KKTVector) -> Primal:
    return Primal(x=v.x, u=v.u, theta=v.theta)


def _y_of(v: KKTVector) -> YVec:
    return YVec(dyn=v.y_dyn, nc=v.y_nc, ec=v.y_ec)


def _z_of(v: KKTVector) -> ZVec:
    return ZVec(n=v.z_n, e=v.z_e)


def _lagrangian_grad(ev: ModelEval, duals: KKTVector,
                     sched: TopologySchedule) -> Primal:
    """grad f + C^T y + G^T z at fixed multipliers ``duals``."""
    ct = apply_CT(ev.stage, duals, sched)
    gt = apply_GT(ev.stage, duals, sched)
    return Primal(x=ev.grad.x + ct.x + gt.x, u=ev.grad.u + ct.u + gt.u,
                  theta=ev.grad.theta + ct.theta + gt.theta)


def _fd_errors(problem: OCProblem, vars0: Primal, y: YVec, z: ZVec,
               ev: ModelEval, template: KKTVector, d: Primal, eps: float):
    """The finite-difference errors along direction ``d``, each [B]: the
    gradient, the C and G Jacobian operators and the Lagrangian Hessian
    (at fixed multipliers) against central differences of the
    residual-only evaluation and of the Lagrangian gradient (JAX
    sip.py:275-317, utils/derivative_check.py:78-103)."""
    sched = problem.sched
    duals = _kkt_from_duals(template, y, z)
    vp = tree_map(lambda a, b_: a + eps * b_, vars0, d)
    vm = tree_map(lambda a, b_: a - eps * b_, vars0, d)
    fp, cp, gp = problem.eval_fcg(vp)
    fm, cm, gm = problem.eval_fcg(vm)

    def fd(plus, minus):
        return tree_map(lambda a, b_: (a - b_) / (2 * eps), plus, minus)

    dk = dataclasses.replace(template, x=d.x, u=d.u, theta=d.theta)
    cd, fd_c = apply_C(ev.stage, dk, sched), fd(cp, cm)
    gd, fd_g = apply_G(ev.stage, dk, sched), fd(gp, gm)
    hd = apply_H(ev.stage, dk, sched)
    fd_h = fd(_lagrangian_grad(problem.eval_model(vp, y, z), duals, sched),
              _lagrangian_grad(problem.eval_model(vm, y, z), duals, sched))
    return ((_tdot(ev.grad, d) - (fp - fm) / (2 * eps)).abs(),
            _tinf(YVec(dyn=cd.y_dyn - fd_c.dyn, nc=cd.y_nc - fd_c.nc,
                       ec=cd.y_ec - fd_c.ec)),
            _tinf(ZVec(n=gd.z_n - fd_g.n, e=gd.z_e - fd_g.e)),
            _tinf(Primal(x=hd.x - fd_h.x, u=hd.u - fd_h.u,
                         theta=hd.theta - fd_h.theta)))


def _print_derivative_check(problem: OCProblem, vars0: Primal, y: YVec,
                            z: ZVec, ev: ModelEval, template: KKTVector,
                            num_directions: int = 2) -> None:
    """Finite-difference derivative check at the initial iterate, printed
    when settings.logging.print_derivative_check_logs is set (JAX
    sip.py:249-322; the reference's SIP core has the same channel,
    reference: tests/variable_dimensions_test.cpp:432).

    Central differences along fixed random directions (``_fd_errors``).
    The directions are JAX's: ``np.random.default_rng(0)`` drawn in its
    order at one scenario's shapes, the same direction for every
    scenario.  JAX under vmap prints one line per scenario; this prints
    ONE line per solve, each channel's maximum over the batch, in JAX's
    format (a batch of one prints what JAX prints, up to roundoff).
    Expected magnitudes: ~eps^(2/3) of the problem scale for exact
    autodiff models; ``hessian`` is only meaningful in
    hessian_mode="exact"."""
    dtype, device = template.x.dtype, template.x.device
    eps = float(torch.finfo(dtype).eps) ** (1.0 / 3.0)
    rng = np.random.default_rng(0)

    def draw(t):
        d = torch.as_tensor(rng.standard_normal(t.shape[1:]), dtype=dtype,
                            device=device)
        return d.expand(t.shape)

    errs = [0.0] * 4
    for _ in range(num_directions):
        d = Primal(x=draw(template.x), u=draw(template.u),
                   theta=draw(template.theta))
        errs = [max(a, float(b_.max())) for a, b_ in zip(
            errs, _fd_errors(problem, vars0, y, z, ev, template, d, eps))]
    g, c, gq, h = errs
    print(f"derivative check (central FD, eps={eps:.2e}): gradient={g:.3e} "
          f"jacobian_c={c:.3e} jacobian_g={gq:.3e} hessian={h:.3e}",
          flush=True)


def solve(problem: OCProblem, settings: Settings,
          init_vars: Optional[Primal] = None,
          init_y: Optional[YVec] = None,
          init_z: Optional[ZVec] = None,
          init_zl: Optional[Primal] = None,
          init_zu: Optional[Primal] = None,
          coupled=False) -> SolveResult:
    """Run the interior-point solve for every scenario of the batch.

    Warm starting: pass `init_vars` / `init_y` (and optionally the
    inequality multipliers `init_z` and bound duals `init_zl`/`init_zu`)
    from a previous SolveResult (reference:
    tests/variable_dimensions_test.cpp:437-446).  Warm `init_z` is floored
    at mu_init complementarity (z >= mu/s); warm bound duals are projected
    into the IPOPT-style kappa_sigma box [mu/(kappa d), kappa mu/d].

    ``coupled``: True makes all B scenarios one joint problem sharing θ
    (JAX sip.py:325-442); the result's θ is identical on every scenario and
    its status, iterations and KKT error are the joint problem's.  A
    ``ScenarioMesh`` (``parallel.scenario_mesh``) makes the batch this
    rank's rows of one joint problem over every rank of the mesh (JAX's
    ``coupled_axes`` over a mesh axis): every rank must call ``solve``
    alike, and each gets its own rows with the joint θ, status and
    iterations.  Requires unbounded θ (θ bounds would add lane-replicated
    barrier terms)."""
    if settings.fixed_iterations and settings.max_iterations < 1:
        raise ValueError(
            "fixed_iterations requires max_iterations >= 1 (a 0-trip loop "
            "would diverge from the convergence-tested semantics)")
    if settings.fused_iteration:
        from .fused_chain import _eligible, solve_fused
        if _eligible(problem, settings, coupled):
            return solve_fused(problem, settings, init_vars, init_y, init_z,
                               init_zl, init_zu)
    return _solve_impl(problem, settings, init_vars, init_y, init_z, init_zl,
                       init_zu, coupled)


def _batch_reductions(mesh: Optional[ScenarioMesh]):
    """(gsum, gmax, gmin) over the batch axis ``dim`` and the mesh's ranks,
    broadcast back to every scenario: JAX's psum / pmax / pmin over the
    coupled axes.  The identity when the scenarios are independent
    (``mesh`` None)."""
    if mesh is None:
        def ident(v, dim=0):
            return v
        return ident, ident, ident
    return mesh.sum, mesh.max, mesh.min


def _solve_impl(problem: OCProblem, settings: Settings, init_vars, init_y,
                init_z, init_zl, init_zu, coupled=False) -> SolveResult:
    dims = problem.dims
    masks = problem.masks
    sched = problem.sched
    ls = settings.line_search
    # the Riccati kernels factor chains; trees run the level recursion of
    # ops/lqr.py (JAX sip.py:691-692)
    backend = (settings.riccati_backend if sched.topology.is_chain
               else "scan")
    lower, upper = problem.lower, problem.upper

    # ----- initialization --------------------------------------------------
    # explicit warm starts get only a tiny interior push so saturated
    # variables stay (numerically) at their bounds across MPC re-solves;
    # cold starts keep the standard kappa_1-style push
    push_eps = (settings.warm_bound_push if init_vars is not None
                else settings.bound_push)
    if init_vars is None:
        init_vars = problem.default_init
    dtype, device = init_vars.x.dtype, init_vars.x.device
    batch = init_vars.x.shape[0]
    template = zero_kkt_vector(dims, batch, dtype, device)
    zmask = ZVec(n=masks.ng, e=masks.eg)
    pmask = Primal(x=masks.state.to(dtype), u=masks.control.to(dtype),
                   theta=torch.ones(dims.theta_dim, dtype=dtype,
                                    device=device))
    has_lb = tree_map(torch.isfinite, lower)
    has_ub = tree_map(torch.isfinite, upper)

    # ----- coupled (shared-θ) reductions (JAX sip.py:401-442) --------------
    # every scenario is one part of a single joint NLP: scalar couplings
    # reduce over the batch (and the mesh's ranks), and lane-replicated θ
    # terms (its prox regularization) count once, on scenario 0 of rank 0
    # (th_once, JAX's rep0)
    mesh = (coupled if isinstance(coupled, ScenarioMesh)
            else local_mesh(device) if coupled else None)
    coupled = mesh is not None
    gsum, gmax, gmin = _batch_reductions(mesh)
    theta_sum = mesh.sum if coupled else None
    th_once = 1.0
    if coupled:
        if bool(has_lb.theta.any() | has_ub.theta.any()):
            raise ValueError(
                "coupled solves require unbounded theta (theta box bounds "
                "would add lane-replicated barrier terms)")
        th_once = torch.zeros(batch, 1, dtype=dtype, device=device)
        if mesh.rank == 0:
            th_once[0] = 1.0

    # Fused line-search probe (ops/ls_probe.py, a chain's or a tree's):
    # engaged when the problem is eligible (build_problem sets fused_ls)
    # and float32, the regime of the kernels (JAX sip.py:522-531)
    fused_probe_fn = fused_x0 = None
    if (ls.fused_probe and problem.fused_ls is not None and not coupled
            and dtype == torch.float32):
        fspec, fbounds, fused_x0 = problem.fused_ls
        fused_probe_fn = make_fused_probe(fspec, fbounds)
        # the kernel reads [B, n] rows in place (a vmapped plant model can
        # hand back a transposed layout)
        fused_x0 = fused_x0.contiguous()

    def lanes(fill, dt=dtype):
        return torch.full((batch,), fill, dtype=dt, device=device)

    def dist_l(vars):
        return tree_map(lambda v, lb, h: torch.where(h, v - lb, 1.0),
                        vars, lower, has_lb)

    def dist_u(vars):
        return tree_map(lambda v, ub, h: torch.where(h, ub - v, 1.0),
                        vars, upper, has_ub)

    def push(v, lb, ub, hl, hu):
        # push strictly inside the bounds (cf. IPOPT's kappa_1 push)
        lo = torch.where(hl, lb + push_eps * torch.clamp(lb.abs(), min=1.0),
                         -math.inf)
        hi = torch.where(hu, ub - push_eps * torch.clamp(ub.abs(), min=1.0),
                         math.inf)
        mid = torch.where(hl & hu, 0.5 * (lb + ub), 0.0)
        return torch.where(lo <= hi, torch.clamp(v, lo, hi), mid)

    vars0 = tree_map(push, init_vars, lower, upper, has_lb, has_ub)
    vars0 = tree_map(lambda v, m: v * m, vars0, pmask)

    _, _, g0 = problem.eval_fcg(vars0)
    mu0 = lanes(settings.mu_init)
    s0 = tree_map(lambda g, m: torch.where(
        m, torch.clamp(-g, min=settings.mu_init), 1.0), g0, zmask)
    if init_z is not None:
        # carried inequality multipliers, floored at mu/s complementarity
        z0 = tree_map(lambda zw, s, m: torch.where(
            m, torch.maximum(zw, lane_view(mu0, s) / torch.clamp(s, min=_EPS)),
            1.0), init_z, s0, zmask)
    else:
        z0 = tree_map(lambda s, m: torch.where(
            m, lane_view(mu0, s) / s, 1.0), s0, zmask)
    y0 = init_y if init_y is not None else YVec(
        dyn=torch.zeros_like(template.y_dyn),
        nc=torch.zeros_like(template.y_nc),
        ec=torch.zeros_like(template.y_ec))
    kappa_s = settings.kappa_sigma

    def bound_dual_init(warm, dists, has):
        if warm is None:
            return tree_map(lambda d, h: torch.where(
                h, lane_view(mu0, d) / d, 0.0), dists, has)

        def proj(zw, d, h):
            mu_l = lane_view(mu0, d)
            dd = torch.clamp(d, min=_EPS)
            return torch.where(h, torch.clamp(zw, mu_l / (kappa_s * dd),
                                              kappa_s * mu_l / dd), 0.0)
        return tree_map(proj, warm, dists, has)

    zl0 = bound_dual_init(init_zl, dist_l(vars0), has_lb)
    zu0 = bound_dual_init(init_zu, dist_u(vars0), has_ub)

    # ----- residuals and errors -------------------------------------------
    def _is_scalar_scale(s_):
        return isinstance(s_, (int, float)) or (
            isinstance(s_, torch.Tensor) and s_.dim() == 0)

    def scaled_inf(tree, scale):
        if _is_scalar_scale(scale):
            return scale * _tinf(tree)
        return _tinf(tree_map(lambda a, s_: a * s_, tree, scale))

    def kkt_residuals(vars, s, y, z, zl, zu, ev: ModelEval):
        duals = _kkt_from_duals(template, y, z)
        ct = apply_CT(ev.stage, duals, sched)
        gt = apply_GT(ev.stage, duals, sched)
        stat = tree_map(lambda g_, a, b_, l, u_, m: (g_ + a + b_ + u_ - l) * m,
                        ev.grad, _primal_of(ct), _primal_of(gt), zl, zu,
                        pmask)
        if coupled:
            # joint θ stationarity: the sum of the scenarios' contributions
            # (θ is unbounded, so its zl/zu rows are zero)
            stat = stat._replace(theta=gsum(stat.theta))
        r_ineq = tree_map(lambda g, sv, m: torch.where(m, g + sv, 0.0), ev.g,
                          s, zmask)
        sb = problem.scale_bound
        sb_scalar = _is_scalar_scale(sb)

        # complementarity at barrier parameter value `m_mu` (0 or [B])
        def comp(m_mu):
            cs = tree_map(lambda sv, zv, m: torch.where(
                m, sv * zv - lane_view(m_mu, sv), 0.0), s, z, zmask)
            cl = tree_map(lambda d, l, h: torch.where(
                h, d * l - lane_view(m_mu, d), 0.0), dist_l(vars), zl,
                has_lb)
            cu = tree_map(lambda d, u_, h: torch.where(
                h, d * u_ - lane_view(m_mu, d), 0.0), dist_u(vars), zu,
                has_ub)
            cs_err = (sb * _tinf(cs)) if sb_scalar else _tinf(cs)
            return torch.maximum(cs_err, torch.maximum(scaled_inf(cl, sb),
                                                       scaled_inf(cu, sb)))

        def err(m_mu):
            return gmax(torch.amax(torch.stack([
                scaled_inf(stat, problem.scale_dual),
                scaled_inf(ev.c, problem.scale_equality),
                _tinf(r_ineq),
                comp(m_mu)]), dim=0))

        return stat, r_ineq, err

    ev0 = problem.eval_model(vars0, y0, z0)
    if settings.logging.print_derivative_check_logs:
        # the reference's derivative-check channel (JAX sip.py:586-589);
        # fused_chain._eligible sends a solve with it on to this loop
        _print_derivative_check(problem, vars0, y0, z0, ev0, template)
    _, _, err0_fn = kkt_residuals(vars0, s0, y0, z0, zl0, zu0, ev0)
    e0_init = err0_fn(0.0)
    status_init = torch.where(
        e0_init <= settings.tol, int(SIPStatus.SOLVED),
        torch.where(~torch.isfinite(e0_init)
                    | (e0_init > settings.diverged_kkt),
                    int(SIPStatus.DIVERGED),
                    int(SIPStatus.RUNNING))).to(torch.int32)
    K_it = settings.max_iterations
    state = _IPMState(
        vars=vars0, s=s0, y=y0, z=z0, zl=zl0, zu=zu0, mu=mu0,
        nu=lanes(ls.nu_min), it=lanes(0, torch.int32), status=status_init,
        kkt_error=e0_init, reg_boost=lanes(1.0),
        consec_rej=lanes(0, torch.int32), ev=ev0,
        filt_th=torch.full((batch, K_it), math.inf, dtype=dtype,
                           device=device),
        filt_ph=torch.full((batch, K_it), math.inf, dtype=dtype,
                           device=device))
    if settings.debug_check_finite:
        _report_nonfinite("initial iterate", state)

    # ----- merit function --------------------------------------------------
    def barrier_value(vars, s, f, c, g, mu, nu):
        lead = f.dim()
        log_s = _tsum(tree_map(
            lambda sv, m: torch.where(m, torch.log(torch.clamp(sv, min=_EPS)),
                                      0.0), s, zmask), lead)
        log_b = _tsum(tree_map(
            lambda d, h: torch.where(h, torch.log(torch.clamp(d, min=_EPS)),
                                     0.0), dist_l(vars), has_lb), lead) \
            + _tsum(tree_map(
                lambda d, h: torch.where(
                    h, torch.log(torch.clamp(d, min=_EPS)), 0.0),
                dist_u(vars), has_ub), lead)
        theta = _tsum(tree_map(torch.abs, c), lead) + _tsum(tree_map(
            lambda gv, sv, m: torch.where(m, torch.abs(gv + sv), 0.0), g, s,
            zmask), lead)
        base = f - mu * (log_s + log_b)
        # coupled: the joint merit sums every scenario (the batch axis is
        # the last leading axis)
        base, theta = gsum(base, lead - 1), gsum(theta, lead - 1)
        return base + nu * theta, theta

    def step_along(v, d, alpha):
        return v + lane_view(alpha, v) * d

    # ----- one IPM iteration ----------------------------------------------
    def body(st: _IPMState) -> _IPMState:
        vars, s, y, z, zl, zu, mu = (st.vars, st.s, st.y, st.z, st.zl,
                                     st.zu, st.mu)
        ev = st.ev
        stat, r_ineq, err_fn = kkt_residuals(vars, s, y, z, zl, zu, ev)

        # barrier update
        e_mu = err_fn(mu)
        shrink = e_mu <= settings.kappa_eps * mu
        mu = torch.where(
            shrink,
            torch.clamp(torch.minimum(settings.kappa_mu * mu,
                                      mu ** settings.theta_mu),
                        min=settings.mu_min),
            mu)

        def lv(v, like):
            return lane_view(v, like)

        dl, du = dist_l(vars), dist_u(vars)
        # regularizations: w = s/z; bounds fold into r1
        # (reference channels: factor(w, r1, r2, r3), helpers.cpp:242)
        reg_d = settings.gamma_reg * mu + settings.reg_floor
        bound_diag = tree_map(
            lambda d1, l, h1, d2, u_, h2: torch.where(h1, l / d1, 0.0)
            + torch.where(h2, u_ / d2, 0.0),
            dl, zl, has_lb, du, zu, has_ub)
        r1 = tree_map(lambda b_, m: (settings.prox_reg * lv(st.reg_boost, b_)
                                     + b_) * m, bound_diag, pmask)
        if coupled:
            # the shared θ's prox regularization is ONE term of the joint
            # system: count it on scenario 0 only (kkt_factor sums it)
            r1 = r1._replace(theta=r1.theta * th_once)
        w = tree_map(lambda sv, zv, m: torch.where(m, sv / zv, 1.0), s, z,
                     zmask)

        def reg_rows(t):
            return torch.ones_like(t) * lv(reg_d, t)

        regs = Regularizations(
            w_n=w.n, w_e=w.e, r1_x=r1.x, r1_u=r1.u, r1_th=r1.theta,
            r2_dyn=reg_rows(template.y_dyn), r2_nc=reg_rows(template.y_nc),
            r2_ec=reg_rows(template.y_ec), r3_n=reg_rows(template.z_n),
            r3_e=reg_rows(template.z_e))

        # Newton RHS: primal row uses the primal-barrier bound gradient
        duals = _kkt_from_duals(template, y, z)
        ct = apply_CT(ev.stage, duals, sched)
        gt = apply_GT(ev.stage, duals, sched)
        bound_grad = tree_map(
            lambda d1, h1, d2, h2: -torch.where(h1, lv(mu, d1) / d1, 0.0)
            + torch.where(h2, lv(mu, d2) / d2, 0.0), dl, has_lb, du, has_ub)
        b_x = tree_map(lambda g_, a, b_, bg, m: -(g_ + a + b_ + bg) * m,
                       ev.grad, _primal_of(ct), _primal_of(gt), bound_grad,
                       pmask)
        b_z = tree_map(lambda gv, zv, m: torch.where(
            m, -gv - lv(mu, zv) / zv, 0.0), ev.g, z, zmask)
        b = KKTVector(x=b_x.x, u=b_x.u, theta=b_x.theta, y_dyn=-ev.c.dyn,
                      y_nc=-ev.c.nc, y_ec=-ev.c.ec, z_n=b_z.n, z_e=b_z.e)

        # factor with bounded proximal-inflation retries: each retry
        # refactors every scenario and keeps the result where the previous
        # attempt failed (the vmapped while_loop's per-lane semantics)
        def gfactor(regs_):
            # coupled: the joint factorization fails when any scenario's
            # does (they share one Newton system)
            f_ = kkt_factor(ev.stage, regs_, masks, sched, backend,
                            theta_sum)
            return f_._replace(status=gmax(f_.status)) if coupled else f_

        regs_f = regs
        fact = gfactor(regs_f)
        for _ in range(settings.max_factor_retries):
            failed = fact.status != 0
            rs = settings.retry_scale
            regs_n = dataclasses.replace(
                regs_f,
                r1_x=regs_f.r1_x * rs + rs * settings.prox_reg * pmask.x,
                r1_u=regs_f.r1_u * rs + rs * settings.prox_reg * pmask.u,
                r1_th=regs_f.r1_th * rs
                + rs * settings.prox_reg * pmask.theta * th_once)
            fact_n = gfactor(regs_n)
            regs_f = tree_select(failed, regs_n, regs_f)
            fact = tree_select(failed, fact_n, fact)
        factor_failed = fact.status != 0

        sol = kkt_solve(fact, ev.stage, b, sched, backend, theta_sum)
        for _ in range(settings.iterative_refinement_steps):
            # coupled: apply_K's θ row is this scenario's contribution
            # (r1_th counted on scenario 0), reduced again by kkt_solve
            resid = b - apply_K(ev.stage, regs_f, sol, sched)
            sol = sol + kkt_solve(fact, ev.stage, resid, sched, backend,
                                  theta_sum)
        dv, dy, dz = _primal_of(sol), _y_of(sol), _z_of(sol)
        ds = tree_map(lambda ri, gdx, m: torch.where(m, -ri - gdx, 0.0),
                      r_ineq, _z_of(apply_G(ev.stage, sol, sched)), zmask)
        dzl = tree_map(lambda d, l, dx_, h: torch.where(
            h, lv(mu, d) / d - l - (l / d) * dx_, 0.0), dl, zl, dv, has_lb)
        dzu = tree_map(lambda d, u_, dx_, h: torch.where(
            h, lv(mu, d) / d - u_ + (u_ / d) * dx_, 0.0), du, zu, dv, has_ub)

        # A failed factorization's direction is garbage: zero it (which also
        # scrubs NaNs), so this iteration becomes a rejected step and the
        # reg boost below retries with heavier regularization
        def scrub(t):
            return tree_map(lambda a: torch.where(lv(factor_failed, a),
                                                  torch.zeros_like(a), a), t)
        dv, dy, dz, ds, dzl, dzu = (scrub(dv), scrub(dy), scrub(dz),
                                    scrub(ds), scrub(dzl), scrub(dzu))

        # fraction-to-boundary step limits
        tau = torch.clamp(1.0 - mu, min=settings.tau_min)

        def max_step(val, dval, mask):
            # max alpha <= 1 with val + alpha*dval >= (1-tau)*val
            bad = mask & (dval < 0)
            a = torch.where(bad, -lv(tau, val) * val
                            / torch.where(bad, dval, -1.0), 1.0)
            return torch.clamp(_lmin(a), max=1.0)

        def min_steps(vals, dvals, msks, sign=1.0):
            out = lanes(1.0)
            for v_, d_, m_ in zip(tree_leaves(vals), tree_leaves(dvals),
                                  tree_leaves(msks)):
                out = torch.minimum(out, max_step(v_, sign * d_, m_))
            return out

        alpha_p = gmin(torch.minimum(
            min_steps(s, ds, zmask),
            torch.minimum(min_steps(dl, dv, has_lb),
                          min_steps(du, dv, has_ub, -1.0))))
        alpha_d = gmin(torch.minimum(min_steps(z, dz, zmask), torch.minimum(
            min_steps(zl, dzl, has_lb), min_steps(zu, dzu, has_ub))))

        # ----- line search on the barrier merit ---------------------------
        phi0, theta0 = barrier_value(vars, s, ev.f, ev.c, ev.g, mu, 0.0)
        # directional derivative of f + barrier
        d_phi = gsum(_tdot(ev.grad, dv)
                     - mu * _tsum(tree_map(
                         lambda dsv, sv, m: torch.where(m, dsv / sv, 0.0),
                         ds, s, zmask))
                     - mu * _tsum(tree_map(
                         lambda dx_, d, h: torch.where(h, dx_ / d, 0.0),
                         dv, dl, has_lb))
                     + mu * _tsum(tree_map(
                         lambda dx_, d, h: torch.where(h, dx_ / d, 0.0),
                         dv, du, has_ub)))
        nu = torch.maximum(st.nu, torch.where(
            theta0 > 1e-14, d_phi / ((1.0 - ls.nu_rho)
                                     * torch.clamp(theta0, min=1e-14)),
            ls.nu_min))
        nu = torch.clamp(nu, min=ls.nu_min)
        slope = d_phi - nu * theta0
        phi0 = phi0 + nu * theta0

        def probe(alphas, nu_p):
            """Merit of `chunk` trial points at once: alphas [chunk, B] ->
            (phi [chunk, B], theta [chunk, B])."""
            vars_t = tree_map(lambda v_, d_: v_[None]
                              + lane_view(alphas, v_[None]) * d_[None],
                              vars, dv)
            s_t = tree_map(lambda sv, dsv: sv[None]
                           + lane_view(alphas, sv[None]) * dsv[None], s, ds)
            f_t, c_t, g_t = problem.eval_fcg(vars_t)
            return barrier_value(vars_t, s_t, f_t, c_t, g_t, mu, nu_p)

        def fused_merit(alphas):
            """The fused probe's (f - mu logb, theta), [chunk, B] each, for
            alphas [chunk, B]: no slack terms (eligible problems have no
            inequality rows), -inf barrier on bound violations."""
            f_t, th_t, lb_t = fused_probe_fn(
                vars.x.contiguous(), dv.x.contiguous(), vars.u.contiguous(),
                dv.u.contiguous(), fused_x0, alphas.t())
            return f_t.t() - mu * lb_t.t(), th_t.t()

        chunk = max(1, int(ls.chunk))

        def chunked(alpha, k, acceptable):
            """One trip: test the chunk of candidates below `alpha`; returns
            (alpha_next, ok).  Candidates are built by ITERATED
            multiplication (identical to the sequential chunk=1 search),
            and candidates past the max_steps budget are masked out."""
            cands = [alpha]
            for _ in range(chunk - 1):
                cands.append(cands[-1] * ls.backtrack)
            alphas = torch.stack(cands)                      # [chunk, B]
            budget = (torch.arange(chunk, device=device) + k) < ls.max_steps
            oks = acceptable(alphas) & budget[:, None]
            any_ok = oks.any(dim=0)
            # first passing candidate = the largest alpha
            slots = torch.arange(chunk, device=device)[:, None]
            first = torch.where(oks, slots, chunk - 1).amin(dim=0)
            sel = alphas.gather(0, first[None])[0]
            return torch.where(any_ok, sel, alphas[-1] * ls.backtrack), any_ok

        if ls.use_filter_line_search:
            # Waechter-Biegler-style filter: accept a trial not dominated by
            # any remembered (theta, phi) pair and improving on the current
            # pair (or satisfying Armijo on phi for f-type steps).
            phi_bar0, _ = barrier_value(vars, s, ev.f, ev.c, ev.g, mu, 0.0)

            def acceptable(alphas):
                if fused_probe_fn is not None:
                    phi_t, theta_t = fused_merit(alphas)
                else:
                    phi_t, theta_t = probe(alphas, 0.0)
                not_dom = torch.all(
                    (theta_t[..., None]
                     <= (1.0 - ls.gamma_theta) * st.filt_th)
                    | (phi_t[..., None]
                       <= st.filt_ph - ls.gamma_phi * st.filt_th), dim=-1)
                progress = ((theta_t <= (1.0 - ls.gamma_theta) * theta0)
                            | (phi_t <= phi_bar0 - ls.gamma_phi * theta0))
                armijo = phi_t <= phi_bar0 + ls.eta * alphas * d_phi
                return not_dom & (progress | armijo)
        else:
            def acceptable(alphas):
                if fused_probe_fn is not None:
                    base, theta_t = fused_merit(alphas)
                    phis = base + nu * theta_t
                else:
                    phis, _ = probe(alphas, nu)
                return phis <= phi0 + ls.eta * alphas * slope

        # bounded backtracking: trip j tests candidates j*chunk ..; a lane
        # stops once accepted (NaN-merit lanes never start, as in the
        # while_loop whose init marks them accepted)
        alpha = alpha_p + 0.0 * phi0
        accepted = phi0 != phi0
        for j in range(-(-ls.max_steps // chunk)):
            alpha_n, ok = chunked(alpha, j * chunk, acceptable)
            alpha = torch.where(accepted, alpha, alpha_n)
            accepted = accepted | ok

        if ls.use_filter_line_search:
            # augment the filter with the current pair (theta-type step) —
            # only when the step was actually taken
            slot = st.it.clamp(max=K_it - 1).long()[:, None]
            filt_th_n = torch.where(
                accepted[:, None],
                st.filt_th.scatter(1, slot, ((1.0 - ls.gamma_theta)
                                             * theta0)[:, None]),
                st.filt_th)
            filt_ph_n = torch.where(
                accepted[:, None],
                st.filt_ph.scatter(1, slot, (phi_bar0 - ls.gamma_phi
                                             * theta0)[:, None]),
                st.filt_ph)
        else:
            filt_th_n, filt_ph_n = st.filt_th, st.filt_ph

        # Min-alpha safeguard: an exhausted line search REJECTS the step
        # (alpha = 0) and inflates the carried regularization boost
        alpha = torch.where(accepted, alpha, torch.zeros_like(alpha))
        step_rejected = factor_failed | ~accepted
        reg_boost_n = torch.where(
            step_rejected,
            torch.clamp(st.reg_boost * settings.reg_boost_scale,
                        max=settings.reg_boost_max),
            torch.clamp(st.reg_boost * settings.reg_boost_decay, min=1.0))
        consec_rej_n = torch.where(step_rejected, st.consec_rej + 1,
                                   torch.zeros_like(st.consec_rej))

        # duals still step on a rejected primal step (a failed
        # factorization's directions were scrubbed to zero above)
        vars_n = tree_map(lambda v_, d_: step_along(v_, d_, alpha), vars, dv)
        s_n = tree_map(lambda sv, dsv: step_along(sv, dsv, alpha), s, ds)
        y_n = tree_map(lambda a, d_: step_along(a, d_, alpha_d), y, dy)
        z_n = tree_map(lambda a, d_, m: torch.where(
            m, step_along(a, d_, alpha_d), 1.0), z, dz, zmask)
        zl_n = tree_map(lambda a, d_, h: torch.where(
            h, step_along(a, d_, alpha_d), 0.0), zl, dzl, has_lb)
        zu_n = tree_map(lambda a, d_, h: torch.where(
            h, step_along(a, d_, alpha_d), 0.0), zu, dzu, has_ub)
        # z-corridor safeguard (IPOPT's kappa_sigma reset)
        z_n = tree_map(lambda zv, sv, m: torch.where(
            m, torch.clamp(zv, lv(mu, sv) / (settings.kappa_sigma * sv),
                           settings.kappa_sigma * lv(mu, sv) / sv), 1.0),
            z_n, s_n, zmask)
        s_n = tree_map(lambda sv, m: torch.where(
            m, torch.clamp(sv, min=settings.slack_min), 1.0), s_n, zmask)

        if settings.logging.print_logs:
            print(f"it={st.it.tolist()} f={ev.f.tolist()} "
                  f"E0={st.kkt_error.tolist()} mu={st.mu.tolist()} "
                  f"alpha={alpha.tolist()} alphad={alpha_d.tolist()} "
                  f"nu={nu.tolist()} st={fact.status.tolist()}")
        if settings.logging.print_search_direction_logs:
            print(f"  dir: |dx|={_tinf(dv).tolist()} |dy|={_tinf(dy).tolist()}"
                  f" |dz|={_tinf(dz).tolist()} alpha_max={alpha_p.tolist()}")
        if settings.logging.print_line_search_logs:
            print(f"  ls: alpha={alpha.tolist()} phi0={phi0.tolist()} "
                  f"slope={slope.tolist()} theta0={theta0.tolist()} "
                  f"nu={nu.tolist()}")

        it_n = st.it + 1
        # evaluate the model at the ACCEPTED iterate and classify it
        ev_n = problem.eval_model(vars_n, y_n, z_n)
        _, _, err_n_fn = kkt_residuals(vars_n, s_n, y_n, z_n, zl_n, zu_n,
                                       ev_n)
        e_new = err_n_fn(0.0)
        # non-finite KKT error counts as divergence
        blew_up = ~torch.isfinite(e_new) | (e_new > settings.diverged_kkt)
        # FACTORIZATION_FAILURE is terminal only once the boost saturated
        gave_up = factor_failed & (st.reg_boost >= settings.reg_boost_max)
        stalled = consec_rej_n >= settings.max_consecutive_rejections
        new_status = torch.where(
            e_new <= settings.tol, int(SIPStatus.SOLVED),
            torch.where(gave_up, int(SIPStatus.FACTORIZATION_FAILURE),
                        torch.where(blew_up, int(SIPStatus.DIVERGED),
                                    torch.where(
                                        stalled, int(SIPStatus.STALLED),
                                        torch.where(
                                            it_n >= settings.max_iterations,
                                            int(SIPStatus.MAX_ITERATIONS),
                                            int(SIPStatus.RUNNING))))
                        )).to(torch.int32)
        return _IPMState(
            vars=vars_n, s=s_n, y=y_n, z=z_n, zl=zl_n, zu=zu_n,
            mu=mu, nu=nu, it=it_n, status=new_status, kkt_error=e_new,
            reg_boost=reg_boost_n, consec_rej=consec_rej_n, ev=ev_n,
            filt_th=filt_th_n, filt_ph=filt_ph_n)

    def trip(st: _IPMState, freeze_ev: bool) -> _IPMState:
        """One iteration for every scenario; scenarios that left RUNNING
        keep their state (the vmapped while_loop's select)."""
        new = body(st)
        keep = st.status == int(SIPStatus.RUNNING)
        if freeze_ev:
            return tree_select(keep, new, st)
        out = tree_select(keep, new._replace(ev=st.ev), st)
        return out._replace(ev=new.ev)

    if settings.fixed_iterations:
        # Real-time-iteration mode: exactly max_iterations trips, no host
        # synchronisation
        for _ in range(settings.max_iterations):
            state = trip(state, settings.rti_freeze_ev)
            if settings.debug_check_finite:
                _report_nonfinite("trip", state)
    else:
        # Convergence-tested mode: one host check per trip.  A coupled
        # solve over a mesh takes the group's decision, so that every rank
        # runs the same trips (each holds collectives); its statuses are
        # the joint problem's and agree across ranks anyway
        def running(st):
            flags = st.status == int(SIPStatus.RUNNING)
            return mesh.any(flags) if coupled else bool(flags.any())

        while running(state):
            state = trip(state, True)
            if settings.debug_check_finite:
                _report_nonfinite("trip", state)

    status = torch.where(state.status == int(SIPStatus.RUNNING),
                         int(SIPStatus.MAX_ITERATIONS),
                         state.status).to(torch.int32)
    return SolveResult(
        vars=state.vars, s=state.s, y=state.y, z=state.z, zl=state.zl,
        zu=state.zu, f=state.ev.f, status=status, iterations=state.it,
        kkt_error=state.kkt_error, mu=state.mu)


def _report_nonfinite(where: str, st: _IPMState) -> None:
    """Sanitizer-style tripwire (Settings.debug_check_finite): print the
    scenarios whose iterate, model evaluation, duals or KKT error are
    non-finite.  Reads values on the host."""
    def lane_ok(tree):
        ok = None
        for leaf in tree_leaves(tree):
            v = torch.isfinite(leaf).flatten(1).all(-1) if leaf.dim() > 1 \
                else torch.isfinite(leaf)
            ok = v if ok is None else ok & v
        return ok

    bad = ~(lane_ok(st.vars) & lane_ok((st.ev.f, st.ev.grad, st.ev.c,
                                        st.ev.g))
            & lane_ok((st.y, st.z, st.zl, st.zu, st.s))
            & torch.isfinite(st.kkt_error))
    if bool(bad.any()):
        print(f"NONFINITE at {where}: scenarios "
              f"{torch.nonzero(bad).flatten().tolist()} it={st.it.tolist()}")
