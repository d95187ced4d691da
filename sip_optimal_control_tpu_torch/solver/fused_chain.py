"""Fused-iteration interior-point loop for the eligible chain class.

PyTorch port of ``sip_optimal_control_tpu/solver/fused_chain.py``.
Semantically this is ``solver/sip.py``'s loop specialised to the problems
the fused kernels take (chain, uniform dims, float32, no theta, box bounds
only: no slack rows, no constraint multipliers), with three structural
changes:

  1. The model evaluation carried between iterations is a handful of O(n)
     per-stage VECTORS (``_VecEval``: objective, cost gradients, C^T y
     products, dynamics residuals, packed KKT reductions), produced by the
     eval kernel; the [B, T, n, n] stage blocks of the standard path never
     exist, so the fixed-trip freeze select moves only vectors.
  2. Stage derivatives, condensation and the Riccati factor and solve run
     as the three fused kernels (``ops/fused_iter.py``); nothing but the
     Newton direction and the statuses comes back.
  3. The line search probes through the fused probe kernel
     (``ops/ls_probe.py``), as on the standard path.

As in ``solver/sip.py`` every scalar of the JAX loop is a [B] tensor, the
vmapped per-scenario control flow becomes per-lane masks and selects, and
the fixed-trip body reads nothing back to the host.  ``solver.sip.solve``
dispatches here when ``Settings.fused_iteration`` is set and ``_eligible``
holds; CPU tensors run the kernels' plain twins.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .._tree import lane_view, tree_leaves, tree_map, tree_select
from ..ops.fused_iter import make_fused_eval, make_fused_factor_solve
from ..ops.ls_probe import make_fused_probe
from .settings import Settings, SIPStatus
from .sip import (_EPS, OCProblem, Primal, SolveResult, YVec, ZVec, _lmin,
                  _lsum, _tdot, _tsum)


class _VecEval(NamedTuple):
    """The carried model evaluation: vectors only (cf. sip.ModelEval)."""

    f: torch.Tensor      # [B] objective
    gx: torch.Tensor     # [B, N, n] objective gradient wrt states
    gu: torch.Tensor     # [B, E, m] objective gradient wrt controls
    ctx: torch.Tensor    # [B, N, n] C^T y rows (dual dynamics products)
    ctu: torch.Tensor    # [B, E, m]
    cdyn: torch.Tensor   # [B, N, n] equality residuals (root row at node 0)
    res: torch.Tensor    # [B, 6] packed KKT reductions: max|stat|, max|c|,
                         #        min/max d*z (lower), min/max d*z (upper)


class _FState(NamedTuple):
    vars: Primal
    y: torch.Tensor             # [B, N, n] dynamics multipliers
    zl: Primal
    zu: Primal
    mu: torch.Tensor
    nu: torch.Tensor
    it: torch.Tensor
    status: torch.Tensor
    kkt_error: torch.Tensor
    reg_boost: torch.Tensor
    consec_rej: torch.Tensor
    ev: _VecEval
    filt_th: torch.Tensor
    filt_ph: torch.Tensor


def _is_scalar(s) -> bool:
    return isinstance(s, (int, float)) or (
        isinstance(s, torch.Tensor) and s.dim() == 0)


def _eligible(problem: OCProblem, settings: Settings,
              coupled: bool = False) -> bool:
    """The gate of the fused path (JAX fused_chain.py:76-99); every miss
    uses the standard solver (same results, standard performance).  A
    coupled (shared-θ) solve never takes it."""
    logging = settings.logging
    return (settings.fused_iteration
            and problem.fused_iter is not None
            and problem.fused_ls is not None
            # the fused iteration's line search IS the fused probe; a user
            # disabling it gets the standard solver, which honours the flag
            and settings.line_search.fused_probe
            and not coupled
            and problem.fused_iter[2].dtype == torch.float32
            and settings.iterative_refinement_steps == 0
            and _is_scalar(problem.scale_dual)
            and _is_scalar(problem.scale_equality)
            and _is_scalar(problem.scale_bound)
            and not settings.debug_check_finite
            and not (logging.print_logs or logging.print_line_search_logs
                     or logging.print_search_direction_logs
                     or logging.print_derivative_check_logs))


def solve_fused(problem: OCProblem, settings: Settings, init_vars=None,
                init_y=None, init_z=None, init_zl=None,
                init_zu=None) -> SolveResult:
    """Fused-iteration solve; call through ``solver.sip.solve``, which
    applies the eligibility gate.  ``init_z`` is unused: the class has no
    inequality rows."""
    dims = problem.dims
    N, E = dims.num_nodes, dims.num_edges
    ispec, ibounds, x0 = problem.fused_iter
    fspec, fbounds, fused_x0 = problem.fused_ls
    ls = settings.line_search
    x0, fused_x0 = x0.contiguous(), fused_x0.contiguous()

    fused_eval = make_fused_eval(ispec, ibounds)
    fused_factor_solve = make_fused_factor_solve(ispec, ibounds)
    fused_probe_fn = make_fused_probe(fspec, fbounds)

    lower, upper = problem.lower, problem.upper
    has_lb = tree_map(torch.isfinite, lower)
    has_ub = tree_map(torch.isfinite, upper)

    def dist_l(vars):
        return tree_map(lambda v, lb, h: torch.where(h, v - lb, 1.0), vars,
                        lower, has_lb)

    def dist_u(vars):
        return tree_map(lambda v, ub, h: torch.where(h, ub - v, 1.0), vars,
                        upper, has_ub)

    # ----- initialization (identical to sip.py's) --------------------------
    push_eps = (settings.warm_bound_push if init_vars is not None
                else settings.bound_push)
    if init_vars is None:
        init_vars = problem.default_init
    dtype, device = init_vars.x.dtype, init_vars.x.device
    batch = init_vars.x.shape[0]

    def lanes(fill, dt=dtype):
        return torch.full((batch,), fill, dtype=dt, device=device)

    def push(v, lb, ub, hl, hu):
        lo = torch.where(hl, lb + push_eps * torch.clamp(lb.abs(), min=1.0),
                         -math.inf)
        hi = torch.where(hu, ub - push_eps * torch.clamp(ub.abs(), min=1.0),
                         math.inf)
        mid = torch.where(hl & hu, 0.5 * (lb + ub), 0.0)
        return torch.where(lo <= hi, torch.clamp(v, lo, hi), mid)

    vars0 = tree_map(push, init_vars, lower, upper, has_lb, has_ub)
    y0 = (init_y.dyn if init_y is not None
          else torch.zeros_like(vars0.x))
    mu0 = lanes(settings.mu_init)
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
    sd_, se_, sb_ = (problem.scale_dual, problem.scale_equality,
                     problem.scale_bound)

    def eval_at(vars, y, zl, zu):
        return _VecEval(*fused_eval(
            vars.x.contiguous(), vars.u.contiguous(), y.contiguous(), x0,
            zl.x.contiguous(), zl.u.contiguous(), zu.x.contiguous(),
            zu.u.contiguous()))

    # ----- residuals from the eval kernel's packed reductions -------------
    # the bound-complementarity inf-norm at ANY barrier value m follows
    # from the min/max pair: max_i |v_i - m| = max(vmax - m, m - vmin),
    # with the standard path's masked-entry zero floor
    def kkt_err(ev: _VecEval, m_mu):
        r = ev.res
        comp = torch.clamp(torch.maximum(
            torch.maximum(r[:, 3] - m_mu, m_mu - r[:, 2]),
            torch.maximum(r[:, 5] - m_mu, m_mu - r[:, 4])), min=0.0)
        return torch.amax(torch.stack([sd_ * r[:, 0], se_ * r[:, 1],
                                       sb_ * comp]), dim=0)

    ev0 = eval_at(vars0, y0, zl0, zu0)
    err0 = kkt_err(ev0, 0.0)
    status_init = torch.where(
        err0 <= settings.tol, int(SIPStatus.SOLVED),
        torch.where(~torch.isfinite(err0) | (err0 > settings.diverged_kkt),
                    int(SIPStatus.DIVERGED),
                    int(SIPStatus.RUNNING))).to(torch.int32)
    K_it = settings.max_iterations
    state = _FState(
        vars=vars0, y=y0, zl=zl0, zu=zu0, mu=mu0, nu=lanes(ls.nu_min),
        it=lanes(0, torch.int32), status=status_init, kkt_error=err0,
        reg_boost=lanes(1.0), consec_rej=lanes(0, torch.int32), ev=ev0,
        filt_th=torch.full((batch, K_it), math.inf, dtype=dtype,
                           device=device),
        filt_ph=torch.full((batch, K_it), math.inf, dtype=dtype,
                           device=device))

    def log_barrier(vars):
        def logs(dists, has):
            return _tsum(tree_map(lambda d, h: torch.where(
                h, torch.log(torch.clamp(d, min=_EPS)), 0.0), dists, has))
        return logs(dist_l(vars), has_lb) + logs(dist_u(vars), has_ub)

    def max_step(val, dval, mask, tau):
        bad = mask & (dval < 0)
        a = torch.where(bad, -lane_view(tau, val) * val
                        / torch.where(bad, dval, -1.0), 1.0)
        return torch.clamp(_lmin(a), max=1.0)

    def min_steps(vals, dvals, msks, tau, sign=1.0):
        out = lanes(1.0)
        for v_, d_, m_ in zip(tree_leaves(vals), tree_leaves(dvals),
                              tree_leaves(msks)):
            out = torch.minimum(out, max_step(v_, sign * d_, m_, tau))
        return out

    # ----- one IPM iteration ----------------------------------------------
    def body(st: _FState) -> _FState:
        vars, y, zl, zu, mu, ev = st.vars, st.y, st.zl, st.zu, st.mu, st.ev
        shrink = kkt_err(ev, mu) <= settings.kappa_eps * mu
        mu = torch.where(
            shrink,
            torch.clamp(torch.minimum(settings.kappa_mu * mu,
                                      mu ** settings.theta_mu),
                        min=settings.mu_min),
            mu)

        def lv(v, like):
            return lane_view(v, like)

        dl, du = dist_l(vars), dist_u(vars)
        reg_d = settings.gamma_reg * mu + settings.reg_floor
        bound_diag = tree_map(
            lambda d1, l, h1, d2, u_, h2: torch.where(h1, l / d1, 0.0)
            + torch.where(h2, u_ / d2, 0.0), dl, zl, has_lb, du, zu, has_ub)
        r1 = tree_map(lambda b_: settings.prox_reg * lv(st.reg_boost, b_)
                      + b_, bound_diag)
        bound_grad = tree_map(
            lambda d1, h1, d2, h2: -torch.where(h1, lv(mu, d1) / d1, 0.0)
            + torch.where(h2, lv(mu, d2) / d2, 0.0), dl, has_lb, du, has_ub)
        # q_mod = -b_x = grad + C^T y + bound_grad (helpers.cpp:752-812
        # collapsed to the unconstrained case); c_mod = -b_y = c
        q_v = (ev.gx + ev.ctx + bound_grad.x).contiguous()
        r_v = (ev.gu + ev.ctu + bound_grad.u).contiguous()
        x_c, u_c, y_c = vars.x.contiguous(), vars.u.contiguous(), \
            y.contiguous()

        def try_factor(r1_):
            return fused_factor_solve(x_c, u_c, y_c, r1_.x.contiguous(),
                                      r1_.u.contiguous(), reg_d, q_v, r_v,
                                      ev.cdyn)

        # bounded proximal-inflation retries, as the standard loop: each
        # retry refactors every scenario and keeps the result where the
        # previous attempt failed
        r1c, out = r1, try_factor(r1)
        for _ in range(settings.max_factor_retries):
            failed = out[3] != 0
            rs = settings.retry_scale
            r1n = tree_map(lambda a: a * rs + rs * settings.prox_reg, r1c)
            out_n = try_factor(r1n)
            r1c = tree_select(failed, r1n, r1c)
            out = tree_select(failed, out_n, out)
        dx, du_, dy, fstatus = out
        factor_failed = fstatus != 0

        dv = Primal(x=dx, u=du_, theta=vars.theta * 0)
        dzl = tree_map(lambda d, l, dx_, h: torch.where(
            h, lv(mu, d) / d - l - (l / d) * dx_, 0.0), dl, zl, dv, has_lb)
        dzu = tree_map(lambda d, u_, dx_, h: torch.where(
            h, lv(mu, d) / d - u_ + (u_ / d) * dx_, 0.0), du, zu, dv, has_ub)

        # a failed factorization's direction is garbage: zero it (which
        # also scrubs NaNs, JAX fused_chain.py:288-292)
        def scrub(t):
            return tree_map(lambda a: torch.where(lv(factor_failed, a),
                                                  torch.zeros_like(a), a), t)
        dv, dy, dzl, dzu = scrub(dv), scrub(dy), scrub(dzl), scrub(dzu)

        tau = torch.clamp(1.0 - mu, min=settings.tau_min)
        alpha_p = torch.minimum(min_steps(dl, dv, has_lb, tau),
                                min_steps(du, dv, has_ub, tau, -1.0))
        alpha_d = torch.minimum(min_steps(zl, dzl, has_lb, tau),
                                min_steps(zu, dzu, has_ub, tau))

        # ----- line search (fused probe; the same scalars as sip.py) ------
        theta0 = _lsum(ev.cdyn.abs())
        phi_bar0 = ev.f - mu * log_barrier(vars)
        d_phi = (_tdot(Primal(x=ev.gx, u=ev.gu, theta=vars.theta * 0), dv)
                 - mu * _tsum(tree_map(
                     lambda dx_, d, h: torch.where(h, dx_ / d, 0.0), dv, dl,
                     has_lb))
                 + mu * _tsum(tree_map(
                     lambda dx_, d, h: torch.where(h, dx_ / d, 0.0), dv, du,
                     has_ub)))
        nu = torch.maximum(st.nu, torch.where(
            theta0 > 1e-14, d_phi / ((1.0 - ls.nu_rho)
                                     * torch.clamp(theta0, min=1e-14)),
            ls.nu_min))
        nu = torch.clamp(nu, min=ls.nu_min)
        slope = d_phi - nu * theta0
        phi0 = phi_bar0 + nu * theta0

        dvx, dvu = dv.x.contiguous(), dv.u.contiguous()

        def fused_merit(alphas):
            """(f - mu logb, theta) [chunk, B] for alphas [chunk, B]."""
            f_t, th_t, lb_t = fused_probe_fn(x_c, dvx, u_c, dvu, fused_x0,
                                             alphas.t())
            return f_t.t() - mu * lb_t.t(), th_t.t()

        chunk = max(1, int(ls.chunk))

        def chunked(alpha, k, acceptable):
            cands = [alpha]
            for _ in range(chunk - 1):
                cands.append(cands[-1] * ls.backtrack)
            alphas = torch.stack(cands)                      # [chunk, B]
            budget = (torch.arange(chunk, device=device) + k) < ls.max_steps
            oks = acceptable(alphas) & budget[:, None]
            any_ok = oks.any(dim=0)
            slots = torch.arange(chunk, device=device)[:, None]
            first = torch.where(oks, slots, chunk - 1).amin(dim=0)
            sel = alphas.gather(0, first[None])[0]
            return torch.where(any_ok, sel, alphas[-1] * ls.backtrack), any_ok

        if ls.use_filter_line_search:
            def acceptable(alphas):
                phi_t, theta_t = fused_merit(alphas)
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
                base, theta_t = fused_merit(alphas)
                return (base + nu * theta_t
                        <= phi0 + ls.eta * alphas * slope)

        alpha = alpha_p + 0.0 * phi0
        accepted = phi0 != phi0
        for j in range(-(-ls.max_steps // chunk)):
            alpha_n, ok = chunked(alpha, j * chunk, acceptable)
            alpha = torch.where(accepted, alpha, alpha_n)
            accepted = accepted | ok

        if ls.use_filter_line_search:
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

        alpha = torch.where(accepted, alpha, torch.zeros_like(alpha))
        step_rejected = factor_failed | ~accepted
        reg_boost_n = torch.where(
            step_rejected,
            torch.clamp(st.reg_boost * settings.reg_boost_scale,
                        max=settings.reg_boost_max),
            torch.clamp(st.reg_boost * settings.reg_boost_decay, min=1.0))
        consec_rej_n = torch.where(step_rejected, st.consec_rej + 1,
                                   torch.zeros_like(st.consec_rej))

        vars_n = tree_map(lambda v_, d_: v_ + lv(alpha, v_) * d_, vars, dv)
        y_n = y + lv(alpha_d, y) * dy
        zl_n = tree_map(lambda a, d_, h: torch.where(
            h, a + lv(alpha_d, a) * d_, 0.0), zl, dzl, has_lb)
        zu_n = tree_map(lambda a, d_, h: torch.where(
            h, a + lv(alpha_d, a) * d_, 0.0), zu, dzu, has_ub)

        it_n = st.it + 1
        ev_n = eval_at(vars_n, y_n, zl_n, zu_n)
        e_new = kkt_err(ev_n, 0.0)
        blew_up = ~torch.isfinite(e_new) | (e_new > settings.diverged_kkt)
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
        return _FState(
            vars=vars_n, y=y_n, zl=zl_n, zu=zu_n, mu=mu, nu=nu, it=it_n,
            status=new_status, kkt_error=e_new, reg_boost=reg_boost_n,
            consec_rej=consec_rej_n, ev=ev_n, filt_th=filt_th_n,
            filt_ph=filt_ph_n)

    def trip(st: _FState) -> _FState:
        """One iteration for every scenario; scenarios that left RUNNING
        keep their state, the carried vector evaluation included (JAX
        fused_chain.py:461-466)."""
        return tree_select(st.status == int(SIPStatus.RUNNING), body(st), st)

    if settings.fixed_iterations:
        for _ in range(settings.max_iterations):
            state = trip(state)
    else:
        while bool((state.status == int(SIPStatus.RUNNING)).any()):
            state = trip(state)

    status = torch.where(state.status == int(SIPStatus.RUNNING),
                         int(SIPStatus.MAX_ITERATIONS),
                         state.status).to(torch.int32)

    def empty(count):
        return torch.zeros((batch, count, 0), dtype=dtype, device=device)
    no_rows = ZVec(n=empty(N), e=empty(E))
    return SolveResult(
        vars=state.vars, s=no_rows,
        y=YVec(dyn=state.y, nc=empty(N), ec=empty(E)), z=no_rows,
        zl=state.zl, zu=state.zu, f=state.ev.f, status=status,
        iterations=state.it, kkt_error=state.kkt_error, mu=state.mu)
