"""Plain reference of the interior-point solve that one MPC period runs.

The semantics of ``sip_optimal_control_tpu_torch.solver.sip`` for the class
the benchmark's configurations belong to: a chain of T edges, uniform state
and control sizes, box bounds on states and controls as the only
inequalities, no shared parameters.  It is written out again here in plain
PyTorch, imports nothing of the program, and runs in float64 by default:

* the stage data come from ``torch.func`` derivatives of the plain stage
  functions of ``reference/<model>.py``;
* the Newton system is condensed and solved by the dual-regularized Riccati
  recursion (F = I + sqrt(delta) V sqrt(delta)) written as batched tensor
  algebra, one Python step per stage;
* the loop is the slack-free specialisation of the program's barrier
  method: monotone barrier schedule, proximal and dual regularization,
  factor retries, fraction-to-boundary, filter or Armijo backtracking in
  chunks of candidates, the regularization boost on rejected steps, and
  per-scenario statuses, with finished scenarios frozen.

The controls of the benchmark's output check run it in float32 one step
of precision lower: ``Arith("tf32")`` rounds both operands of every matrix
product to TF32 (10 mantissa bits, as a TF32 tensor-core product reads
them); ``Arith("bf16")`` stores every tensor that passes between the
solver's stages (stage data, Riccati factors, Newton directions, iterates
and multipliers) in bfloat16 and computes in float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.func import grad, hessian, jacfwd, vmap

SOLVED, MAX_ITERATIONS, FACTORIZATION_FAILURE, DIVERGED, STALLED = range(5)
RUNNING = 99
_EPS = 1e-300


MODES = ("full", "tf32", "bf16")


class Arith:
    """Matrix products and stored tensors: in the working precision
    ("full"), with TF32 operands ("tf32") or stored in bfloat16
    ("bf16")."""

    def __init__(self, mode: str = "full"):
        if mode not in MODES:
            raise ValueError(f"unknown precision mode {mode!r}")
        self.mode = mode

    def _round(self, t):
        if self.mode != "tf32":
            return t
        if t.dtype != torch.float32:
            raise TypeError("TF32 operands are rounded from float32")
        bits = t.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)

    def store(self, tree):
        """``tree`` (a tensor, or tuples, lists and dicts of them) as the
        solver keeps it between stages."""
        if self.mode != "bf16":
            return tree
        if isinstance(tree, dict):
            return {k: self.store(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(self.store(v) for v in tree)
        if torch.is_floating_point(tree):
            return tree.to(torch.bfloat16).to(tree.dtype)
        return tree

    def mm(self, a, b):
        return self._round(a) @ self._round(b)

    def mv(self, a, v):
        return self.mm(a, v[..., None])[..., 0]

    def tmv(self, a, v):
        return self.mm(a.transpose(-1, -2), v[..., None])[..., 0]


@dataclasses.dataclass
class Model:
    """The plain stage functions and bounds of one configuration.

    ``dynamics(x [n], u [m]) -> [n]``, ``node_cost(x [n], scale) -> []``,
    ``edge_cost(x [n], u [m]) -> []``; ``node_scale`` [T + 1] weights each
    node's cost; bounds are per-element vectors shared by every stage
    (+-inf where unbounded)."""

    n: int
    m: int
    T: int
    dynamics: object
    node_cost: object
    edge_cost: object
    node_scale: torch.Tensor
    x_lower: torch.Tensor
    x_upper: torch.Tensor
    u_lower: torch.Tensor
    u_upper: torch.Tensor


def _rows(fn, *args):
    """``vmap(fn)`` over every leading axis of ``args`` at once."""
    lead = args[0].shape[:-1]
    flat = [a.reshape((-1,) + a.shape[len(lead):]) for a in args]
    out = vmap(fn)(*flat)

    def unflat(o):
        if isinstance(o, tuple):
            return tuple(unflat(a) for a in o)
        return o.reshape(lead + o.shape[1:])
    return unflat(out)


class Problem:
    """One solve's data: the model, the hessian mode and the plant states
    x0 [B, n]."""

    def __init__(self, model: Model, x0, hessian_mode: str,
                 arith: Arith):
        self.md, self.x0, self.ar = model, x0, arith
        self.exact = hessian_mode == "exact"
        if hessian_mode not in ("exact", "gauss_newton"):
            raise ValueError(hessian_mode)
        md = model
        dt = x0.dtype
        T = md.T
        self.scale = md.node_scale.to(dt)
        self.lb_x = md.x_lower.to(dt).expand(T + 1, md.n)
        self.ub_x = md.x_upper.to(dt).expand(T + 1, md.n)
        self.lb_u = md.u_lower.to(dt).expand(T, md.m)
        self.ub_u = md.u_upper.to(dt).expand(T, md.m)
        self.hl_x, self.hu_x = (torch.isfinite(self.lb_x),
                                torch.isfinite(self.ub_x))
        self.hl_u, self.hu_u = (torch.isfinite(self.lb_u),
                                torch.isfinite(self.ub_u))

    # ----- residual-only evaluation (any leading axes) ------------------
    def fc(self, x, u):
        """(f, c): objective [...] and equality residuals [..., T+1, n]
        (the root row x0 - x_0, then one dynamics row per edge)."""
        md = self.md
        scale = self.scale.expand(x.shape[:-1])
        f = _rows(md.node_cost, x, scale).sum(-1) \
            + _rows(md.edge_cost, x[..., :-1, :], u).sum(-1)
        dyn = _rows(md.dynamics, x[..., :-1, :], u) - x[..., 1:, :]
        root = self.x0.expand(x.shape[:-2] + self.x0.shape[-1:]) \
            - x[..., 0, :]
        return f, torch.cat([root[..., None, :], dyn], dim=-2)

    # ----- full evaluation ------------------------------------------------
    def evaluate(self, x, u, y):
        """Objective, gradients, residuals and the stage blocks at (x, u)
        with dynamics multipliers y [B, T+1, n]."""
        md = self.md
        f, c = self.fc(x, u)
        scale = self.scale.expand(x.shape[:-1])
        xp = x[:, :-1]
        gxn = _rows(grad(md.node_cost), x, scale)
        gxe, gu = _rows(grad(md.edge_cost, argnums=(0, 1)), xp, u)
        gx = gxn + torch.cat([gxe, torch.zeros_like(gxn[:, :1])], dim=1)
        A, Bm = _rows(jacfwd(md.dynamics, argnums=(0, 1)), xp, u)
        Hn = _rows(hessian(md.node_cost), x, scale)
        if self.exact:
            def lag(xv, uv, yv):
                return md.edge_cost(xv, uv) + torch.dot(
                    yv, md.dynamics(xv, uv))
            (hxx, hxu), (_, huu) = _rows(hessian(lag, argnums=(0, 1)),
                                         xp, u, y[:, 1:])
        else:
            (hxx, hxu), (_, huu) = _rows(
                hessian(md.edge_cost, argnums=(0, 1)), xp, u)
        return self.ar.store(dict(f=f, c=c, gx=gx, gu=gu, A=A, B=Bm, Hn=Hn,
                                  Hxx=hxx, Hxu=hxu, Huu=huu))

    def ct(self, ev, y):
        """C^T y: (x rows [B, T+1, n], u rows [B, T, m])."""
        ar = self.ar
        at_y = ar.tmv(ev["A"], y[:, 1:])
        ctx = -y + torch.cat([at_y, torch.zeros_like(y[:, :1])], dim=1)
        return ctx, ar.tmv(ev["B"], y[:, 1:])


# ---------------------------------------------------------------------------
# dual-regularized Riccati recursion on a chain
# ---------------------------------------------------------------------------

def _chol(a):
    """Lower Cholesky factor and a per-row validity flag."""
    l, info = torch.linalg.cholesky_ex(a)
    d = torch.diagonal(l, dim1=-2, dim2=-1)
    return l, (info == 0) & torch.all(torch.isfinite(d) & (d > 0), dim=-1)


def _cho_solve(l, b):
    vec = b.dim() == l.dim() - 1
    rhs = b[..., None] if vec else b
    out = torch.cholesky_solve(rhs, l)
    return out[..., 0] if vec else out


def _factor_F(delta, V):
    sd = torch.sqrt(delta)
    n = V.shape[-1]
    F = sd[..., :, None] * V * sd[..., None, :] + torch.eye(
        n, dtype=V.dtype, device=V.device)
    l, ok = _chol(F)
    return l, sd, 1.0 / sd, ok


def lqr_factor(ar: Arith, Q, R, M, A, B, delta):
    """Q [B, T+1, n, n], R [B, T, m, m], M [B, T, n, m], A, B per edge,
    delta [B, n] on every node.  Returns (factors, ok [B])."""
    T = A.shape[1]
    n = Q.shape[-1]
    eye = torch.eye(n, dtype=Q.dtype, device=Q.device)
    Fl, sd, sdi, ok = _factor_F(delta, Q[:, T])
    V = [None] * (T + 1)
    F = [None] * (T + 1)
    W, K, Gl = [None] * T, [None] * T, [None] * T
    V[T], F[T] = Q[:, T], Fl
    for e in range(T - 1, -1, -1):
        Finv = _cho_solve(Fl, eye.expand(Fl.shape))
        We = sdi[..., :, None] * (eye - Finv) * sdi[..., None, :]
        Bt = B[:, e].transpose(-1, -2)
        BtW = ar.mm(Bt, We)
        G = R[:, e] + ar.mm(BtW, B[:, e])
        Gle, g_ok = _chol(G)
        WA = ar.mm(We, A[:, e])
        H = M[:, e].transpose(-1, -2) + ar.mm(Bt, WA)
        Ke = -_cho_solve(Gle, H)
        Ve = Q[:, e] + ar.mm(A[:, e].transpose(-1, -2), WA) \
            + ar.mm(Ke.transpose(-1, -2), H)
        Fl, sd, sdi, f_ok = _factor_F(delta, Ve)
        ok = ok & g_ok & f_ok
        V[e], F[e], W[e], K[e], Gl[e] = Ve, Fl, We, Ke, Gle
    return ar.store(dict(V=V, F=F, W=W, K=K, G=Gl)), ok


def lqr_solve(ar: Arith, fac, A, B, delta, q, r, c):
    """Solves the condensed system for right-hand sides q [B, T+1, n],
    r [B, T, m], c [B, T+1, n]; returns (x, u, y)."""
    T = A.shape[1]
    sd = torch.sqrt(delta)

    def f_inv_apply(Fl, b):
        return sd * _cho_solve(Fl, b / sd)

    v = [None] * (T + 1)
    k = [None] * T
    v[T] = q[:, T]
    for e in range(T - 1, -1, -1):
        f = delta * v[e + 1] - c[:, e + 1]
        g = v[e + 1] - ar.mv(fac["W"][e], f)
        h = r[:, e] + ar.tmv(B[:, e], g)
        k[e] = -_cho_solve(fac["G"][e], h)
        v[e] = q[:, e] + ar.tmv(A[:, e], g) + ar.tmv(fac["K"][e], h)
    x = -f_inv_apply(fac["F"][0], delta * v[0] - c[:, 0])
    xs, us, ys = [x], [], [v[0] + ar.mv(fac["V"][0], x)]
    for e in range(T):
        u = k[e] + ar.mv(fac["K"][e], x)
        rhs = c[:, e + 1] - delta * v[e + 1] + ar.mv(A[:, e], x) \
            + ar.mv(B[:, e], u)
        x = f_inv_apply(fac["F"][e + 1], rhs)
        us.append(u)
        xs.append(x)
        ys.append(v[e + 1] + ar.mv(fac["V"][e + 1], x))
    return ar.store((torch.stack(xs, 1), torch.stack(us, 1),
                     torch.stack(ys, 1)))


# ---------------------------------------------------------------------------
# the interior-point loop
# ---------------------------------------------------------------------------

def _lv(v, like):
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def _fmax(t):
    """Per-scenario max over every axis but the first (0 when empty)."""
    flat = t.flatten(1)
    if flat.shape[1] == 0:
        return flat.new_zeros(flat.shape[0])
    return torch.clamp(flat.amax(-1), min=0.0)


def _fsum(t, lead=1):
    return t.flatten(lead).sum(-1)


def solve(prob: Problem, st, init_x, init_u, init_y):
    """Warm-started solve from (init_x [B, T+1, n], init_u [B, T, m],
    init_y [B, T+1, n]) under settings ``st`` (the program's Settings
    fields as a dict, ``line_search`` a dict).  Returns x, u, y, status,
    iterations, kkt_error and mu, each per scenario."""
    ls = st["line_search"]
    ar = prob.ar
    dt, dev = init_x.dtype, init_x.device
    Bn = init_x.shape[0]
    K_it = st["max_iterations"]
    lbs = (prob.lb_x, prob.lb_u)
    ubs = (prob.ub_x, prob.ub_u)
    hls = (prob.hl_x, prob.hl_u)
    hus = (prob.hu_x, prob.hu_u)
    push_eps = st["warm_bound_push"]
    tol = st["tol"]

    def lanes(v, dtype=dt):
        return torch.full((Bn,), v, dtype=dtype, device=dev)

    def push(v, lb, ub, hl, hu):
        lo = torch.where(hl, lb + push_eps * torch.clamp(lb.abs(), min=1.0),
                         -math.inf)
        hi = torch.where(hu, ub - push_eps * torch.clamp(ub.abs(), min=1.0),
                         math.inf)
        mid = torch.where(hl & hu, 0.5 * (lb + ub), 0.0)
        return torch.where(lo <= hi, torch.clamp(v, lo, hi), mid)

    def dist_l(v):
        return tuple(torch.where(h, a - lb, 1.0)
                     for a, lb, h in zip(v, lbs, hls))

    def dist_u(v):
        return tuple(torch.where(h, ub - a, 1.0)
                     for a, ub, h in zip(v, ubs, hus))

    v0 = tuple(push(a, lb, ub, hl, hu)
               for a, lb, ub, hl, hu in zip((init_x, init_u), lbs, ubs, hls,
                                            hus))
    mu0 = lanes(st["mu_init"])
    zl0 = tuple(torch.where(h, _lv(mu0, d) / d, 0.0)
                for d, h in zip(dist_l(v0), hls))
    zu0 = tuple(torch.where(h, _lv(mu0, d) / d, 0.0)
                for d, h in zip(dist_u(v0), hus))

    def err_fn(v, y, zl, zu, ev):
        ctx, ctu = prob.ct(ev, y)
        stat = (ev["gx"] + ctx + zu[0] - zl[0], ev["gu"] + ctu + zu[1]
                - zl[1])
        base = torch.maximum(torch.maximum(_fmax(stat[0].abs()),
                                           _fmax(stat[1].abs())),
                             _fmax(ev["c"].abs()))

        def err(m_mu):
            comp = torch.zeros_like(base)
            for d, z, h in list(zip(dist_l(v), zl, hls)) \
                    + list(zip(dist_u(v), zu, hus)):
                cm = torch.where(h, d * z - _lv(m_mu, d), 0.0)
                comp = torch.maximum(comp, _fmax(cm.abs()))
            return torch.maximum(base, comp)
        return err

    def classify(e, it=None, gave_up=None, stalled=None):
        out = torch.where(~torch.isfinite(e) | (e > st["diverged_kkt"]),
                          DIVERGED, RUNNING)
        if it is not None:
            out = torch.where(it >= K_it, MAX_ITERATIONS, RUNNING)
            out = torch.where(stalled, STALLED, out)
            out = torch.where(~torch.isfinite(e) | (e > st["diverged_kkt"]),
                              DIVERGED, out)
            out = torch.where(gave_up, FACTORIZATION_FAILURE, out)
        return torch.where(e <= tol, SOLVED, out).to(torch.int32)

    y0 = init_y
    ev0 = prob.evaluate(v0[0], v0[1], y0)
    e0 = err_fn(v0, y0, zl0, zu0, ev0)(lanes(0.0))
    state = dict(v=v0, y=y0, zl=zl0, zu=zu0, mu=mu0,
                 nu=lanes(ls["nu_min"]), it=lanes(0, torch.int32),
                 status=classify(e0), kkt=e0, boost=lanes(1.0),
                 rej=lanes(0, torch.int32), ev=ev0,
                 fth=torch.full((Bn, K_it), math.inf, dtype=dt, device=dev),
                 fph=torch.full((Bn, K_it), math.inf, dtype=dt, device=dev))

    def barrier(v, f, c, mu, lead=1):
        log_b = 0.0
        for d, h in list(zip(dist_l(v), hls)) + list(zip(dist_u(v), hus)):
            # a trial point on or past a bound has an infinite barrier
            lg = torch.where(d > 0, torch.log(torch.clamp(d, min=_EPS)),
                             -math.inf)
            log_b = log_b + _fsum(torch.where(h, lg, 0.0), lead)
        theta = _fsum(c.abs(), lead)
        return f - mu * log_b, theta

    def body(s):
        v, y, zl, zu, mu, ev = (s["v"], s["y"], s["zl"], s["zu"], s["mu"],
                                s["ev"])
        err = err_fn(v, y, zl, zu, ev)
        e_mu = err(mu)
        shrink = e_mu <= st["kappa_eps"] * mu
        mu = torch.where(shrink, torch.clamp(torch.minimum(
            st["kappa_mu"] * mu, mu ** st["theta_mu"]), min=st["mu_min"]),
            mu)
        dl, du = dist_l(v), dist_u(v)
        reg_d = st["gamma_reg"] * mu + st["reg_floor"]
        bdiag = tuple(torch.where(h1, a / d1, 0.0) + torch.where(h2, b / d2,
                                                                 0.0)
                      for d1, a, h1, d2, b, h2 in zip(dl, zl, hls, du, zu,
                                                      hus))
        r1 = tuple(st["prox_reg"] * _lv(s["boost"], b) + b for b in bdiag)
        ctx, ctu = prob.ct(ev, y)
        bgrad = tuple(-torch.where(h1, _lv(mu, d1) / d1, 0.0)
                      + torch.where(h2, _lv(mu, d2) / d2, 0.0)
                      for d1, h1, d2, h2 in zip(dl, hls, du, hus))
        q = ev["gx"] + ctx + bgrad[0]
        r = ev["gu"] + ctu + bgrad[1]
        c = ev["c"]

        Qn = ev["Hn"].clone()
        Qn[:, :-1] += ev["Hxx"]
        delta = _lv(reg_d, ev["gx"][:, 0]).expand(-1, prob.md.n)

        def factor(r1x, r1u):
            return lqr_factor(ar, Qn + torch.diag_embed(r1x),
                              ev["Huu"] + torch.diag_embed(r1u), ev["Hxu"],
                              ev["A"], ev["B"], delta)

        r1f = r1
        fac, ok = factor(*r1f)
        for _ in range(st["max_factor_retries"]):
            failed = ~ok
            rs = st["retry_scale"]
            r1n = tuple(a * rs + rs * st["prox_reg"] for a in r1f)
            fac_n, ok_n = factor(*r1n)
            r1f = tuple(torch.where(_lv(failed, a), b, a)
                        for a, b in zip(r1f, r1n))
            fac = {k: [torch.where(_lv(failed, a), b, a)
                       for a, b in zip(fac[k], fac_n[k])] for k in fac}
            ok = torch.where(failed, ok_n, ok)
        factor_failed = ~ok

        dx, du_, dy = lqr_solve(ar, fac, ev["A"], ev["B"], delta, q, r, c)
        dv = (dx, du_)
        dzl = tuple(torch.where(h, _lv(mu, d) / d - a - (a / d) * dd, 0.0)
                    for d, a, dd, h in zip(dl, zl, dv, hls))
        dzu = tuple(torch.where(h, _lv(mu, d) / d - a + (a / d) * dd, 0.0)
                    for d, a, dd, h in zip(du, zu, dv, hus))

        def scrub(t):
            return tuple(torch.where(_lv(factor_failed, a),
                                     torch.zeros_like(a), a) for a in t)
        dv, dzl, dzu = scrub(dv), scrub(dzl), scrub(dzu)
        dy, = scrub((dy,))

        tau = torch.clamp(1.0 - mu, min=st["tau_min"])

        def max_step(val, dval, mask):
            bad = mask & (dval < 0)
            a = torch.where(bad, -_lv(tau, val) * val
                            / torch.where(bad, dval, -1.0), 1.0)
            return torch.clamp(a.flatten(1).amin(-1), max=1.0)

        def min_steps(vals, dvals, masks, sign=1.0):
            out = lanes(1.0)
            for a, d, m in zip(vals, dvals, masks):
                out = torch.minimum(out, max_step(a, sign * d, m))
            return out

        alpha_p = torch.minimum(min_steps(dl, dv, hls),
                                min_steps(du, dv, hus, -1.0))
        alpha_d = torch.minimum(min_steps(zl, dzl, hls),
                                min_steps(zu, dzu, hus))

        phi_bar0, theta0 = barrier(v, ev["f"], c, mu)
        d_phi = (_fsum(ev["gx"] * dv[0]) + _fsum(ev["gu"] * dv[1])
                 - mu * sum(_fsum(torch.where(h, dd / d, 0.0))
                            for dd, d, h in zip(dv, dl, hls))
                 + mu * sum(_fsum(torch.where(h, dd / d, 0.0))
                            for dd, d, h in zip(dv, du, hus)))
        nu = torch.maximum(s["nu"], torch.where(
            theta0 > 1e-14, d_phi / ((1.0 - ls["nu_rho"])
                                     * torch.clamp(theta0, min=1e-14)),
            ls["nu_min"]))
        nu = torch.clamp(nu, min=ls["nu_min"])
        slope = d_phi - nu * theta0
        phi0 = phi_bar0 + nu * theta0

        def merit(alphas):
            """(f - mu log-barrier, theta) at the trial points, each
            [chunk, B]."""
            xt = v[0][None] + _lv(alphas, v[0][None]) * dv[0][None]
            ut = v[1][None] + _lv(alphas, v[1][None]) * dv[1][None]
            f_t, c_t = prob.fc(xt, ut)
            return barrier((xt, ut), f_t, c_t, mu, lead=2)

        if ls["use_filter_line_search"]:
            gt, gp = ls["gamma_theta"], ls["gamma_phi"]

            def acceptable(alphas):
                phi_t, th_t = merit(alphas)
                not_dom = torch.all(
                    (th_t[..., None] <= (1.0 - gt) * s["fth"])
                    | (phi_t[..., None] <= s["fph"] - gp * s["fth"]), dim=-1)
                progress = ((th_t <= (1.0 - gt) * theta0)
                            | (phi_t <= phi_bar0 - gp * theta0))
                armijo = phi_t <= phi_bar0 + ls["eta"] * alphas * d_phi
                return not_dom & (progress | armijo)
        else:
            def acceptable(alphas):
                base, th_t = merit(alphas)
                return base + nu * th_t <= phi0 + ls["eta"] * alphas * slope

        chunk = max(1, int(ls["chunk"]))
        alpha = alpha_p + 0.0 * phi0
        accepted = phi0 != phi0
        for j in range(-(-ls["max_steps"] // chunk)):
            cands = [alpha]
            for _ in range(chunk - 1):
                cands.append(cands[-1] * ls["backtrack"])
            alphas = torch.stack(cands)
            budget = (torch.arange(chunk, device=dev) + j * chunk) \
                < ls["max_steps"]
            oks = acceptable(alphas) & budget[:, None]
            any_ok = oks.any(0)
            slots = torch.arange(chunk, device=dev)[:, None]
            first = torch.where(oks, slots, chunk - 1).amin(0)
            sel = alphas.gather(0, first[None])[0]
            alpha_n = torch.where(any_ok, sel, alphas[-1] * ls["backtrack"])
            alpha = torch.where(accepted, alpha, alpha_n)
            accepted = accepted | any_ok

        fth, fph = s["fth"], s["fph"]
        if ls["use_filter_line_search"]:
            slot = s["it"].clamp(max=K_it - 1).long()[:, None]
            fth = torch.where(accepted[:, None], fth.scatter(
                1, slot, ((1.0 - ls["gamma_theta"]) * theta0)[:, None]), fth)
            fph = torch.where(accepted[:, None], fph.scatter(
                1, slot, (phi_bar0 - ls["gamma_phi"] * theta0)[:, None]),
                fph)

        alpha = torch.where(accepted, alpha, torch.zeros_like(alpha))
        rejected = factor_failed | ~accepted
        boost = torch.where(
            rejected,
            torch.clamp(s["boost"] * st["reg_boost_scale"],
                        max=st["reg_boost_max"]),
            torch.clamp(s["boost"] * st["reg_boost_decay"], min=1.0))
        rej = torch.where(rejected, s["rej"] + 1, torch.zeros_like(s["rej"]))

        v_n = tuple(a + _lv(alpha, a) * d for a, d in zip(v, dv))
        y_n = y + _lv(alpha_d, y) * dy
        zl_n = tuple(torch.where(h, a + _lv(alpha_d, a) * d, 0.0)
                     for a, d, h in zip(zl, dzl, hls))
        zu_n = tuple(torch.where(h, a + _lv(alpha_d, a) * d, 0.0)
                     for a, d, h in zip(zu, dzu, hus))
        it_n = s["it"] + 1
        ev_n = prob.evaluate(v_n[0], v_n[1], y_n)
        e_new = err_fn(v_n, y_n, zl_n, zu_n, ev_n)(lanes(0.0))
        gave_up = factor_failed & (s["boost"] >= st["reg_boost_max"])
        stalled = rej >= st["max_consecutive_rejections"]
        status = classify(e_new, it_n, gave_up, stalled)
        return dict(v=v_n, y=y_n, zl=zl_n, zu=zu_n, mu=mu, nu=nu, it=it_n,
                    status=status, kkt=e_new, boost=boost, rej=rej, ev=ev_n,
                    fth=fth, fph=fph)

    def select(keep, new, old):
        if isinstance(new, dict):
            return {k: select(keep, new[k], old[k]) for k in new}
        if isinstance(new, tuple):
            return tuple(select(keep, a, b) for a, b in zip(new, old))
        return torch.where(_lv(keep, new), new, old)

    def trip(s):
        new = body(s)
        new.update(ar.store({k: new[k] for k in ("v", "y", "zl", "zu")}))
        return select(s["status"] == RUNNING, new, s)

    if st["fixed_iterations"]:
        if not st["rti_freeze_ev"]:
            raise ValueError("the reference freezes finished scenarios")
        for _ in range(K_it):
            state = trip(state)
    else:
        while bool((state["status"] == RUNNING).any()):
            state = trip(state)
    status = torch.where(state["status"] == RUNNING, MAX_ITERATIONS,
                         state["status"]).to(torch.int32)
    return dict(x=state["v"][0], u=state["v"][1], y=state["y"],
                status=status, iterations=state["it"], kkt=state["kkt"],
                mu=state["mu"])
