"""Autodiff model front door.

PyTorch port of ``sip_optimal_control_tpu/model.py``.  The user supplies
costs, dynamics and constraints as per-scenario, per-stage torch functions;
``build_problem`` produces the stacked StageModelData tensors with
``torch.func`` (grad, jacfwd, hessian) mapped by ``torch.func.vmap`` over
the scenario batch and the stage axis together.

Semantics match the reference exactly (reference: types.hpp:46-65):
node terms depend only on the node state (+ theta); edge terms on the parent
state, the control (+ theta); the dynamics child-Jacobian is the fixed -I;
the dynamics residual is dyn(x_parent, u, theta) - x_child and the root row
residual is initial_state - x_root
(reference: sip_optimal_control.cpp:90-112).

The scenario batch is the leading axis of ``initial_state`` ([B, n]) and of
every tensor the problem's evaluators take and return.  Chains only, and
theta_dim = 0 only, so far.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap

from ._tree import tree_map
from .ops.kkt import ConstraintMasks, StageModelData
from .solver.sip import ModelEval, OCProblem, Primal, YVec, ZVec
from .types import Dimensions, Topology, chain_slices, compile_topology


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """User-facing problem description as stage functions of one scenario.

    Signatures (all optional except dynamics; i is the node/edge index as a
    0-dim tensor, so time-varying terms use ``torch.where`` on it):
      node_cost(x, theta, i)           -> scalar
      edge_cost(x_parent, u, theta, i) -> scalar
      dynamics(x_parent, u, theta, i)  -> x_child prediction [n]
      node_eq(x, theta, i)             -> [node_c_dim]   (== 0)
      node_ineq(x, theta, i)           -> [node_g_dim]   (<= 0)
      edge_eq(x_parent, u, theta, i)   -> [edge_c_dim]
      edge_ineq(x_parent, u, theta, i) -> [edge_g_dim]
    """

    dynamics: Callable
    node_cost: Optional[Callable] = None
    edge_cost: Optional[Callable] = None
    node_eq: Optional[Callable] = None
    node_ineq: Optional[Callable] = None
    edge_eq: Optional[Callable] = None
    edge_ineq: Optional[Callable] = None


def box_bounds(dims: Dimensions, x_lower=None, x_upper=None, u_lower=None,
               u_upper=None, theta_lower=None, theta_upper=None,
               dtype=torch.float64, device=None):
    """Primal bound containers shared by every scenario ([N, n], [E, m],
    [p]); None means unbounded.  Scalars or broadcastable values accepted.
    Padded (dead) entries are forced unbounded (reference keeps bounds in
    the flat primal layout, types.hpp:141-144)."""
    masks = ConstraintMasks.build(dims)
    N, E = dims.num_nodes, dims.num_edges
    n = max(dims.max_state_dim, 1)
    m = max(dims.max_control_dim, 1)

    def expand(val, shape, default, mask=None):
        arr = torch.broadcast_to(torch.as_tensor(
            default if val is None else val, dtype=dtype, device=device),
            shape).clone()
        if mask is not None:
            arr = torch.where(torch.as_tensor(mask, device=device), arr,
                              default)
        return arr

    inf = math.inf
    lower = Primal(x=expand(x_lower, (N, n), -inf, masks.state),
                   u=expand(u_lower, (E, m), -inf, masks.control),
                   theta=expand(theta_lower, (dims.theta_dim,), -inf))
    upper = Primal(x=expand(x_upper, (N, n), inf, masks.state),
                   u=expand(u_upper, (E, m), inf, masks.control),
                   theta=expand(theta_upper, (dims.theta_dim,), inf))
    return lower, upper


@functools.lru_cache(maxsize=8)
def _device_masks(dims: Dimensions, device: torch.device) -> ConstraintMasks:
    """Constraint masks on ``device``, built once per (dims, device) so that
    rebuilding a problem every MPC step copies nothing to the device."""
    return ConstraintMasks.build(dims).to(device)


def _map_stages(fn, stage_args, shared=()):
    """Apply a per-stage function over tensors [*L, S, ...] (all leading
    axes and the stage axis at once) with ``shared`` unmapped arguments
    appended; outputs come back as [*L, S, ...]."""
    lead = stage_args[0].shape[:-1]
    rows = math.prod(lead)
    flat = [a.reshape((rows,) + a.shape[len(lead):]) for a in stage_args]
    in_dims = (0,) * len(flat) + (None,) * len(shared)
    out = vmap(fn, in_dims=in_dims)(*flat, *shared)
    dtype = stage_args[0].dtype

    def unflatten(t):
        if t.dtype != dtype:
            raise TypeError(
                f"a stage function or its derivative returned {t.dtype} for "
                f"{dtype} inputs; under forward-mode AD a 0-dim tensor times "
                "a Python float gets a float64 tangent, so index states "
                "with 1-element slices (x[:1]) rather than scalars (x[0])")
        return t.reshape(lead + t.shape[1:])
    return tree_map(unflatten, out)


def build_problem(spec: ModelSpec, dims: Dimensions, topology: Topology,
                  initial_state, lower: Optional[Primal] = None,
                  upper: Optional[Primal] = None,
                  scale_dual=1.0, scale_equality=1.0, scale_bound=1.0,
                  init_mode: str = "constant",
                  hessian_mode: str = "exact") -> OCProblem:
    """Assemble an OCProblem for a batch of scenarios with autodiff
    derivative evaluation.  ``initial_state`` is [B, n] (or [n] for one
    scenario); its dtype and device are the problem's.

    Variable stage dimensions are handled by padding: the user's stage
    functions are written on max-dim padded tensors (dead input entries
    arrive as zeros; dead output rows are ignored), and every
    residual/Jacobian/Hessian row and column beyond a stage's declared
    dimension is masked out before the solver sees it.

    ``scale_dual`` / ``scale_equality`` / ``scale_bound`` are the
    convergence-test residual scalings: scalars, or per-element containers
    (Primal-shaped for dual/bound, YVec-shaped for equality) mirroring the
    reference's ResidualScaling arrays (reference: types.hpp:144-148).

    ``hessian_mode``: "exact" differentiates the full stage Lagrangian;
    "gauss_newton" keeps only the objective's Hessian blocks."""
    if dims.theta_dim:
        raise NotImplementedError("theta_dim > 0 is not ported yet")
    if hessian_mode not in ("exact", "gauss_newton"):
        raise ValueError(f"unknown hessian_mode {hessian_mode!r}")
    sched = compile_topology(topology)
    parent, child = chain_slices(sched)
    root = topology.root
    N, E = dims.num_nodes, dims.num_edges
    n = max(dims.max_state_dim, 1)
    m = max(dims.max_control_dim, 1)
    cn, ce = dims.max_node_c_dim, dims.max_edge_c_dim
    gn, ge = dims.max_node_g_dim, dims.max_edge_g_dim

    x0 = torch.as_tensor(initial_state)
    if x0.dim() == 1:
        x0 = x0[None]
    if x0.shape[-1] < n:                  # pad to max state dim
        x0 = torch.cat([x0, x0.new_zeros(x0.shape[:-1]
                                         + (n - x0.shape[-1],))], dim=-1)
    dtype, device = x0.dtype, x0.device
    batch = x0.shape[0]
    masks = _device_masks(dims, device)
    th = torch.zeros(0, dtype=dtype, device=device)
    node_ids = torch.arange(N, device=device)
    edge_ids = torch.arange(E, device=device)

    uniform = dims.is_uniform
    sm = masks.state.to(dtype)            # [N, n]
    cm = masks.control.to(dtype)          # [E, m]
    sm_child, sm_par = sm[child], sm[parent]
    ncm, ecm = masks.nc.to(dtype), masks.ec.to(dtype)
    ngm, egm = masks.ng.to(dtype), masks.eg.to(dtype)

    node_cost = spec.node_cost or (lambda x, th, i: (0.0 * x).sum())
    edge_cost = spec.edge_cost or (lambda x, u, th, i: (0.0 * u).sum())

    if lower is None or upper is None:
        default_lower, default_upper = box_bounds(dims, dtype=dtype,
                                                  device=device)
        lower = lower or default_lower
        upper = upper or default_upper

    def ids(idx, like):
        return idx.expand(like.shape[:-1])

    def node_map(fn, x, *extra):
        return _map_stages(fn, (x, ids(node_ids, x)) + extra, (th,))

    def edge_map(fn, xp, u, *extra):
        return _map_stages(fn, (xp, u, ids(edge_ids, u)) + extra, (th,))

    # per-stage functions with theta moved last (the unmapped argument)
    def node_fn(f):
        return lambda x, i, *rest: f(x, rest[-1], i, *rest[:-1])

    def edge_fn(f):
        return lambda xp, u, i, *rest: f(xp, u, rest[-1], i, *rest[:-1])

    def zeros(*shape, like):
        return like.new_zeros(like.shape[:-1] + shape)

    # ----- residual-only evaluation (line-search probes; the reference's
    # new_x=false path, sip_optimal_control.cpp:47-53).  Any leading axes.
    def eval_fcg(vars: Primal):
        x_par = vars.x[..., parent, :]
        f = (node_map(node_fn(node_cost), vars.x).sum(-1)
             + edge_map(edge_fn(edge_cost), x_par, vars.u).sum(-1))
        dyn_res = edge_map(edge_fn(spec.dynamics), x_par, vars.u) \
            - vars.x[..., child, :]
        nc = (node_map(node_fn(spec.node_eq), vars.x) if spec.node_eq
              else zeros(N, cn, like=vars.x[..., 0, :]))
        gnv = (node_map(node_fn(spec.node_ineq), vars.x) if spec.node_ineq
               else zeros(N, gn, like=vars.x[..., 0, :]))
        ec = (edge_map(edge_fn(spec.edge_eq), x_par, vars.u) if spec.edge_eq
              else zeros(E, ce, like=vars.x[..., 0, :]))
        gev = (edge_map(edge_fn(spec.edge_ineq), x_par, vars.u)
               if spec.edge_ineq else zeros(E, ge, like=vars.x[..., 0, :]))
        root_res = x0 - vars.x[..., root, :]
        if not uniform:
            dyn_res = dyn_res * sm_child
            root_res = root_res * sm[root]
            nc, ec, gnv, gev = nc * ncm, ec * ecm, gnv * ngm, gev * egm
        c_dyn = torch.cat([root_res[..., None, :], dyn_res], dim=-2)
        return f, YVec(dyn=c_dyn, nc=nc, ec=ec), ZVec(n=gnv, e=gev)

    # ----- stage Lagrangians (for Hessian blocks) -------------------------
    def node_lagrangian(x, th_, i, y_nc, z_n):
        out = node_cost(x, th_, i)
        if spec.node_eq:
            out = out + torch.dot(y_nc, spec.node_eq(x, th_, i))
        if spec.node_ineq:
            out = out + torch.dot(z_n, spec.node_ineq(x, th_, i))
        return out

    def edge_lagrangian(xp, u, th_, i, y_dyn_child, y_ec, z_e):
        out = edge_cost(xp, u, th_, i) + torch.dot(
            y_dyn_child, spec.dynamics(xp, u, th_, i))
        if spec.edge_eq:
            out = out + torch.dot(y_ec, spec.edge_eq(xp, u, th_, i))
        if spec.edge_ineq:
            out = out + torch.dot(z_e, spec.edge_ineq(xp, u, th_, i))
        return out

    if hessian_mode == "gauss_newton":
        node_hess = hessian(
            lambda x, th_, i, y_nc, z_n: node_cost(x, th_, i), argnums=0)
        edge_hess = hessian(
            lambda xp, u, th_, i, y_dyn, y_ec, z_e: edge_cost(xp, u, th_, i),
            argnums=(0, 1))
    else:
        node_hess = hessian(node_lagrangian, argnums=0)
        edge_hess = hessian(edge_lagrangian, argnums=(0, 1))

    def jac_node(f, x, rows):
        if f is None:
            return zeros(N, rows, n, like=x[..., 0, :])
        return node_map(node_fn(jacfwd(f, argnums=0)), x)

    def jac_edge(f, xp, u, rows):
        if f is None:
            return (zeros(E, rows, n, like=xp[..., 0, :]),
                    zeros(E, rows, m, like=xp[..., 0, :]))
        return edge_map(edge_fn(jacfwd(f, argnums=(0, 1))), xp, u)

    def eval_model(vars: Primal, y: YVec, z: ZVec) -> ModelEval:
        x_par = vars.x[:, parent]
        y_dyn_child = y.dyn[:, child]

        f, c, g = eval_fcg(vars)

        # first derivatives of the objective
        dnc = node_map(node_fn(grad(node_cost, argnums=0)), vars.x)
        dec = edge_map(edge_fn(grad(edge_cost, argnums=(0, 1))), x_par,
                       vars.u)
        grad_x = dnc.clone()
        grad_x[:, parent] += dec[0]
        grad_u = dec[1]
        if not uniform:
            grad_x, grad_u = grad_x * sm, grad_u * cm
        grad_p = Primal(x=grad_x, u=grad_u, theta=vars.theta.new_zeros(
            vars.theta.shape))

        # constraint Jacobians
        A, B = edge_map(edge_fn(jacfwd(spec.dynamics, argnums=(0, 1))),
                        x_par, vars.u)
        Jc_n = jac_node(spec.node_eq, vars.x, cn)
        Jg_n = jac_node(spec.node_ineq, vars.x, gn)
        Jc_e = jac_edge(spec.edge_eq, x_par, vars.u, ce)
        Jg_e = jac_edge(spec.edge_ineq, x_par, vars.u, ge)

        # Lagrangian Hessian blocks
        Hn = node_map(node_fn(node_hess), vars.x, y.nc, z.n)
        He = edge_map(edge_fn(edge_hess), x_par, vars.u, y_dyn_child, y.ec,
                      z.e)

        def p0(*shape):
            return vars.x.new_zeros((batch,) + shape + (0,))

        stage = StageModelData(
            f_node=vars.x.new_zeros(batch, N),
            f_edge=vars.x.new_zeros(batch, E),
            df_dx_node=dnc, df_dx_edge=dec[0], df_du=dec[1],
            dyn_res=c.dyn[:, child],
            A=A, B=B,
            c_node=c.nc, Jc_x_node=Jc_n,
            c_edge=c.ec, Jc_x_edge=Jc_e[0], Jc_u_edge=Jc_e[1],
            g_node=g.n, Jg_x_node=Jg_n,
            g_edge=g.e, Jg_x_edge=Jg_e[0], Jg_u_edge=Jg_e[1],
            Hxx_node=Hn, Hxx_edge=He[0][0], Hxu_edge=He[0][1],
            Huu_edge=He[1][1],
            df_dtheta_node=p0(N), df_dtheta_edge=p0(E),
            ddyn_dtheta=p0(E, n),
            Jc_th_node=p0(N, cn), Jc_th_edge=p0(E, ce),
            Jg_th_node=p0(N, gn), Jg_th_edge=p0(E, ge),
            Hxth_node=p0(N, n), Hxth_edge=p0(E, n), Huth_edge=p0(E, m),
            Hthth_node=p0(N, 0), Hthth_edge=p0(E, 0))

        if not uniform:
            # zero every derivative row/column beyond the stage's declared
            # dims, so the KKT operators and condensation see exactly the
            # reference's per-stage blocks
            def m2(a, r, c_):
                return a * r[..., :, None] * c_[..., None, :]
            stage = dataclasses.replace(
                stage,
                df_dx_node=stage.df_dx_node * sm,
                df_dx_edge=stage.df_dx_edge * sm_par,
                df_du=stage.df_du * cm,
                A=m2(stage.A, sm_child, sm_par),
                B=m2(stage.B, sm_child, cm),
                Jc_x_node=m2(stage.Jc_x_node, ncm, sm),
                Jc_x_edge=m2(stage.Jc_x_edge, ecm, sm_par),
                Jc_u_edge=m2(stage.Jc_u_edge, ecm, cm),
                Jg_x_node=m2(stage.Jg_x_node, ngm, sm),
                Jg_x_edge=m2(stage.Jg_x_edge, egm, sm_par),
                Jg_u_edge=m2(stage.Jg_u_edge, egm, cm),
                Hxx_node=m2(stage.Hxx_node, sm, sm),
                Hxx_edge=m2(stage.Hxx_edge, sm_par, sm_par),
                Hxu_edge=m2(stage.Hxu_edge, sm_par, cm),
                Huu_edge=m2(stage.Huu_edge, cm, cm))

        return ModelEval(f=f, grad=grad_p, c=c, g=g, stage=stage)

    # default primal init: constant trajectory at the initial state (cheap,
    # root-feasible) or an open-loop zero-control rollout
    x_init = x0[:, None, :].expand(batch, N, n)
    if init_mode == "rollout":
        xs, x_prev = [x0], x0
        zero_u = x0.new_zeros(batch, m)
        for e in range(E):
            x_prev = _map_stages(
                lambda x, u, i, th_: spec.dynamics(x, u, th_, i),
                (x_prev, zero_u, edge_ids[e].expand(batch)), (th,))
            xs.append(x_prev)
        x_init = torch.stack(xs, dim=1)
    default_init = Primal(x=x_init.contiguous(), u=x0.new_zeros(batch, E, m),
                          theta=x0.new_zeros(batch, 0))

    # fused_ls / fused_iter stay None: the fused line-search probe and the
    # whole-iteration kernels (ROADMAP Queue 2) are not ported yet.
    return OCProblem(dims=dims, sched=sched, masks=masks,
                     eval_model=eval_model, eval_fcg=eval_fcg,
                     lower=lower, upper=upper, scale_dual=scale_dual,
                     scale_equality=scale_equality, scale_bound=scale_bound,
                     default_init=default_init)
