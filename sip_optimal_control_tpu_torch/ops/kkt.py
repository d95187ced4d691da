"""Newton-KKT condensation, multiplier recovery and KKT operators.

PyTorch port of ``sip_optimal_control_tpu/ops/kkt.py`` without the θ-Schur
path (theta_dim > 0 raises NotImplementedError).  The full regularized
Newton-KKT operator over (x, y, z) with regularizations (r1, r2, r3) and
barrier weights w (reference: helpers.cpp:953-977):

    K = [[ H + diag(r1),  C^T,        G^T        ],
         [ C,            -diag(r2),   0          ],
         [ G,             0,         -diag(w+r3) ]]

``kkt_factor`` eliminates the y_c and z rows into the stage Hessians
(condensation, reference: helpers.cpp:242-408):

    Q_mod = d2L/dx2 + diag(r1_x) + Jc^T diag(1/r2) Jc + Jg^T diag(1/(w+r3)) Jg
    R_mod, M_mod analogously; LQR delta = r2 of the dynamics rows,

leaving the chain-LQR system in (x, u, y_dyn).  Every tensor leads with the
scenario batch axis; masks and index sets are shared by all scenarios.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..types import Dimensions, FactorStatus, TopologySchedule, chain_slices
from .lqr import (LQRData, LQRFactorization, _mv, _tmv, lqr_factor,
                  lqr_solve)


@dataclasses.dataclass(frozen=True)
class StageModelData:
    """Stacked model derivatives, the SoA equivalent of ModelCallbackOutput
    (reference: types.hpp:48-126).  Node-indexed tensors are [B, N, ...],
    edge-indexed [B, E, ...]; constraint dims are padded to max and masked.

    Node terms depend only on the node state (+ theta); edge terms on the
    parent state, the control (+ theta).  The dynamics child-Jacobian is the
    fixed -I (reference: types.hpp:63-65).  The theta blocks exist with
    p = 0 (the θ-Schur path is not ported).
    """

    # objective
    f_node: torch.Tensor          # [B, N]
    f_edge: torch.Tensor          # [B, E]
    df_dx_node: torch.Tensor      # [B, N, n]
    df_dx_edge: torch.Tensor      # [B, E, n]   (w.r.t. parent state)
    df_du: torch.Tensor           # [B, E, m]
    # dynamics residual and Jacobians
    dyn_res: torch.Tensor         # [B, E, n]   dyn(x_par, u) - x_child
    A: torch.Tensor               # [B, E, n, n] ddyn_dx (child x parent)
    B: torch.Tensor               # [B, E, n, m] ddyn_du
    # equality constraints
    c_node: torch.Tensor          # [B, N, cn]
    Jc_x_node: torch.Tensor       # [B, N, cn, n]
    c_edge: torch.Tensor          # [B, E, ce]
    Jc_x_edge: torch.Tensor       # [B, E, ce, n]
    Jc_u_edge: torch.Tensor       # [B, E, ce, m]
    # inequality constraints
    g_node: torch.Tensor          # [B, N, gn]
    Jg_x_node: torch.Tensor       # [B, N, gn, n]
    g_edge: torch.Tensor          # [B, E, ge]
    Jg_x_edge: torch.Tensor       # [B, E, ge, n]
    Jg_u_edge: torch.Tensor       # [B, E, ge, m]
    # Lagrangian Hessian blocks
    Hxx_node: torch.Tensor        # [B, N, n, n]
    Hxx_edge: torch.Tensor        # [B, E, n, n]
    Hxu_edge: torch.Tensor        # [B, E, n, m]
    Huu_edge: torch.Tensor        # [B, E, m, m]
    # theta blocks ([..., p] with p = 0)
    df_dtheta_node: torch.Tensor  # [B, N, p]
    df_dtheta_edge: torch.Tensor  # [B, E, p]
    ddyn_dtheta: torch.Tensor     # [B, E, n, p]
    Jc_th_node: torch.Tensor      # [B, N, cn, p]
    Jc_th_edge: torch.Tensor      # [B, E, ce, p]
    Jg_th_node: torch.Tensor      # [B, N, gn, p]
    Jg_th_edge: torch.Tensor      # [B, E, ge, p]
    Hxth_node: torch.Tensor       # [B, N, n, p]
    Hxth_edge: torch.Tensor       # [B, E, n, p]
    Huth_edge: torch.Tensor       # [B, E, m, p]
    Hthth_node: torch.Tensor      # [B, N, p, p]
    Hthth_edge: torch.Tensor      # [B, E, p, p]


@dataclasses.dataclass(frozen=True)
class KKTVector:
    """A stagewise (x, y, z) KKT-space vector, batch leading."""

    x: torch.Tensor        # [B, N, n]   states
    u: torch.Tensor        # [B, E, m]   controls
    theta: torch.Tensor    # [B, p]
    y_dyn: torch.Tensor    # [B, N, n]   dynamics multipliers (root row at 0)
    y_nc: torch.Tensor     # [B, N, cn]  node equality multipliers
    y_ec: torch.Tensor     # [B, E, ce]  edge equality multipliers
    z_n: torch.Tensor      # [B, N, gn]  node inequality multipliers
    z_e: torch.Tensor      # [B, E, ge]  edge inequality multipliers

    def _zip(self, other, fn):
        return KKTVector(**{f.name: fn(getattr(self, f.name),
                                       getattr(other, f.name))
                            for f in dataclasses.fields(self)})

    def __add__(self, other):
        return self._zip(other, torch.add)

    def __sub__(self, other):
        return self._zip(other, torch.sub)

    def dot(self, other) -> torch.Tensor:
        """Per-scenario inner product [B]."""
        return sum((getattr(self, f.name) * getattr(other, f.name))
                   .flatten(1).sum(-1) for f in dataclasses.fields(self))

    def norm(self) -> torch.Tensor:
        return torch.sqrt(self.dot(self))


def zero_kkt_vector(dims: Dimensions, batch: int, dtype=torch.float64,
                    device=None) -> KKTVector:
    N, E = dims.num_nodes, dims.num_edges
    n = max(dims.max_state_dim, 1)
    m = max(dims.max_control_dim, 1)

    def z(*shape):
        return torch.zeros((batch,) + shape, dtype=dtype, device=device)

    return KKTVector(
        x=z(N, n), u=z(E, m), theta=z(dims.theta_dim), y_dyn=z(N, n),
        y_nc=z(N, dims.max_node_c_dim), y_ec=z(E, dims.max_edge_c_dim),
        z_n=z(N, dims.max_node_g_dim), z_e=z(E, dims.max_edge_g_dim))


def zero_like(v: KKTVector) -> KKTVector:
    return KKTVector(**{f.name: torch.zeros_like(getattr(v, f.name))
                        for f in dataclasses.fields(v)})


@dataclasses.dataclass(frozen=True)
class Regularizations:
    """The (w, r1, r2, r3) quadruple in stagewise layout
    (reference: factor() signature, helpers.hpp:11-12).

    w, r3 live on the z rows; r2 on the y rows (r2_dyn doubles as the LQR
    delta); r1 on the primal rows (incl. theta)."""

    w_n: torch.Tensor      # [B, N, gn]
    w_e: torch.Tensor      # [B, E, ge]
    r1_x: torch.Tensor     # [B, N, n]
    r1_u: torch.Tensor     # [B, E, m]
    r1_th: torch.Tensor    # [B, p]
    r2_dyn: torch.Tensor   # [B, N, n]
    r2_nc: torch.Tensor    # [B, N, cn]
    r2_ec: torch.Tensor    # [B, E, ce]
    r3_n: torch.Tensor     # [B, N, gn]
    r3_e: torch.Tensor     # [B, E, ge]


class KKTFactorization(NamedTuple):
    lqr_data: LQRData
    lqr_fact: LQRFactorization
    # cached weights
    nc_r2_inv: torch.Tensor       # [B, N, cn]
    ec_r2_inv: torch.Tensor       # [B, E, ce]
    n_w_inv: torch.Tensor         # [B, N, gn]
    e_w_inv: torch.Tensor         # [B, E, ge]
    status: torch.Tensor          # [B] int32


@dataclasses.dataclass(frozen=True)
class ConstraintMasks:
    """Masks for padded rows: NumPy from ``build``, tensors after ``to``."""

    nc: object   # [N, cn] bool
    ec: object   # [E, ce]
    ng: object   # [N, gn]
    eg: object   # [E, ge]
    state: object    # [N, n]
    control: object  # [E, m]

    @staticmethod
    def build(dims: Dimensions) -> "ConstraintMasks":
        def mk(sizes, width):
            out = np.zeros((len(sizes), width), dtype=bool)
            for i, d in enumerate(sizes):
                out[i, :d] = True
            return out
        return ConstraintMasks(
            nc=mk(dims.node_c_dims, dims.max_node_c_dim),
            ec=mk(dims.edge_c_dims, dims.max_edge_c_dim),
            ng=mk(dims.node_g_dims, dims.max_node_g_dim),
            eg=mk(dims.edge_g_dims, dims.max_edge_g_dim),
            state=mk(dims.state_dims, max(dims.max_state_dim, 1)),
            control=mk(dims.control_dims, max(dims.max_control_dim, 1)))

    def to(self, device) -> "ConstraintMasks":
        """The same masks as bool tensors on ``device`` (one host-to-device
        copy here, none in the operators that use them)."""
        return ConstraintMasks(**{
            f.name: torch.as_tensor(getattr(self, f.name), device=device)
            for f in dataclasses.fields(self)})


def _mask(m, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(m, device=like.device)


def _lane_all(t: torch.Tensor) -> torch.Tensor:
    """Per-scenario all() over every non-batch dim."""
    return torch.all(t.flatten(1), dim=-1)


def _safe_inv(v, mask):
    """1/v on live rows, 0 on padded rows; per-scenario validity requires
    v > 0 on live rows (reference: helpers.cpp:251-295)."""
    live = _mask(mask, v)
    safe = torch.where(live, v, 1.0)
    return (torch.where(live, 1.0 / safe, 0.0),
            _lane_all((v > 0) | ~live))


def _require_no_theta(model: StageModelData) -> None:
    if model.Hthth_node.shape[-1] != 0:
        raise NotImplementedError(
            "theta_dim > 0: the θ-Schur path is not ported yet")


def _add_into(node_arr: torch.Tensor, index, vals: torch.Tensor):
    """node_arr with ``vals`` added at node ``index`` (axis 1)."""
    out = node_arr.clone()
    out[:, index] += vals
    return out


def _wjj(J, winv):
    """J^T diag(winv) J over the leading axes."""
    return torch.einsum("...ki,...k,...kj->...ij", J, winv, J)


def _wjj2(Jx, Ju, winv):
    return torch.einsum("...ki,...k,...kj->...ij", Jx, winv, Ju)


def _mask_sym(Qm, mask):
    dead = 1.0 - mask
    return (Qm * mask[..., :, None] * mask[..., None, :]
            + torch.diag_embed(dead))


def kkt_factor(model: StageModelData, regs: Regularizations,
               masks: ConstraintMasks, sched: TopologySchedule,
               backend: str = "scan") -> KKTFactorization:
    """Condense + LQR-factor.  Reference: CallbackProvider::factor
    (helpers.cpp:242-408).  ``backend`` selects the chain Riccati
    implementation (see ops.lqr.lqr_factor)."""
    _require_no_theta(model)
    parent, child = chain_slices(sched)
    like = model.Hxx_node
    dtype = like.dtype

    nc_r2_inv, ok1 = _safe_inv(regs.r2_nc, masks.nc)
    ec_r2_inv, ok2 = _safe_inv(regs.r2_ec, masks.ec)
    n_w_inv, ok3 = _safe_inv(regs.w_n + regs.r3_n, masks.ng)
    e_w_inv, ok4 = _safe_inv(regs.w_e + regs.r3_e, masks.eg)
    state = _mask(masks.state, like)
    delta_ok = _lane_all((regs.r2_dyn > 0) | ~state)
    weights_ok = ok1 & ok2 & ok3 & ok4 & delta_ok

    sm = state.to(dtype)
    cm = _mask(masks.control, like).to(dtype)

    # --- node condensation (reference: helpers.cpp:297-316) ----------------
    Q_mod = (model.Hxx_node
             + torch.diag_embed(regs.r1_x * sm)
             + _wjj(model.Jc_x_node, nc_r2_inv)
             + _wjj(model.Jg_x_node, n_w_inv))

    # --- edge condensation (reference: helpers.cpp:318-354) ----------------
    Q_edge = (model.Hxx_edge
              + _wjj(model.Jc_x_edge, ec_r2_inv)
              + _wjj(model.Jg_x_edge, e_w_inv))
    Q_mod = _add_into(Q_mod, parent, Q_edge)

    M_mod = (model.Hxu_edge
             + _wjj2(model.Jc_x_edge, model.Jc_u_edge, ec_r2_inv)
             + _wjj2(model.Jg_x_edge, model.Jg_u_edge, e_w_inv))
    R_mod = (model.Huu_edge
             + torch.diag_embed(regs.r1_u * cm)
             + _wjj(model.Jc_u_edge, ec_r2_inv)
             + _wjj(model.Jg_u_edge, e_w_inv))

    # pad plan: unit diagonal on dead state/control rows keeps Cholesky valid
    Q_mod = _mask_sym(Q_mod, sm)
    R_mod = _mask_sym(R_mod, cm)
    child_sm = sm[child]
    parent_sm = sm[parent]
    A = model.A * child_sm[:, :, None] * parent_sm[:, None, :]
    B = model.B * child_sm[:, :, None] * cm[:, None, :]
    M_mod = M_mod * parent_sm[:, :, None] * cm[:, None, :]
    delta = regs.r2_dyn * sm + (1.0 - sm)

    lqr_data = LQRData(
        Q=Q_mod, q=torch.zeros_like(regs.r1_x), c=torch.zeros_like(regs.r1_x),
        delta=delta, A=A, B=B, M=M_mod, R=R_mod,
        r=torch.zeros_like(regs.r1_u))
    lqr_fact = lqr_factor(lqr_data, sched, backend)
    status = torch.where(weights_ok, lqr_fact.status,
                         int(FactorStatus.INVALID_DELTA)).to(torch.int32)
    return KKTFactorization(
        lqr_data=lqr_data, lqr_fact=lqr_fact,
        nc_r2_inv=nc_r2_inv, ec_r2_inv=ec_r2_inv,
        n_w_inv=n_w_inv, e_w_inv=e_w_inv, status=status)


def _solve_stagewise(fact: KKTFactorization, model: StageModelData,
                     b: KKTVector, sched: TopologySchedule,
                     backend: str = "scan") -> KKTVector:
    """Solve the stagewise KKT system for one RHS per scenario.

    Reference: solve_stagewise_kkt_matrix (helpers.cpp:414-894): condense the
    RHS into (q_mod, r_mod, c_mod), run the LQR solve, then recover the
    eliminated multipliers y_c = (J_c x_sol - b_yc)/r2 and
    z = (J_g x_sol - b_z)/(w+r3)."""
    parent, _ = chain_slices(sched)

    # RHS condensation (reference: helpers.cpp:752-812)
    wc_n = fact.nc_r2_inv * b.y_nc
    wg_n = fact.n_w_inv * b.z_n
    q_mod = -b.x - _tmv(model.Jc_x_node, wc_n) - _tmv(model.Jg_x_node, wg_n)
    wc_e = fact.ec_r2_inv * b.y_ec
    wg_e = fact.e_w_inv * b.z_e
    q_mod = _add_into(q_mod, parent, -_tmv(model.Jc_x_edge, wc_e)
                      - _tmv(model.Jg_x_edge, wg_e))
    r_mod = -b.u - _tmv(model.Jc_u_edge, wc_e) - _tmv(model.Jg_u_edge, wg_e)
    c_mod = -b.y_dyn

    data = dataclasses.replace(fact.lqr_data, q=q_mod, r=r_mod, c=c_mod)
    sol = lqr_solve(data, fact.lqr_fact, sched, backend)

    # multiplier recovery (reference: helpers.cpp:828-893)
    y_nc = fact.nc_r2_inv * (_mv(model.Jc_x_node, sol.x) - b.y_nc)
    z_n = fact.n_w_inv * (_mv(model.Jg_x_node, sol.x) - b.z_n)
    x_par = sol.x[:, parent]
    y_ec = fact.ec_r2_inv * (_mv(model.Jc_x_edge, x_par)
                             + _mv(model.Jc_u_edge, sol.u) - b.y_ec)
    z_e = fact.e_w_inv * (_mv(model.Jg_x_edge, x_par)
                          + _mv(model.Jg_u_edge, sol.u) - b.z_e)

    return KKTVector(x=sol.x, u=sol.u, theta=torch.zeros_like(b.theta),
                     y_dyn=sol.y, y_nc=y_nc, y_ec=y_ec, z_n=z_n, z_e=z_e)


def kkt_solve(fact: KKTFactorization, model: StageModelData, b: KKTVector,
              sched: TopologySchedule, backend: str = "scan") -> KKTVector:
    """Full KKT solve (reference: CallbackProvider::solve,
    helpers.cpp:896-951), θ-free."""
    _require_no_theta(model)
    return _solve_stagewise(fact, model, b, sched, backend)


# ---------------------------------------------------------------------------
# KKT matvec oracles (reference: helpers.cpp:953-1368) — used for residual
# checks, iterative refinement, and the round-trip test oracle.
# ---------------------------------------------------------------------------

def apply_H(model: StageModelData, v: KKTVector,
            sched: TopologySchedule) -> KKTVector:
    """y += H x on primal components (reference: add_Hx_to_y,
    helpers.cpp:979-1068)."""
    _require_no_theta(model)
    parent, _ = chain_slices(sched)
    x_par = v.x[:, parent]
    out_x = _add_into(_mv(model.Hxx_node, v.x), parent,
                      _mv(model.Hxx_edge, x_par) + _mv(model.Hxu_edge, v.u))
    out_u = _tmv(model.Hxu_edge, x_par) + _mv(model.Huu_edge, v.u)
    return dataclasses.replace(zero_like(v), x=out_x, u=out_u)


def apply_C(model: StageModelData, v: KKTVector,
            sched: TopologySchedule) -> KKTVector:
    """Equality-Jacobian product: rows (root, dynamics, node c, edge c)
    (reference: add_Cx_to_y, helpers.cpp:1070-1159)."""
    _require_no_theta(model)
    parent, child = chain_slices(sched)
    root = sched.topology.root
    x_par = v.x[:, parent]
    y_dyn = torch.cat([-v.x[:, root:root + 1],
                       _mv(model.A, x_par) + _mv(model.B, v.u)
                       - v.x[:, child]], dim=1)
    y_nc = _mv(model.Jc_x_node, v.x)
    y_ec = _mv(model.Jc_x_edge, x_par) + _mv(model.Jc_u_edge, v.u)
    return dataclasses.replace(zero_like(v), y_dyn=y_dyn, y_nc=y_nc,
                               y_ec=y_ec)


def apply_CT(model: StageModelData, v: KKTVector,
             sched: TopologySchedule) -> KKTVector:
    """Transpose equality product (reference: add_CTx_to_y,
    helpers.cpp:1161-1250)."""
    _require_no_theta(model)
    parent, child = chain_slices(sched)
    root = sched.topology.root
    dyn_child = v.y_dyn[:, child]

    out_x = _tmv(model.Jc_x_node, v.y_nc)
    out_x = _add_into(out_x, root, -v.y_dyn[:, root])
    out_x = _add_into(out_x, parent, _tmv(model.A, dyn_child)
                      + _tmv(model.Jc_x_edge, v.y_ec))
    out_x = _add_into(out_x, child, -dyn_child)
    out_u = _tmv(model.B, dyn_child) + _tmv(model.Jc_u_edge, v.y_ec)
    return dataclasses.replace(zero_like(v), x=out_x, u=out_u)


def apply_G(model: StageModelData, v: KKTVector,
            sched: TopologySchedule) -> KKTVector:
    """Inequality-Jacobian product (reference: add_Gx_to_y,
    helpers.cpp:1252-1309)."""
    _require_no_theta(model)
    parent, _ = chain_slices(sched)
    x_par = v.x[:, parent]
    z_n = _mv(model.Jg_x_node, v.x)
    z_e = _mv(model.Jg_x_edge, x_par) + _mv(model.Jg_u_edge, v.u)
    return dataclasses.replace(zero_like(v), z_n=z_n, z_e=z_e)


def apply_GT(model: StageModelData, v: KKTVector,
             sched: TopologySchedule) -> KKTVector:
    """Transpose inequality product (reference: add_GTx_to_y,
    helpers.cpp:1311-1368)."""
    _require_no_theta(model)
    parent, _ = chain_slices(sched)
    out_x = _add_into(_tmv(model.Jg_x_node, v.z_n), parent,
                      _tmv(model.Jg_x_edge, v.z_e))
    out_u = _tmv(model.Jg_u_edge, v.z_e)
    return dataclasses.replace(zero_like(v), x=out_x, u=out_u)


def apply_K(model: StageModelData, regs: Regularizations, v: KKTVector,
            sched: TopologySchedule) -> KKTVector:
    """The full regularized KKT operator (reference: add_Kx_to_y,
    helpers.cpp:953-977).  Defines the exact system kkt_solve solves."""
    h = apply_H(model, v, sched)
    c = apply_C(model, v, sched)
    ct = apply_CT(model, v, sched)
    g = apply_G(model, v, sched)
    gt = apply_GT(model, v, sched)
    return KKTVector(
        x=h.x + ct.x + gt.x + regs.r1_x * v.x,
        u=h.u + ct.u + gt.u + regs.r1_u * v.u,
        theta=h.theta + ct.theta + gt.theta + regs.r1_th * v.theta,
        y_dyn=c.y_dyn - regs.r2_dyn * v.y_dyn,
        y_nc=c.y_nc - regs.r2_nc * v.y_nc,
        y_ec=c.y_ec - regs.r2_ec * v.y_ec,
        z_n=g.z_n - (regs.w_n + regs.r3_n) * v.z_n,
        z_e=g.z_e - (regs.w_e + regs.r3_e) * v.z_e)
