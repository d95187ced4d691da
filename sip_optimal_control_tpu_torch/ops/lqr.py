"""Dual-regularized chain-LQR factor/solve — the flagship compute path.

PyTorch port of the chain part of ``sip_optimal_control_tpu/ops/lqr.py``
(reference: sip_optimal_control/lqr.cpp:473-871).  The exact linear system
(reference: tests/lqr_test.cpp:152-186):

  stationarity (node i):  Q_i x_i + sum_{e: parent(e)=i} M_e u_e - y_i
                          + sum_e A_e^T y_child(e) + q_i = 0
  stationarity (edge e):  M_e^T x_par + R_e u_e + B_e^T y_child + r_e = 0
  dynamics     (edge e):  A_e x_par + B_e u_e - x_child
                          - delta_child o y_child + c_child = 0
  root:                  -x_root - delta_root o y_root + c_root = 0

Factorization identities (reference: lqr.cpp:487-549):
  F = I + sqrt(delta) V sqrt(delta)            (Cholesky)
  W = (V^{-1} + delta)^{-1} = delta^{-1/2} (I - F^{-1}) delta^{-1/2}
  (I + delta V)^{-1} b = delta^{1/2} F^{-1} delta^{-1/2} b

Backward pass per edge (reference: lqr.cpp:689-719):
  G = R + B^T W B   (Cholesky), H = M^T + B^T W A, K = -G^{-1} H,
  V_parent += A^T W A + K^T H.

Layout: every tensor leads with the scenario batch axis, then the node or
edge axis ([B, N, n, n], [B, E, m, n], ...).  The horizon recursion is a
Python loop over stages, each step one batched op over all scenarios;
statuses are int32 tensors [B].  ``riccati_backend="cuda"`` runs the same
recursion in the hand-written kernels of ops/riccati_cuda.py.  Trees
(level-synchronous recursion) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..types import FactorStatus, TopologySchedule, chain_slices
from .linalg import cho_solve, cholesky_with_ok


@dataclasses.dataclass(frozen=True)
class LQRData:
    """Stacked chain-LQR problem data, scenario batch leading.

    Node-indexed (N = num_nodes): Q [B,N,n,n], q [B,N,n], c [B,N,n],
    delta [B,N,n].  Edge-indexed (E = num_edges): A [B,E,n,n] (child x
    parent), B [B,E,n,m], M [B,E,n,m] (parent-state x control), R [B,E,m,m],
    r [B,E,m].
    """

    Q: torch.Tensor
    q: torch.Tensor
    c: torch.Tensor
    delta: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    M: torch.Tensor
    R: torch.Tensor
    r: torch.Tensor


class LQRFactorization(NamedTuple):
    """Equivalent of LQR::Workspace's factor products
    (reference: lqr.hpp:109-127)."""

    V: torch.Tensor               # [B, N, n, n] cost-to-go
    F_chol: torch.Tensor          # [B, N, n, n] Cholesky of I + sd V sd
    sqrt_delta: torch.Tensor      # [B, N, n]
    sqrt_delta_inv: torch.Tensor  # [B, N, n]
    W: torch.Tensor               # [B, E, n, n]
    K: torch.Tensor               # [B, E, m, n] feedback gains
    G_chol: torch.Tensor          # [B, E, m, m]
    status: torch.Tensor          # [B] int32, FactorStatus


class LQRSolution(NamedTuple):
    """Equivalent of LQR::Output (reference: lqr.hpp:91-107)."""

    x: torch.Tensor   # [B, N, n] states
    u: torch.Tensor   # [B, E, m] controls
    y: torch.Tensor   # [B, N, n] costates


def _mv(a, b):
    return (a @ b[..., None])[..., 0]


def _tmv(a, b):
    return (a.transpose(-1, -2) @ b[..., None])[..., 0]


def _status(ok: torch.Tensor, failure: FactorStatus) -> torch.Tensor:
    return torch.where(ok, int(FactorStatus.SUCCESS),
                       int(failure)).to(torch.int32)


# ---------------------------------------------------------------------------
# per-stage building blocks
# ---------------------------------------------------------------------------

def _factor_F(delta, V):
    """F = I + sqrt(delta) V sqrt(delta), Cholesky + status
    (reference: lqr.cpp:487-509)."""
    delta_ok = torch.all(delta > 0, dim=-1)
    safe_delta = torch.where(delta > 0, delta, 1.0)
    sd = torch.sqrt(safe_delta)
    sdi = 1.0 / sd
    n = V.shape[-1]
    F = sd[..., :, None] * V * sd[..., None, :] + torch.eye(
        n, dtype=V.dtype, device=V.device)
    F_chol, chol_ok = cholesky_with_ok(F)
    status = torch.where(
        delta_ok,
        _status(chol_ok, FactorStatus.F_FACTORIZATION_FAILURE),
        int(FactorStatus.INVALID_DELTA)).to(torch.int32)
    return F_chol, sd, sdi, status


def _regularized_W(F_chol, sdi):
    """W = delta^{-1/2} (I - F^{-1}) delta^{-1/2}
    (reference: compute_regularized_W, lqr.cpp:511-529)."""
    n = F_chol.shape[-1]
    eye = torch.eye(n, dtype=F_chol.dtype, device=F_chol.device)
    F_inv = cho_solve(F_chol, eye.expand(F_chol.shape))
    return sdi[..., :, None] * (eye - F_inv) * sdi[..., None, :]


def _F_inv_apply(F_chol, sd, sdi, b):
    """(I + delta V)^{-1} b = sqrt(d) F^{-1} (b / sqrt(d))
    (reference: F_inv_mult_vector, lqr.cpp:531-549).  b: [..., n] or
    [..., n, k]."""
    if b.dim() == F_chol.dim():          # matrix rhs
        return sd[..., :, None] * cho_solve(F_chol, sdi[..., :, None] * b)
    return sd * cho_solve(F_chol, sdi * b)


def _edge_factor(W, A, B, M, R):
    """Backward-pass edge algebra (reference: lqr.cpp:689-719).

    Returns (G_chol, K, V_contrib, ok) where V_contrib = A^T W A + K^T H is
    the parent's cost-to-go increment.
    """
    Bt = B.transpose(-1, -2)
    BtW = Bt @ W                                 # [m, n_child]
    G = R + BtW @ B                              # [m, m]
    G_chol, ok = cholesky_with_ok(G)
    WA = W @ A                                   # [n_child, n_parent]
    H = M.transpose(-1, -2) + Bt @ WA            # [m, n_parent]
    K = -cho_solve(G_chol, H)                    # [m, n_parent]
    V_contrib = A.transpose(-1, -2) @ WA + K.transpose(-1, -2) @ H
    return G_chol, K, V_contrib, ok


def _edge_solve_backward(v_child, c_child, delta_child, W, G_chol, K, A, B,
                         r):
    """Backward vector pass per edge (reference: lqr.cpp:746-795).

    Returns (k, v_contrib) with u = k + K x_parent downstream.
    """
    f = delta_child * v_child - c_child
    g = v_child - _mv(W, f)
    h = r + _tmv(B, g)
    k = -cho_solve(G_chol, h)
    v_contrib = _tmv(A, g) + _tmv(K, h)
    return k, v_contrib


def _edge_solve_forward(x_parent, k, K, A, B, c_child, delta_child, v_child,
                        V_child, F_chol_child, sd_child, sdi_child):
    """Forward rollout per edge (reference: lqr.cpp:821-870)."""
    u = k + _mv(K, x_parent)
    rhs = c_child - delta_child * v_child + _mv(A, x_parent) + _mv(B, u)
    x_child = _F_inv_apply(F_chol_child, sd_child, sdi_child, rhs)
    y_child = v_child + _mv(V_child, x_child)
    return u, x_child, y_child


def _merge_status(first, second):
    """Keep the first non-SUCCESS status in processing order (the reference
    aborts at the first failure; we process everything and report the
    earliest)."""
    return torch.where(first != FactorStatus.SUCCESS, first, second)


# ---------------------------------------------------------------------------
# chain: Python loop over the horizon, batched over scenarios
# ---------------------------------------------------------------------------

def _factor_chain(data: LQRData) -> LQRFactorization:
    T_h = data.A.shape[1]          # horizon (num edges)

    terminal = _factor_F(data.delta[:, T_h], data.Q[:, T_h])
    F_chol_c, sd_c, sdi_c, status = terminal
    outs = []
    for e in range(T_h - 1, -1, -1):
        W = _regularized_W(F_chol_c, sdi_c)
        G_chol, K, V_contrib, g_ok = _edge_factor(
            W, data.A[:, e], data.B[:, e], data.M[:, e], data.R[:, e])
        V_i = data.Q[:, e] + V_contrib
        F_chol_c, sd_c, sdi_c, f_status = _factor_F(data.delta[:, e], V_i)
        step_status = _merge_status(
            _status(g_ok, FactorStatus.G_FACTORIZATION_FAILURE), f_status)
        status = _merge_status(status, step_status)
        outs.append((V_i, F_chol_c, sd_c, sdi_c, W, K, G_chol))
    outs.reverse()
    V, F_chol, sd, sdi, W, K, G_chol = (
        torch.stack(a, dim=1) for a in zip(*outs))
    return LQRFactorization(
        V=torch.cat([V, data.Q[:, T_h:]], dim=1),
        F_chol=torch.cat([F_chol, terminal[0][:, None]], dim=1),
        sqrt_delta=torch.cat([sd, terminal[1][:, None]], dim=1),
        sqrt_delta_inv=torch.cat([sdi, terminal[2][:, None]], dim=1),
        W=W, K=K, G_chol=G_chol, status=status)


def _solve_chain(data: LQRData, fact: LQRFactorization) -> LQRSolution:
    T_h = data.A.shape[1]

    v_child = data.q[:, T_h]
    ks, vs = [], []
    for e in range(T_h - 1, -1, -1):
        k_e, v_contrib = _edge_solve_backward(
            v_child, data.c[:, e + 1], data.delta[:, e + 1], fact.W[:, e],
            fact.G_chol[:, e], fact.K[:, e], data.A[:, e], data.B[:, e],
            data.r[:, e])
        v_child = data.q[:, e] + v_contrib
        ks.append(k_e)
        vs.append(v_child)
    k = torch.stack(ks[::-1], dim=1)
    v = torch.cat([torch.stack(vs[::-1], dim=1), data.q[:, T_h:]], dim=1)

    x_root, y_root = _solve_root(data, fact, v)
    x_p, us, xs, ys = x_root, [], [x_root], [y_root]
    for e in range(T_h):
        u_e, x_p, y_c = _edge_solve_forward(
            x_p, k[:, e], fact.K[:, e], data.A[:, e], data.B[:, e],
            data.c[:, e + 1], data.delta[:, e + 1], v[:, e + 1],
            fact.V[:, e + 1], fact.F_chol[:, e + 1],
            fact.sqrt_delta[:, e + 1], fact.sqrt_delta_inv[:, e + 1])
        us.append(u_e)
        xs.append(x_p)
        ys.append(y_c)
    return LQRSolution(x=torch.stack(xs, dim=1), u=torch.stack(us, dim=1),
                       y=torch.stack(ys, dim=1))


def _solve_root(data: LQRData, fact: LQRFactorization, v: torch.Tensor):
    """Root state and costate from the backward pass's v
    (reference: lqr.cpp:798-819)."""
    f_root = data.delta[:, 0] * v[:, 0] - data.c[:, 0]
    x_root = -_F_inv_apply(fact.F_chol[:, 0], fact.sqrt_delta[:, 0],
                           fact.sqrt_delta_inv[:, 0], f_root)
    y_root = v[:, 0] + _mv(fact.V[:, 0], x_root)
    return x_root, y_root


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _contiguous(data: LQRData) -> LQRData:
    """The kernel wrappers take contiguous tensors only (no copy when the
    tensors already are)."""
    return LQRData(**{f.name: getattr(data, f.name).contiguous()
                      for f in dataclasses.fields(data)})


def lqr_factor(data: LQRData, sched: TopologySchedule,
               backend: str = "scan") -> LQRFactorization:
    """Factor the dual-regularized chain-LQR KKT system of every scenario.

    Equivalent of LQR::factor_with_status (reference: lqr.cpp:645-731),
    with the per-scenario status returned as int32 data in ``fact.status``.

    ``backend``: "scan" runs the recursion above; "cuda" runs the
    hand-written kernel (ops/riccati_cuda.py), whose plain twin serves CPU
    tensors.  Both produce the same LQRFactorization products.
    """
    chain_slices(sched)
    if backend == "cuda":
        from .riccati_cuda import factor_chain_cuda
        return factor_chain_cuda(_contiguous(data))
    if backend != "scan":
        raise ValueError(f"unknown Riccati backend {backend!r}")
    return _factor_chain(data)


def lqr_solve(data: LQRData, fact: LQRFactorization,
              sched: TopologySchedule,
              backend: str = "scan") -> LQRSolution:
    """Solve given a factorization (reference: LQR::solve, lqr.cpp:735-871).

    Any solve backend consumes any backend's factorization (same
    products)."""
    chain_slices(sched)
    if backend == "cuda":
        from .riccati_cuda import solve_chain_cuda
        return solve_chain_cuda(_contiguous(data), LQRFactorization(
            *(t.contiguous() for t in fact)))
    if backend != "scan":
        raise ValueError(f"unknown Riccati backend {backend!r}")
    return _solve_chain(data, fact)


def lqr_factor_solve(data: LQRData, sched: TopologySchedule,
                     backend: str = "scan"
                     ) -> Tuple[LQRSolution, torch.Tensor]:
    fact = lqr_factor(data, sched, backend)
    sol = lqr_solve(data, fact, sched, backend)
    return sol, fact.status


def lqr_residual_norm(data: LQRData, sol: LQRSolution,
                      sched: TopologySchedule) -> torch.Tensor:
    """KKT residual of the regularized system per scenario [B] — the test
    oracle (reference: tests/lqr_test.cpp:152-186)."""
    parent, child = chain_slices(sched)
    root = sched.topology.root
    x_par = sol.x[:, parent]
    y_child = sol.y[:, child]

    # node stationarity: Q x - y + q + M u (into parent) + A^T y_child
    r_node = _mv(data.Q, sol.x) - sol.y + data.q
    r_node = torch.cat([r_node[:, parent] + _mv(data.M, sol.u)
                        + _tmv(data.A, y_child), r_node[:, parent.stop:]],
                       dim=1)
    r_edge = _tmv(data.M, x_par) + _mv(data.R, sol.u) \
        + _tmv(data.B, y_child) + data.r
    r_dyn = (_mv(data.A, x_par) + _mv(data.B, sol.u) - sol.x[:, child]
             - data.delta[:, child] * y_child + data.c[:, child])
    r_root = -sol.x[:, root] - data.delta[:, root] * sol.y[:, root] \
        + data.c[:, root]

    def sq(t):
        return (t ** 2).flatten(1).sum(-1)

    return torch.sqrt(sq(r_node) + sq(r_edge) + sq(r_dyn) + sq(r_root))