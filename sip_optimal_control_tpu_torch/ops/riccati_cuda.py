"""Hand-written Hopper kernels for the batched chain-Riccati factor/solve.

Counterpart of ``sip_optimal_control_tpu/ops/pallas_riccati.py``.  Four
CUDA kernels (``csrc/riccati.cu``) replace the four TPU kernels of the chain
path:

  ============================  ===========================================
  wrapper                       replaces (pallas_riccati.py)
  ============================  ===========================================
  ``factor_kernel``             ``_factor_kernel`` (explicit-W factor, n < 8)
  ``factor_gram_kernel``        ``_factor_kernel_gram`` (Gram form, n >= 8)
  ``solve_bwd_kernel``          ``_solve_bwd_kernel`` (backward vector pass)
  ``solve_fwd_kernel``          ``_solve_fwd_kernel`` (forward rollout)
  ============================  ===========================================

Each wrapper takes and returns tensors in the port's public layout
([B, stage, rows, cols], scenario batch leading, equal to the JAX package's
batched layout), which the kernels read and write in place, and has a plain
PyTorch twin in this module that computes the same thing (``*_reference``).
A CPU tensor takes the twin; a CUDA tensor launches the kernel or raises —
there is no fallback.  Around the
kernels, ``factor_chain_cuda`` and ``solve_chain_cuda`` reproduce the
wrapper semantics of ``_factor_chain_pallas_batched`` (pallas_riccati.py
:295-425: the Gram form at n >= GRAM_N; F_chol, sqrt(delta), statuses and,
for the Gram form, W recomputed from V after the factor kernel) and ``_solve_chain_pallas_batched`` (:585-693: the root
solve between the two solve kernels).  ``factor_chain_reference`` and
``solve_chain_reference`` are the same chain-level functions built on the
twins.

The kernels are compiled with nvcc into a shared library with a plain C
interface at first use (``build_library``, ``ops/cuda_build.py``), keyed by
a hash of the sources, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..types import FactorStatus
from . import cuda_build
from .linalg import cho_solve, cholesky_with_ok, sym, tri_solve
from .lqr import (LQRData, LQRFactorization, LQRSolution, _factor_F,
                  _merge_status, _regularized_W, _solve_root)

# (n, m) shapes the library instantiates (csrc/riccati.cu, SMALL_SHAPES and
# GRAM_SHAPES); the factor takes the Gram form at n >= GRAM_N, as
# pallas_riccati.py:351 does.
SUPPORTED_SHAPES = frozenset({(4, 1), (6, 2), (2, 1), (3, 1), (3, 2),
                              (16, 4), (8, 3), (16, 5)})
GRAM_N = 8

# Launches per kernel; each wrapper adds one where it launches its kernel.
launch_counts = {"riccati_factor": 0, "riccati_factor_gram": 0,
                 "riccati_solve_bwd": 0, "riccati_solve_fwd": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def build_library() -> Tuple[str, float]:
    """Compile csrc/riccati.cu unless a build of the same sources exists.
    Returns (path, seconds spent compiling)."""
    return cuda_build.build_file("riccati", "riccati.cu",
                                 ("riccati_tiny.cuh", "team.cuh"))


def _library():
    global _lib
    if _lib is None:
        path, _ = build_library()
        lib = ctypes.CDLL(path)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, n_ptr in (("riccati_factor_f32", 10),
                            ("riccati_factor_gram_f32", 9),
                            ("riccati_solve_bwd_f32", 11),
                            ("riccati_solve_fwd_f32", 13)):
            fn = getattr(lib, name)
            fn.argtypes = [i32] * 4 + [ptr] * n_ptr + [ptr]
            fn.restype = i32
        lib.riccati_launch_config.argtypes = [i32] * 4 + [ptr]
        lib.riccati_launch_config.restype = None
        _lib = lib
    return _lib


# the kernels, in riccati_launch_config's order (all four of the team
# design: a team of lanes per scenario, one computing lane below GRAM_N)
TEAM_KERNELS = ("riccati_factor", "riccati_factor_gram", "riccati_solve_bwd",
                "riccati_solve_fwd")


def launch_config(lib, name: str, n: int, m: int, B: int) -> dict:
    """The launch configuration kernel ``name`` takes at (n, m) and batch B
    in the library ``lib``: grid and block size, dynamic shared memory
    bytes; zeros where the library has no such kernel (a factor at the
    other form's shapes)."""
    out = (ctypes.c_int * 3)()
    lib.riccati_launch_config(TEAM_KERNELS.index(name), n, m, B,
                              ctypes.addressof(out))
    return dict(grid=out[0], block=out[1], smem=out[2])


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

def _check(tensors, shapes, device) -> None:
    """Every kernel operand: the expected shape, contiguous, and for the
    kernels float32 on the one CUDA device."""
    for name, t in tensors.items():
        want = shapes[name]
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")
        if t.device != device:
            raise ValueError(f"{name}: on {t.device}, expected {device}")
        if device.type == "cuda" and t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernels take float32, "
                            f"got {t.dtype}")


def _dims(Q: torch.Tensor, R: torch.Tensor):
    Bsz, N, n = Q.shape[0], Q.shape[1], Q.shape[-1]
    m = R.shape[-1]
    return Bsz, N - 1, n, m


def _route(device: torch.device, n: int, m: int) -> bool:
    """True: launch the kernel; False: CPU tensors take the plain twin."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if (n, m) not in SUPPORTED_SHAPES:
        raise NotImplementedError(
            f"(n, m) = ({n}, {m}) has no CUDA Riccati kernel; instantiated: "
            f"{sorted(SUPPORTED_SHAPES)}")
    return True


def _launch(name: str, fn, n, m, T, Bsz, args, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(n, m, T, Bsz, *[a.data_ptr() for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1


def _run(name: str, n: int, m: int, T_h: int, ins, tails):
    """Launches kernel ``name`` on ``ins``; returns its float32 outputs,
    one [B, T_h, *tail] tensor per entry of ``tails``."""
    device, Bsz = ins[0].device, ins[0].shape[0]
    outs = [torch.empty((Bsz, T_h) + tail, dtype=torch.float32,
                        device=device) for tail in tails]
    _launch(name, getattr(_library(), name + "_f32"), n, m, T_h, Bsz,
            list(ins) + outs, device)
    return tuple(outs)


# ---------------------------------------------------------------------------
# kernel #1: factor (explicit W) — wrapper and plain twin
# ---------------------------------------------------------------------------

def factor_kernel_reference(Q, delta, A, B, M, R):
    """Plain twin of the factor kernel: the explicit-W backward recursion
    with per-row delta (delta <= 0 -> 1), carrying V of the child node.
    Returns (V_parent [B,T,n,n], W [B,T,n,n], K [B,T,m,n],
    G_chol [B,T,m,m]) per edge."""
    T_h = A.shape[1]
    Vc = Q[:, T_h]
    outs = []
    for e in range(T_h - 1, -1, -1):
        F_chol, _, sdi, _ = _factor_F(delta[:, e + 1], Vc)
        W = _regularized_W(F_chol, sdi)
        Bt = B[:, e].transpose(-1, -2)
        G = R[:, e] + (Bt @ W) @ B[:, e]
        G_chol, _ = cholesky_with_ok(G)
        WA = W @ A[:, e]
        H = M[:, e].transpose(-1, -2) + Bt @ WA
        K = -cho_solve(G_chol, H)
        Vc = Q[:, e] + (A[:, e].transpose(-1, -2) @ WA
                        + K.transpose(-1, -2) @ H)
        outs.append((Vc, W, K, G_chol))
    return tuple(torch.stack(a[::-1], dim=1) for a in zip(*outs))


def _check_factor(Q, delta, A, B, M, R):
    Bsz, T_h, n, m = _dims(Q, R)
    _check(dict(Q=Q, delta=delta, A=A, B=B, M=M, R=R),
           dict(Q=(Bsz, T_h + 1, n, n), delta=(Bsz, T_h + 1, n),
                A=(Bsz, T_h, n, n), B=(Bsz, T_h, n, m),
                M=(Bsz, T_h, n, m), R=(Bsz, T_h, m, m)), Q.device)
    return Bsz, T_h, n, m


def factor_kernel(Q, delta, A, B, M, R):
    """Factor kernel wrapper (replaces pallas_riccati.py::_factor_kernel);
    same contract as ``factor_kernel_reference``.  n < GRAM_N."""
    _, T_h, n, m = _check_factor(Q, delta, A, B, M, R)
    if n >= GRAM_N:
        raise NotImplementedError(f"n = {n} >= {GRAM_N} takes the Gram-form "
                                  "factor (factor_gram_kernel)")
    if not _route(Q.device, n, m):
        return factor_kernel_reference(Q, delta, A, B, M, R)
    return _run("riccati_factor", n, m, T_h, (Q, delta, A, B, M, R),
                ((n, n), (n, n), (m, n), (m, m)))


# ---------------------------------------------------------------------------
# kernel #2: factor (Gram form, n >= GRAM_N) — wrapper and plain twin
# ---------------------------------------------------------------------------

def _mirror_upper(a):
    """The upper triangle mirrored to the lower one, as the Gram kernel
    computes its symmetric outputs."""
    return torch.triu(a) + torch.triu(a, 1).transpose(-1, -2)


def _gram_core(Lf, A, B, M, R, Qp, sdi):
    """Plain twin of the Gram-form edge step (csrc/team.cuh::team_gram_step;
    pallas_riccati.py::_gram_core): returns (G_chol, K, V_parent)."""
    Ah = sdi[..., :, None] * A
    Bh = sdi[..., :, None] * B
    Za = tri_solve(Lf, Ah)
    Zb = tri_solve(Lf, Bh)
    BhT, ZbT = Bh.transpose(-1, -2), Zb.transpose(-1, -2)
    G = _mirror_upper(sym(R) + BhT @ Bh - ZbT @ Zb)
    G_chol, _ = cholesky_with_ok(G)
    H = M.transpose(-1, -2) + (BhT @ Ah - ZbT @ Za)
    K = -cho_solve(G_chol, H)
    Vp = _mirror_upper(sym(Qp) + Ah.transpose(-1, -2) @ Ah
                       - Za.transpose(-1, -2) @ Za
                       + K.transpose(-1, -2) @ H)
    return G_chol, K, Vp


def factor_gram_kernel_reference(Q, delta, A, B, M, R):
    """Plain twin of the Gram-form factor kernel: the backward recursion
    through _gram_core, carrying V of the child node.  Returns (V_parent
    [B,T,n,n], K [B,T,m,n], G_chol [B,T,m,m]) per edge."""
    T_h = A.shape[1]
    Vc = Q[:, T_h]
    outs = []
    for e in range(T_h - 1, -1, -1):
        F_chol, _, sdi, _ = _factor_F(delta[:, e + 1], Vc)
        G_chol, K, Vc = _gram_core(F_chol, A[:, e], B[:, e], M[:, e],
                                   R[:, e], Q[:, e], sdi)
        outs.append((Vc, K, G_chol))
    return tuple(torch.stack(a[::-1], dim=1) for a in zip(*outs))


def factor_gram_kernel(Q, delta, A, B, M, R):
    """Gram-form factor kernel wrapper (replaces
    pallas_riccati.py::_factor_kernel_gram); same contract as
    ``factor_gram_kernel_reference``.  n >= GRAM_N."""
    _, T_h, n, m = _check_factor(Q, delta, A, B, M, R)
    if n < GRAM_N:
        raise NotImplementedError(f"n = {n} < {GRAM_N} takes the explicit-W "
                                  "factor (factor_kernel)")
    if not _route(Q.device, n, m):
        return factor_gram_kernel_reference(Q, delta, A, B, M, R)
    return _run("riccati_factor_gram", n, m, T_h, (Q, delta, A, B, M, R),
                ((n, n), (m, n), (m, m)))


def _finish_factor(data: LQRData, v_par, W, K, G_chol) -> LQRFactorization:
    """F products and statuses recomputed from V in one batched pass
    (pallas_riccati.py:395-418); W too when the Gram form gave none."""
    V = torch.cat([v_par, data.Q[:, -1:]], dim=1)
    F_chol, sd, sdi, f_status = _factor_F(data.delta, V)
    if W is None:
        # edge e's W is its child node's (pallas_riccati.py:403-409)
        W = _regularized_W(F_chol, sdi)[:, 1:]
    g_diag = torch.diagonal(G_chol, dim1=-2, dim2=-1)
    g_ok = torch.all((torch.isfinite(g_diag) & (g_diag > 0)).flatten(1),
                     dim=-1)
    nan_fail = torch.any((~torch.isfinite(V)).flatten(1), dim=-1)
    status = _merge_status(
        torch.max(f_status, dim=-1).values,
        torch.where(g_ok & ~nan_fail, int(FactorStatus.SUCCESS),
                    int(FactorStatus.G_FACTORIZATION_FAILURE)
                    ).to(torch.int32))
    return LQRFactorization(V=V, F_chol=F_chol, sqrt_delta=sd,
                            sqrt_delta_inv=sdi, W=W, K=K, G_chol=G_chol,
                            status=status)


def _factor_chain_via(data: LQRData, explicit, gram) -> LQRFactorization:
    args = (data.Q, data.delta, data.A, data.B, data.M, data.R)
    if data.Q.shape[-1] >= GRAM_N:
        v_par, K, G_chol = gram(*args)
        return _finish_factor(data, v_par, None, K, G_chol)
    return _finish_factor(data, *explicit(*args))


def factor_chain_reference(data: LQRData) -> LQRFactorization:
    """Chain factorization on the plain twins (the CPU route)."""
    return _factor_chain_via(data, factor_kernel_reference,
                             factor_gram_kernel_reference)


def factor_chain_cuda(data: LQRData) -> LQRFactorization:
    """Chain factorization through the factor kernel of the shape's form."""
    return _factor_chain_via(data, factor_kernel, factor_gram_kernel)


# ---------------------------------------------------------------------------
# kernels #3 and #4: backward vector pass and forward rollout
# ---------------------------------------------------------------------------

def _safe_scalings(delta):
    sd = torch.sqrt(torch.where(delta > 0, delta, 1.0))
    return sd, 1.0 / sd


def solve_bwd_kernel_reference(q, r, c, delta, F_chol, G_chol, K, A, B):
    """Plain twin of the backward vector pass: W f from the child's F_chol
    by two triangular solves, carrying v of the child node.  Returns
    (k [B,T,m], v_parent [B,T,n]) per edge."""
    T_h = A.shape[1]
    v = q[:, T_h]
    ks, vs = [], []
    for e in range(T_h - 1, -1, -1):
        _, sdi = _safe_scalings(delta[:, e + 1])
        fh = sdi * (delta[:, e + 1] * v - c[:, e + 1])
        g = v - sdi * (fh - cho_solve(F_chol[:, e + 1], fh))
        h = r[:, e] + (B[:, e].transpose(-1, -2) @ g[..., None])[..., 0]
        k = -cho_solve(G_chol[:, e], h)
        v = q[:, e] + (A[:, e].transpose(-1, -2) @ g[..., None])[..., 0] \
            + (K[:, e].transpose(-1, -2) @ h[..., None])[..., 0]
        ks.append(k)
        vs.append(v)
    return torch.stack(ks[::-1], dim=1), torch.stack(vs[::-1], dim=1)


def solve_bwd_kernel(q, r, c, delta, F_chol, G_chol, K, A, B):
    """Backward-pass kernel wrapper (replaces
    pallas_riccati.py::_solve_bwd_kernel)."""
    Bsz, T_h, n, m = _dims(F_chol, G_chol)
    _check(dict(q=q, r=r, c=c, delta=delta, F_chol=F_chol, G_chol=G_chol,
                K=K, A=A, B=B),
           dict(q=(Bsz, T_h + 1, n), r=(Bsz, T_h, m), c=(Bsz, T_h + 1, n),
                delta=(Bsz, T_h + 1, n), F_chol=(Bsz, T_h + 1, n, n),
                G_chol=(Bsz, T_h, m, m), K=(Bsz, T_h, m, n),
                A=(Bsz, T_h, n, n), B=(Bsz, T_h, n, m)), q.device)
    if not _route(q.device, n, m):
        return solve_bwd_kernel_reference(q, r, c, delta, F_chol, G_chol, K,
                                          A, B)
    return _run("riccati_solve_bwd", n, m, T_h,
                (q, r, c, delta, F_chol, G_chol, K, A, B), ((m,), (n,)))


def solve_fwd_kernel_reference(x_root, k, K, A, B, c, delta, v, V, F_chol):
    """Plain twin of the forward rollout, carrying x of the parent node.
    Returns (u [B,T,m], x [B,T,n], y [B,T,n]) for edges / child nodes."""
    T_h = A.shape[1]
    x = x_root
    us, xs, ys = [], [], []
    for e in range(T_h):
        u = k[:, e] + (K[:, e] @ x[..., None])[..., 0]
        rhs = (c[:, e + 1] - delta[:, e + 1] * v[:, e + 1]
               + (A[:, e] @ x[..., None])[..., 0]
               + (B[:, e] @ u[..., None])[..., 0])
        sd, sdi = _safe_scalings(delta[:, e + 1])
        x = sd * cho_solve(F_chol[:, e + 1], sdi * rhs)
        y = v[:, e + 1] + (V[:, e + 1] @ x[..., None])[..., 0]
        us.append(u)
        xs.append(x)
        ys.append(y)
    return (torch.stack(us, dim=1), torch.stack(xs, dim=1),
            torch.stack(ys, dim=1))


def solve_fwd_kernel(x_root, k, K, A, B, c, delta, v, V, F_chol):
    """Forward-rollout kernel wrapper (replaces
    pallas_riccati.py::_solve_fwd_kernel)."""
    Bsz, T_h, n = F_chol.shape[0], F_chol.shape[1] - 1, F_chol.shape[-1]
    m = K.shape[2]
    _check(dict(x_root=x_root, k=k, K=K, A=A, B=B, c=c, delta=delta, v=v,
                V=V, F_chol=F_chol),
           dict(x_root=(Bsz, n), k=(Bsz, T_h, m), K=(Bsz, T_h, m, n),
                A=(Bsz, T_h, n, n), B=(Bsz, T_h, n, m),
                c=(Bsz, T_h + 1, n), delta=(Bsz, T_h + 1, n),
                v=(Bsz, T_h + 1, n), V=(Bsz, T_h + 1, n, n),
                F_chol=(Bsz, T_h + 1, n, n)), x_root.device)
    if not _route(x_root.device, n, m):
        return solve_fwd_kernel_reference(x_root, k, K, A, B, c, delta, v, V,
                                          F_chol)
    return _run("riccati_solve_fwd", n, m, T_h,
                (x_root, k, K, A, B, c, delta, v, V, F_chol),
                ((m,), (n,), (n,)))


def _solve_chain_via(data: LQRData, fact: LQRFactorization, bwd,
                 fwd) -> LQRSolution:
    """Backward pass, root solve between the two passes
    (pallas_riccati.py:662-666), forward rollout."""
    k, v_par = bwd(data.q, data.r, data.c, data.delta, fact.F_chol,
                   fact.G_chol, fact.K, data.A, data.B)
    v = torch.cat([v_par, data.q[:, -1:]], dim=1)
    x_root, y_root = _solve_root(data, fact, v)
    u, x, y = fwd(x_root, k, fact.K, data.A, data.B, data.c, data.delta, v,
                  fact.V, fact.F_chol)
    return LQRSolution(x=torch.cat([x_root[:, None], x], dim=1), u=u,
                       y=torch.cat([y_root[:, None], y], dim=1))


def solve_chain_reference(data: LQRData,
                          fact: LQRFactorization) -> LQRSolution:
    """Chain solve on the plain twins (the CPU route)."""
    return _solve_chain_via(data, fact, solve_bwd_kernel_reference,
                        solve_fwd_kernel_reference)


def solve_chain_cuda(data: LQRData, fact: LQRFactorization) -> LQRSolution:
    """Chain solve through the two solve kernels."""
    return _solve_chain_via(data, fact, solve_bwd_kernel, solve_fwd_kernel)


# name -> (wrapper, plain twin, source, replaced TPU kernel)
KERNELS = {
    "riccati_factor": (
        factor_kernel, factor_kernel_reference,
        "sip_optimal_control_tpu_torch/csrc/riccati.cu",
        "sip_optimal_control_tpu/ops/pallas_riccati.py:126"),
    "riccati_factor_gram": (
        factor_gram_kernel, factor_gram_kernel_reference,
        "sip_optimal_control_tpu_torch/csrc/riccati.cu",
        "sip_optimal_control_tpu/ops/pallas_riccati.py:241"),
    "riccati_solve_bwd": (
        solve_bwd_kernel, solve_bwd_kernel_reference,
        "sip_optimal_control_tpu_torch/csrc/riccati.cu",
        "sip_optimal_control_tpu/ops/pallas_riccati.py:494"),
    "riccati_solve_fwd": (
        solve_fwd_kernel, solve_fwd_kernel_reference,
        "sip_optimal_control_tpu_torch/csrc/riccati.cu",
        "sip_optimal_control_tpu/ops/pallas_riccati.py:544"),
}
