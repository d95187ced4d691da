"""Hand-written Hopper kernels for the batched chain-Riccati factor/solve.

Counterpart of ``sip_optimal_control_tpu/ops/pallas_riccati.py``.  Three
CUDA kernels (``csrc/riccati.cu``) replace the three TPU kernels on the
chain path with n < 8:

  ============================  ===========================================
  wrapper                       replaces (pallas_riccati.py)
  ============================  ===========================================
  ``factor_kernel``             ``_factor_kernel`` (explicit-W factor)
  ``solve_bwd_kernel``          ``_solve_bwd_kernel`` (backward vector pass)
  ``solve_fwd_kernel``          ``_solve_fwd_kernel`` (forward rollout)
  ============================  ===========================================

Each wrapper takes and returns tensors in the port's public layout
([B, stage, rows, cols], scenario batch leading, equal to the JAX package's
batched layout) and has a plain PyTorch twin in this module that computes
the same thing (``*_reference``).  A CPU tensor takes the twin; a CUDA
tensor launches the kernel or raises — there is no fallback.  Around the
kernels, ``factor_chain_cuda`` and ``solve_chain_cuda`` reproduce the
wrapper semantics of ``_factor_chain_pallas_batched`` (pallas_riccati.py
:295-425: F_chol, sqrt(delta) and statuses recomputed from V after the
factor kernel) and ``_solve_chain_pallas_batched`` (:585-693: the root
solve between the two solve kernels).  ``factor_chain_reference`` and
``solve_chain_reference`` are the same chain-level functions built on the
twins.

The kernels are compiled with nvcc into a shared library with a plain C
interface at first use (``build_library``), keyed by a hash of the sources,
and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Tuple

import torch

from ..types import FactorStatus
from .linalg import cho_solve, cholesky_with_ok
from .lqr import (LQRData, LQRFactorization, LQRSolution, _factor_F,
                  _merge_status, _regularized_W, _solve_root)

# (n, m) shapes the library instantiates (csrc/riccati.cu, RICCATI_DISPATCH).
SUPPORTED_SHAPES = frozenset({(4, 1), (6, 2), (2, 1), (3, 1), (3, 2)})

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_SOURCES = ("riccati.cu", "riccati_tiny.cuh")
_BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")

# Launches per kernel; each wrapper adds one where it launches its kernel.
launch_counts = {"riccati_factor": 0, "riccati_solve_bwd": 0,
                 "riccati_solve_fwd": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def build_library() -> Tuple[str, float]:
    """Compile csrc/ into a shared library unless a build of the same
    sources exists.  Returns (path, seconds spent compiling)."""
    digest = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    out_dir = os.path.join(_BUILD_ROOT, digest.hexdigest()[:16])
    path = os.path.join(out_dir, "libriccati.so")
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp,
           os.path.join(_CSRC, "riccati.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path, time.perf_counter() - t0


def _library():
    global _lib
    if _lib is None:
        path, _ = build_library()
        lib = ctypes.CDLL(path)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, n_ptr in (("riccati_factor_f32", 10),
                            ("riccati_solve_bwd_f32", 11),
                            ("riccati_solve_fwd_f32", 13)):
            fn = getattr(lib, name)
            fn.argtypes = [i32] * 4 + [ptr] * n_ptr + [ptr]
            fn.restype = i32
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# launch plumbing: checks and the [B, S, ...] <-> [S, rows, B] layouts
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
            f"{sorted(SUPPORTED_SHAPES)} (the n >= 8 Gram-form kernel is not "
            "ported yet)")
    return True


def _soa(t: torch.Tensor) -> torch.Tensor:
    """[B, S, ...] -> [S, rows, B], scenario index contiguous."""
    return t.reshape(t.shape[0], t.shape[1], -1).permute(1, 2, 0).contiguous()


def _from_soa(t: torch.Tensor, tail) -> torch.Tensor:
    """[S, rows, B] -> contiguous [B, S, *tail]."""
    return t.permute(2, 0, 1).reshape(t.shape[2], t.shape[0],
                                      *tail).contiguous()


def _launch(name: str, fn, n, m, T, Bsz, args, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(n, m, T, Bsz, *[a.data_ptr() for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1


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


def factor_kernel(Q, delta, A, B, M, R):
    """Factor kernel wrapper (replaces pallas_riccati.py::_factor_kernel);
    same contract as ``factor_kernel_reference``."""
    Bsz, T_h, n, m = _dims(Q, R)
    _check(dict(Q=Q, delta=delta, A=A, B=B, M=M, R=R),
           dict(Q=(Bsz, T_h + 1, n, n), delta=(Bsz, T_h + 1, n),
                A=(Bsz, T_h, n, n), B=(Bsz, T_h, n, m),
                M=(Bsz, T_h, n, m), R=(Bsz, T_h, m, m)), Q.device)
    if not _route(Q.device, n, m):
        return factor_kernel_reference(Q, delta, A, B, M, R)
    ins = [_soa(t) for t in (Q, delta, A, B, M, R)]
    outs = [torch.empty((T_h, rows, Bsz), dtype=torch.float32,
                        device=Q.device)
            for rows in (n * n, n * n, m * n, m * m)]
    _launch("riccati_factor", _library().riccati_factor_f32, n, m, T_h, Bsz,
            ins + outs, Q.device)
    v_par, W, K, G = outs
    return (_from_soa(v_par, (n, n)), _from_soa(W, (n, n)),
            _from_soa(K, (m, n)), _from_soa(G, (m, m)))


def _finish_factor(data: LQRData, v_par, W, K, G_chol) -> LQRFactorization:
    """F products and statuses recomputed from V in one batched pass
    (pallas_riccati.py:395-418)."""
    V = torch.cat([v_par, data.Q[:, -1:]], dim=1)
    F_chol, sd, sdi, f_status = _factor_F(data.delta, V)
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


def factor_chain_reference(data: LQRData) -> LQRFactorization:
    """Chain factorization on the plain twin (the CPU route)."""
    return _finish_factor(data, *factor_kernel_reference(
        data.Q, data.delta, data.A, data.B, data.M, data.R))


def factor_chain_cuda(data: LQRData) -> LQRFactorization:
    """Chain factorization through the factor kernel."""
    return _finish_factor(data, *factor_kernel(
        data.Q, data.delta, data.A, data.B, data.M, data.R))


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
    ins = [_soa(t) for t in (q, r, c, delta, F_chol, G_chol, K, A, B)]
    outs = [torch.empty((T_h, rows, Bsz), dtype=torch.float32,
                        device=q.device) for rows in (m, n)]
    _launch("riccati_solve_bwd", _library().riccati_solve_bwd_f32, n, m, T_h,
            Bsz, ins + outs, q.device)
    return _from_soa(outs[0], (m,)), _from_soa(outs[1], (n,))


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
    ins = [x_root.t().contiguous()[None]] + [
        _soa(t) for t in (k, K, A, B, c, delta, v, V, F_chol)]
    outs = [torch.empty((T_h, rows, Bsz), dtype=torch.float32,
                        device=x_root.device) for rows in (m, n, n)]
    _launch("riccati_solve_fwd", _library().riccati_solve_fwd_f32, n, m, T_h,
            Bsz, ins + outs, x_root.device)
    return (_from_soa(outs[0], (m,)), _from_soa(outs[1], (n,)),
            _from_soa(outs[2], (n,)))


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
    "riccati_solve_bwd": (
        solve_bwd_kernel, solve_bwd_kernel_reference,
        "sip_optimal_control_tpu_torch/csrc/riccati.cu",
        "sip_optimal_control_tpu/ops/pallas_riccati.py:494"),
    "riccati_solve_fwd": (
        solve_fwd_kernel, solve_fwd_kernel_reference,
        "sip_optimal_control_tpu_torch/csrc/riccati.cu",
        "sip_optimal_control_tpu/ops/pallas_riccati.py:544"),
}
