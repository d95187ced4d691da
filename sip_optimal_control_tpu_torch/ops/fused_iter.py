"""Whole-iteration fusion for chain problems: four CUDA kernels per model.

Counterpart of ``sip_optimal_control_tpu/ops/fused_iter.py``.  The standard
interior-point trip evaluates the model through ``torch.func`` into
[B, T, n, n] stage blocks, condenses them and hands them to the Riccati
kernels; thousands of small launches per trip (PERF.md §5).  The fused
iteration keeps the blocks out of device memory: the user's stage functions
AND their derivatives run inside the kernels as straight-line code
(``ops/stage_codegen.py``), and the solver carries only O(n) vectors per
stage.

  ======================  ===============================================
  kernel                  replaces (JAX ops/fused_iter.py)
  ======================  ===============================================
  ``fused_factor``        ``_factor_kernel``: per backward step A, B
                          (jacfwd), node and edge Hessians (GN, or exact
                          with y at the child), condensation, Riccati edge
                          step with scalar delta (explicit W at n < 8, the
                          Gram form at n >= 8), V carried on chip
  ``fused_solve_bwd``     ``_solve_bwd_kernel``: backward vector pass, the
                          root solve at its last step
  ``fused_solve_fwd``     ``_solve_fwd_kernel``: forward rollout
  ``fused_eval``          ``_eval_kernel``: objective, cost gradients,
                          dynamics VJP, residuals, packed KKT reductions
  ======================  ===============================================

Every kernel has three implementations here, sharing one loop per kernel:
the CUDA kernel (``*_kernel``, a CUDA tensor), its plain PyTorch twin
(``*_reference``: the stage derivatives from ``torch.func``) and the codegen
route (``*_codegen``: the stage derivatives from the generated scalar
programs run with tensors, the CPU check of the kernels' arithmetic).
``factor_solve_reference`` and ``eval_reference`` are the ports of the JAX
package's ``_factor_solve_reference`` and ``_eval_reference``: the stage
blocks from ``torch.func`` through the chain LQR of ``ops/lqr.py``.

The terminal node is the kernels' own (JAX forms it outside its kernels):
the factor starts its carry from the generated node Hessian at stage T, the
eval evaluates node T and the root row; ``_terminal_q`` (torch.func) serves
the factor's plain twin only.  The eval kernel sums the objective in its
warp's order, which the codegen route reproduces (``lane_tree_sum``).  The
factor and both solve kernels run the recursion in one thread per scenario
at n < GRAM_N and in a team of lanes per scenario at n >= GRAM_N, up to
FUSED_MAX_DIM; at n >= GRAM_N the solves evaluate dyn_jac row by row
(``cuda_source`` emits ``Model::dyn_jac_row``).

Layout.  The iterate and the per-stage vectors stay in the port's
[B, stage, dim] layout and the kernels read them in place.  The factor
products go to device memory once, structure-of-arrays [T, rows, B]
(the scenario index contiguous, copied by consecutive threads), and
the two solve kernels read them there: nothing is transposed between
factor and solve.  At n >= 6 the symmetric V and the triangular F_chol are
stored lower-packed (n(n+1)/2 rows), at n >= 8 A and B are not stored but
recomputed in the solve kernels from (x, u) (JAX fused_iter.py:684-697).

Scope (checked by ``model.py``): the fused probe's (chain, uniform dims,
no theta, no constraint functions, stage-constant box bounds), float32,
n and m at most FUSED_MAX_DIM, and every derivative graph within the code
generator's rules.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, jvp, vmap

from ..types import FactorStatus
from . import cuda_build
from .linalg import cho_solve, cholesky_with_ok
from .lqr import LQRData, _factor_chain, _solve_chain
from .ls_probe import bounds_key, build_fused_spec
from .riccati_cuda import _gram_core
from .stage_codegen import (ScalarProgram, build_program, emit_cuda,
                            evaluate, restrict)

# the Gram-form edge step at n >= GRAM_N (as ops/riccati_cuda.py); V and
# F_chol lower-packed at n >= PACK_N (JAX fused_iter.py:693-697)
GRAM_N = 8
PACK_N = 6
# the largest n and m the fused kernels take: the factor's team of lanes per
# scenario holds at most a warp, and its shared memory a block's
# (csrc/fused_iter.cuh: FactorCfg)
FUSED_MAX_DIM = 32
# the eval kernel's lanes per scenario (csrc/fused_iter.cuh: kEvalLanes):
# the objective's summation order
EVAL_LANES = 32

KERNEL_NAMES = ("fused_factor", "fused_solve_bwd", "fused_solve_fwd",
                "fused_eval")
# Launches per kernel; each wrapper adds one where it launches its kernel.
launch_counts = {name: 0 for name in KERNEL_NAMES}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class FusedIterSpec(NamedTuple):
    """Static model payload: the stage functions and every derivative the
    kernels need as scalar programs (closure constants folded in), the
    original closures for the plain twins, and the shapes.  Programs with
    several results return them flattened and concatenated."""

    dyn: ScalarProgram         # (x, u, th, i) -> [n]
    ncost: ScalarProgram       # (x, th, i) -> []
    ecost: ScalarProgram       # (x, u, th, i) -> []
    dyn_jac: ScalarProgram     # (x, u, th, i) -> [A (n*n), B (n*m)]
    dyn_vjp: ScalarProgram     # (x, u, th, i, yc) -> [A^T yc (n), B^T yc (m)]
    ncost_grad: ScalarProgram  # (x, th, i) -> [n]
    ecost_grad: ScalarProgram  # (x, u, th, i) -> [n + m]
    nhess: ScalarProgram       # (x, th, i) -> [n*n]
    ehess: ScalarProgram       # (x, u, th, i[, yc]) -> [Hxx, Hxu, Huu]
    exact: bool                # ehess is the edge Lagrangian's, with yc
    dyn_orig: Callable
    ncost_orig: Callable
    ecost_orig: Callable
    horizon: int
    n: int
    m: int


# ---------------------------------------------------------------------------
# the spec: trace and lower every derivative (JAX fused_iter.py:99-154)
# ---------------------------------------------------------------------------

def _columns(fn, primals, basis):
    """d fn / d primals as [out, k]: jvp along the k unit directions of
    ``basis`` (a tuple of [k, ...] tangents, one per primal) under vmap.
    This is ``jacfwd`` with a constant basis: some PyTorch releases build
    jacfwd's basis with a data-dependent ``diagonal`` offset, which tracing
    rejects.  The direction axis comes out first and moves last after the
    vmap: ``out_dims=-1`` gives a zero tangent (a gradient that does not
    depend on the primals) a garbage shape."""
    return vmap(lambda *t: jvp(fn, primals, t)[1])(*basis).movedim(0, -1)


def _derivative_functions(dynamics, node_cost, edge_cost, exact, n, m,
                          dtype, device):
    """The derivative stage functions, each returning one flat tensor:
    forward-mode columns over constant unit tangents (closure constants the
    code generator folds to literals), reverse-mode gradients."""
    eye = torch.eye(n + m, dtype=dtype, device=device)
    basis_x = (eye[:n, :n].contiguous(),)
    basis_xu = (eye[:, :n].contiguous(), eye[:, n:].contiguous())

    def dyn_jac(x, u, th, i):
        J = _columns(lambda x_, u_: dynamics(x_, u_, th, i), (x, u),
                     basis_xu)
        return torch.cat([J[:, :n].reshape(-1), J[:, n:].reshape(-1)])

    def dyn_vjp(x, u, th, i, yc):
        ga, gb = grad(lambda x_, u_: torch.dot(yc, dynamics(x_, u_, th, i)),
                      argnums=(0, 1))(x, u)
        return torch.cat([ga, gb])

    def ncost_grad(x, th, i):
        return grad(node_cost)(x, th, i)

    def ecost_grad(x, u, th, i):
        return torch.cat(grad(edge_cost, argnums=(0, 1))(x, u, th, i))

    def nhess(x, th, i):
        return _columns(lambda x_: grad(node_cost)(x_, th, i), (x,),
                        basis_x).reshape(-1)

    def edge_blocks(lag, x, u):
        """[Hxx, Hxu, Huu] of ``lag(x, u)``, forward over reverse."""
        H = _columns(lambda x_, u_: torch.cat(grad(lag, argnums=(0, 1))(
            x_, u_)), (x, u), basis_xu)
        return torch.cat([H[:n, :n].reshape(-1), H[:n, n:].reshape(-1),
                          H[n:, n:].reshape(-1)])

    if exact:
        def ehess(x, u, th, i, yc):
            return edge_blocks(lambda x_, u_: edge_cost(x_, u_, th, i)
                               + torch.dot(yc, dynamics(x_, u_, th, i)), x, u)
    else:
        def ehess(x, u, th, i):
            return edge_blocks(lambda x_, u_: edge_cost(x_, u_, th, i), x, u)
    return dict(dyn_jac=dyn_jac, dyn_vjp=dyn_vjp, ncost_grad=ncost_grad,
                ecost_grad=ecost_grad, nhess=nhess, ehess=ehess)


def _program_inputs(name, exact, n, m):
    """(inputs, result size) of the derivative program ``name``."""
    edge = (("x", n), ("u", m), ("th", 0), ("i", None))
    node = (("x", n), ("th", 0), ("i", None))
    edge_y = edge + (("yc", n),)
    return dict(dyn_jac=(edge, n * n + n * m), dyn_vjp=(edge_y, n + m),
                ncost_grad=(node, n), ecost_grad=(edge, n + m),
                nhess=(node, n * n),
                ehess=(edge_y if exact else edge,
                       n * n + n * m + m * m))[name]


@functools.lru_cache(maxsize=64)
def _derivative_program(dynamics, node_cost, edge_cost, name, exact, n, m,
                        dtype, device):
    """One derivative program, or None outside the code generator; cached
    per program, so both Hessian modes share all but ``ehess``."""
    inputs, size = _program_inputs(name, exact, n, m)
    fn = _derivative_functions(dynamics, node_cost, edge_cost, exact, n, m,
                               dtype, device)[name]
    prog = build_program(fn, inputs, dtype, device)
    return None if prog is None or prog.out_shape != (size,) else prog


@functools.lru_cache(maxsize=16)
def build_fused_iter_spec(dynamics, node_cost, edge_cost, horizon: int,
                          n: int, m: int, hessian_mode: str,
                          dtype: torch.dtype = torch.float32,
                          device="cpu") -> Optional[FusedIterSpec]:
    """Trace and lower every stage function and derivative the kernels
    need; None when n or m exceeds FUSED_MAX_DIM, or when one cannot be
    traced or has an op the code generator does not lower (as
    ``ls_probe.build_fused_spec``).  Cached: a model rebuilt every MPC step
    traces once."""
    if max(n, m) > FUSED_MAX_DIM:
        return None
    base = build_fused_spec(dynamics, node_cost, edge_cost, horizon, n, m,
                            dtype, device)
    if base is None:
        return None
    exact = hessian_mode == "exact"
    progs = {}
    for name in ("dyn_jac", "dyn_vjp", "ncost_grad", "ecost_grad", "nhess",
                 "ehess"):
        prog = _derivative_program(dynamics, node_cost, edge_cost, name,
                                   exact and name == "ehess", n, m, dtype,
                                   device)
        if prog is None:
            return None
        progs[name] = prog
    return FusedIterSpec(dyn=base.dyn_prog, ncost=base.ncost_prog,
                         ecost=base.ecost_prog, **progs, exact=exact,
                         dyn_orig=dynamics, ncost_orig=node_cost,
                         ecost_orig=edge_cost, horizon=horizon, n=n, m=m)


def nsym(n: int) -> int:
    """Rows of a stored symmetric / triangular n x n block."""
    return n * (n + 1) // 2 if n >= PACK_N else n * n


class FusedFactor(NamedTuple):
    """The factor kernel's products, [T, rows, B] per edge e (rows
    lower-packed for V and F_chol at n >= PACK_N)."""

    vc: torch.Tensor               # V of the child node e + 1
    fc: torch.Tensor               # Cholesky of I + delta V_child
    k: torch.Tensor                # feedback gain K [m*n]
    g: torch.Tensor                # Cholesky of G [m*m]
    a: Optional[torch.Tensor]      # A [n*n] (n < GRAM_N), else None
    b: Optional[torch.Tensor]      # B [n*m] (n < GRAM_N), else None
    vroot: torch.Tensor            # [nsym, B]: V of the root node


class FusedSolveBwd(NamedTuple):
    """The backward pass's products: per edge k [T, m, B] and the child's
    v [T, n, B]; the root solve x_root, y_root [n, B]."""

    k: torch.Tensor
    v: torch.Tensor
    x_root: torch.Tensor
    y_root: torch.Tensor


# ---------------------------------------------------------------------------
# layout helpers: [B, S, r, c] <-> [S, rows, B], lower packing
# ---------------------------------------------------------------------------

def _tril_index(n: int, device):
    rows, cols = torch.tril_indices(n, n, device=device)
    return rows * n + cols           # row-major i*(i+1)/2 + j order


def _to_soa(mat: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """[B, S, r, c] -> [S, rows, B]; lower-packed when ``packed``."""
    flat = mat.reshape(mat.shape[0], mat.shape[1], -1)
    if packed:
        flat = flat[..., _tril_index(mat.shape[-1], mat.device)]
    return flat.permute(1, 2, 0).contiguous()


def _from_soa(t: torch.Tensor, r: int, c: int,
              packed: bool = False) -> torch.Tensor:
    """[S, rows, B] -> [B, S, r, c]; a packed block's upper triangle reads
    the lower one (JAX fused_iter.py::_mat_packed)."""
    flat = t.permute(2, 0, 1)
    if not packed:
        return flat.reshape(flat.shape[0], flat.shape[1], r, c)
    idx = torch.tensor([[max(i, j) * (max(i, j) + 1) // 2 + min(i, j)
                         for j in range(c)] for i in range(r)],
                       device=t.device)
    return flat[..., idx]


def _unpack_sym(t, n):
    return _from_soa(t, n, n, n >= PACK_N)


def _diag_rows(n: int, packed: bool):
    return ([i * (i + 3) // 2 for i in range(n)] if packed
            else [i * (n + 1) for i in range(n)])


# ---------------------------------------------------------------------------
# stage blocks: torch.func (plain twins) or the scalar programs (codegen)
# ---------------------------------------------------------------------------

def _per_stage(fn, args, ids, tail=()):
    """``fn(*args, th0, i, *tail)`` over the leading axes of ``ids``
    (batch, stage); nested tuples of results keep their structure."""
    lead = ids.shape
    rows = math.prod(lead)
    flat = [a.reshape((rows,) + a.shape[len(lead):])
            for a in (*args, ids, *tail)]
    th0 = args[0].new_zeros(0)
    k = len(args)
    out = vmap(lambda *a: fn(*a[:k], th0, a[k], *a[k + 1:]))(*flat)

    def unflat(t):
        if isinstance(t, torch.Tensor):
            return t.reshape(lead + t.shape[1:]).to(args[0].dtype)
        return type(t)(unflat(s) for s in t)
    return unflat(out)


def _stage_ids(x, count):
    return torch.arange(count, device=x.device).expand(x.shape[0], count)


class _AutodiffBlocks:
    """Stage derivatives of every edge at once through torch.func
    (JAX fused_iter.py::_stage_lqr_data)."""

    def __init__(self, spec: FusedIterSpec, x, u, y=None, hessians=True):
        T = spec.horizon
        self.spec, self.x = spec, x
        ids = _stage_ids(x, T)
        xp = x[:, :-1]
        self.A, self.B = _per_stage(
            jacfwd(spec.dyn_orig, argnums=(0, 1)), (xp, u), ids)
        if not hessians:
            return
        self.Hn = _per_stage(hessian(spec.ncost_orig), (x,),
                             _stage_ids(x, T + 1))
        if spec.exact:
            def elag(xv, uv, th, i, yv):
                return (spec.ecost_orig(xv, uv, th, i)
                        + torch.dot(yv, spec.dyn_orig(xv, uv, th, i)))
            He = _per_stage(hessian(elag, argnums=(0, 1)), (xp, u), ids,
                            (y[:, 1:],))
        else:
            He = _per_stage(hessian(spec.ecost_orig, argnums=(0, 1)),
                            (xp, u), ids)
        self.Hxx, self.Hxu, self.Huu = He[0][0], He[0][1], He[1][1]

    def jac(self, e):
        return self.A[:, e], self.B[:, e]

    def terminal_q(self, r1x):
        return _terminal_q(self.spec, self.x, r1x)

    def hess(self, e):
        return self.Hn[:, e], self.Hxx[:, e], self.Hxu[:, e], self.Huu[:, e]


class _CodegenBlocks:
    """Stage derivatives of one edge at a time through the generated
    programs (``stage_codegen.evaluate``), as the kernels compute them."""

    def __init__(self, spec: FusedIterSpec, x, u, y=None, hessians=True):
        self.spec, self.x, self.u, self.y = spec, x, u, y
        self.th0 = x.new_zeros(x.shape[0], 0)

    def _i(self, e):
        return torch.tensor(e, dtype=torch.int32, device=self.x.device)

    def terminal_q(self, r1x):
        """The carry's start as the factor kernel forms it: the generated
        node Hessian at stage T."""
        T, n = self.spec.horizon, self.spec.n
        hn = evaluate(self.spec.nhess, self.x[:, T], self.th0, self._i(T))
        return hn.reshape(-1, n, n) + torch.diag_embed(r1x[:, T])

    def jac(self, e):
        n, m = self.spec.n, self.spec.m
        ab = evaluate(self.spec.dyn_jac, self.x[:, e], self.u[:, e],
                      self.th0, self._i(e))
        return (ab[:, :n * n].reshape(-1, n, n),
                ab[:, n * n:].reshape(-1, n, m))

    def hess(self, e):
        s, n, m = self.spec, self.spec.n, self.spec.m
        xe, ue, i = self.x[:, e], self.u[:, e], self._i(e)
        hn = evaluate(s.nhess, xe, self.th0, i).reshape(-1, n, n)
        args = (xe, ue, self.th0, i) + ((self.y[:, e + 1],) if s.exact
                                        else ())
        he = evaluate(s.ehess, *args)
        return (hn, he[:, :n * n].reshape(-1, n, n),
                he[:, n * n:n * n + n * m].reshape(-1, n, m),
                he[:, n * n + n * m:].reshape(-1, m, m))


# ---------------------------------------------------------------------------
# the three factor/solve loops, in the kernels' order of operations
# ---------------------------------------------------------------------------

def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _terminal_q(spec: FusedIterSpec, x, r1x):
    """Q_mod[T] = d2 node_cost / dx2 at x_T + diag(r1x_T), the factor's
    carry init, from torch.func (JAX fused_iter.py:674-681; the plain twin's
    only: the kernel evaluates it as stage T of its node Hessian)."""
    T = spec.horizon
    Ti = torch.tensor(T, device=x.device)
    th0 = x.new_zeros(0)
    Hn = vmap(hessian(spec.ncost_orig), in_dims=(0, None, None))(
        x[:, T], th0, Ti).to(x.dtype)
    return Hn + torch.diag_embed(r1x[:, T])


def _factor_loop(spec: FusedIterSpec, blocks, x, u, y, r1x, r1u,
                 delta) -> FusedFactor:
    """The factor kernel's recursion (JAX fused_iter.py:255-354) over
    batched tensors."""
    T, n, m = spec.horizon, spec.n, spec.m
    d = delta[:, None, None]
    eye = _eye(n, x)
    V = blocks.terminal_q(r1x)
    outs = []
    for t in range(T):
        e = T - 1 - t
        A, Bm = blocks.jac(e)
        Hn, Hxx, Hxu, Huu = blocks.hess(e)
        Qp = Hn + Hxx + torch.diag_embed(r1x[:, e])
        R = Huu + torch.diag_embed(r1u[:, e])
        Lf, _ = cholesky_with_ok(d * V + eye)
        if n >= GRAM_N:
            sdi = torch.rsqrt(delta)[:, None].expand(-1, n)
            Lg, K, Vp = _gram_core(Lf, A, Bm, Hxu, R, Qp, sdi)
        else:
            W = (1.0 / d) * (eye - cho_solve(Lf, eye.expand_as(Lf)))
            Bt = Bm.transpose(-1, -2)
            Lg, _ = cholesky_with_ok(R + (Bt @ W) @ Bm)
            WA = W @ A
            H = Hxu.transpose(-1, -2) + Bt @ WA
            K = -cho_solve(Lg, H)
            Vp = Qp + (A.transpose(-1, -2) @ WA + K.transpose(-1, -2) @ H)
        outs.append((V, Lf, K, Lg, A, Bm))
        V = Vp
    vc, fc, K, G, A, Bm = (torch.stack(a[::-1], dim=1) for a in zip(*outs))
    pack = n >= PACK_N
    small = n < GRAM_N
    return FusedFactor(
        vc=_to_soa(vc, pack), fc=_to_soa(fc, pack), k=_to_soa(K),
        g=_to_soa(G), a=_to_soa(A) if small else None,
        b=_to_soa(Bm) if small else None,
        vroot=_to_soa(V[:, None], pack)[0])


def _stored_jac(fac: FusedFactor, n, m):
    A, Bm = _from_soa(fac.a, n, n), _from_soa(fac.b, n, m)
    return lambda e: (A[:, e], Bm[:, e])


def _solve_bwd_loop(spec: FusedIterSpec, jac, fac: FusedFactor, q, r, c,
                    delta) -> FusedSolveBwd:
    """The backward vector pass with the root solve at its last step (JAX
    fused_iter.py:361-435)."""
    T, n, m = spec.horizon, spec.n, spec.m
    d = delta[:, None]
    sdi = torch.rsqrt(delta)[:, None]
    Lf_all = _unpack_sym(fac.fc, n)
    Lg_all, K_all = _from_soa(fac.g, m, m), _from_soa(fac.k, m, n)
    v = q[:, T]
    ks, vs = [], []
    for t in range(T):
        e = T - 1 - t
        A, Bm = jac(e)
        fh = sdi * (d * v - c[:, e + 1])
        g = v - sdi * (fh - cho_solve(Lf_all[:, e], fh))
        h = r[:, e] + (Bm.transpose(-1, -2) @ g[..., None])[..., 0]
        k = -cho_solve(Lg_all[:, e], h)
        v_p = (q[:, e] + (A.transpose(-1, -2) @ g[..., None])[..., 0]
               + (K_all[:, e].transpose(-1, -2) @ h[..., None])[..., 0])
        ks.append(k)
        vs.append(v)
        v = v_p
    # root: x_0 = -(I + d V_0)^-1 (d v_0 - c_0), y_0 = v_0 + V_0 x_0
    Vr = _unpack_sym(fac.vroot[None], n)[:, 0]
    Lfr, _ = cholesky_with_ok(d[..., None] * Vr + _eye(n, Vr))
    xr = -cho_solve(Lfr, d * v - c[:, 0])
    yr = v + (Vr @ xr[..., None])[..., 0]
    return FusedSolveBwd(k=torch.stack(ks[::-1], 0).permute(0, 2, 1)
                         .contiguous(),
                         v=torch.stack(vs[::-1], 0).permute(0, 2, 1)
                         .contiguous(),
                         x_root=xr.t().contiguous(), y_root=yr.t().contiguous())


def _solve_fwd_loop(spec: FusedIterSpec, jac, fac: FusedFactor,
                    bwd: FusedSolveBwd, c, delta):
    """The forward rollout (JAX fused_iter.py:438-485).  Returns (dx
    [B, N, n], du [B, T, m], dy [B, N, n]), root rows included."""
    T, n, m = spec.horizon, spec.n, spec.m
    d = delta[:, None]
    sd = torch.sqrt(delta)[:, None]
    sdi = 1.0 / sd
    Lf_all, Vc_all = _unpack_sym(fac.fc, n), _unpack_sym(fac.vc, n)
    K_all = _from_soa(fac.k, m, n)
    kv, vv = bwd.k.permute(2, 0, 1), bwd.v.permute(2, 0, 1)
    x = bwd.x_root.t()
    xs, us, ys = [x], [], [bwd.y_root.t()]
    for e in range(T):
        A, Bm = jac(e)
        u = kv[:, e] + (K_all[:, e] @ x[..., None])[..., 0]
        rhs = (c[:, e + 1] - d * vv[:, e] + (A @ x[..., None])[..., 0]
               + (Bm @ u[..., None])[..., 0])
        x = sd * cho_solve(Lf_all[:, e], sdi * rhs)
        ys.append(vv[:, e] + (Vc_all[:, e] @ x[..., None])[..., 0])
        xs.append(x)
        us.append(u)
    return (torch.stack(xs, 1), torch.stack(us, 1), torch.stack(ys, 1))


def _statuses(spec: FusedIterSpec, fac: FusedFactor, x_root):
    """F failure where an F_chol diagonal is nonpositive or nonfinite, or
    x_root is nonfinite (a failed root Cholesky); G failure where only G
    fails (JAX fused_iter.py:747-793)."""
    n, m = spec.n, spec.m

    def diag_ok(t, rows):
        dg = t[:, rows]
        return (torch.isfinite(dg) & (dg > 0)).all(1).all(0)

    f_ok = diag_ok(fac.fc, _diag_rows(n, n >= PACK_N))
    g_ok = diag_ok(fac.g, _diag_rows(m, False))
    ok = f_ok & g_ok & torch.isfinite(x_root).all(0)
    status = torch.where(ok, int(FactorStatus.SUCCESS),
                         int(FactorStatus.F_FACTORIZATION_FAILURE))
    return torch.where(~ok & f_ok & ~g_ok,
                       int(FactorStatus.G_FACTORIZATION_FAILURE),
                       status).to(torch.int32)


# ---------------------------------------------------------------------------
# plain twins and the codegen route, kernel by kernel
# ---------------------------------------------------------------------------

def _jac_for(spec, blocks_cls, fac, x, u):
    if fac.a is not None:
        return _stored_jac(fac, spec.n, spec.m)
    return blocks_cls(spec, x, u, hessians=False).jac


def factor_reference(spec, x, u, y, r1x, r1u, delta) -> FusedFactor:
    """Plain twin of the factor kernel: the stage derivatives from
    torch.func."""
    return _factor_loop(spec, _AutodiffBlocks(spec, x, u, y), x, u, y, r1x,
                        r1u, delta)


def solve_bwd_reference(spec, fac, x, u, q, r, c, delta) -> FusedSolveBwd:
    """Plain twin of the backward-pass kernel (A, B from the factor's
    products at n < GRAM_N, else from torch.func at (x, u))."""
    return _solve_bwd_loop(spec, _jac_for(spec, _AutodiffBlocks, fac, x, u),
                           fac, q, r, c, delta)


def solve_fwd_reference(spec, fac, bwd, x, u, c, delta):
    """Plain twin of the forward-rollout kernel."""
    return _solve_fwd_loop(spec, _jac_for(spec, _AutodiffBlocks, fac, x, u),
                           fac, bwd, c, delta)


def _factor_solve_via(factor, bwd, fwd, spec, x, u, y, r1x, r1u, delta, q,
                      r, c):
    fac = factor(spec, x, u, y, r1x, r1u, delta)
    back = bwd(spec, fac, x, u, q, r, c, delta)
    dx, du, dy = fwd(spec, fac, back, x, u, c, delta)
    return dx, du, dy, _statuses(spec, fac, back.x_root)


def factor_solve_codegen(spec, x, u, y, r1x, r1u, delta, q, r, c):
    """What the three kernels compute, in their order of operations, with
    the stage derivatives from the generated programs: (dx, du, dy,
    status)."""
    blocks = _CodegenBlocks(spec, x, u, y)

    def factor(spec, x, u, y, r1x, r1u, delta):
        return _factor_loop(spec, blocks, x, u, y, r1x, r1u, delta)

    def bwd(spec, fac, x, u, q, r, c, delta):
        return _solve_bwd_loop(spec, _jac_for(spec, _CodegenBlocks, fac, x,
                                              u), fac, q, r, c, delta)

    def fwd(spec, fac, back, x, u, c, delta):
        return _solve_fwd_loop(spec, _jac_for(spec, _CodegenBlocks, fac, x,
                                              u), fac, back, c, delta)
    return _factor_solve_via(factor, bwd, fwd, spec, x, u, y, r1x, r1u,
                             delta, q, r, c)


def factor_solve_plain(spec, x, u, y, r1x, r1u, delta, q, r, c):
    """The three kernels' plain twins chained, with the kernels'
    statuses: (dx, du, dy, status)."""
    return _factor_solve_via(factor_reference, solve_bwd_reference,
                             solve_fwd_reference, spec, x, u, y, r1x, r1u,
                             delta, q, r, c)


def factor_solve_reference(spec, x, u, y, r1x, r1u, delta, q, r, c):
    """Port of the JAX package's ``_factor_solve_reference`` (:991-1035):
    condensed LQR data from torch.func, the chain factor and solve of
    ``ops/lqr.py``.  x, y, r1x, q, c [B, N, n], u, r1u, r [B, T, m], delta
    [B] (the uniform dual regularization).  Returns (dx, du, dy, status)."""
    T, n = spec.horizon, spec.n
    blk = _AutodiffBlocks(spec, x, u, y)
    Q = blk.Hn + torch.cat([blk.Hxx, torch.zeros_like(blk.Hn[:, :1])], 1)
    Q = Q + torch.diag_embed(r1x)
    R = blk.Huu + torch.diag_embed(r1u)
    dvec = delta[:, None, None].expand(-1, T + 1, n)
    data = LQRData(Q=Q, q=q, c=c, delta=dvec, A=blk.A, B=blk.B, M=blk.Hxu,
                   R=R, r=r)
    fact = _factor_chain(data)
    sol = _solve_chain(data, fact)
    return sol.x, sol.u, sol.y, fact.status


# ---------------------------------------------------------------------------
# kernel E: the per-edge evaluation
# ---------------------------------------------------------------------------

def _finite_terms(v, z, bnd, lower: bool):
    """(v - lb) z or (ub - v) z per entry j with a finite bound, [...]
    each."""
    out = []
    for j in range(v.shape[-1]):
        if np.isfinite(bnd[j]):
            dist = (v[..., j] - float(bnd[j])) if lower \
                else (float(bnd[j]) - v[..., j])
            out.append(dist * z[..., j])
    return out


def _lane_amax(t, floor=None):
    out = t.flatten(1).amax(-1)
    return out if floor is None else torch.clamp(out, min=floor)


def eval_reference(spec: FusedIterSpec, bounds, x, u, y, x0, zlx, zlu, zux,
                   zuu):
    """Port of the JAX package's ``_eval_reference`` (:931-988) over the
    batch.  x, y, zlx, zux [B, N, n]; u, zlu, zuu [B, T, m]; x0 [B, n].
    Returns (f [B], gx [B,N,n], gu [B,T,m], ctx [B,N,n], ctu [B,T,m],
    cdyn [B,N,n], res [B,6]) with res the packed KKT reductions [max|stat|,
    max|c|, min/max d*z (lower), min/max d*z (upper)]."""
    T = spec.horizon
    ids_e, ids_n = _stage_ids(x, T), _stage_ids(x, T + 1)
    xp, xc, yc = x[:, :-1], x[:, 1:], y[:, 1:]
    pred = _per_stage(spec.dyn_orig, (xp, u), ids_e)
    cdyn = torch.cat([(x0 - x[:, 0])[:, None], pred - xc], 1)
    f = (_per_stage(spec.ncost_orig, (x,), ids_n).sum(-1)
         + _per_stage(spec.ecost_orig, (xp, u), ids_e).sum(-1))
    gx = _per_stage(grad(spec.ncost_orig), (x,), ids_n)
    gex, gu = _per_stage(grad(spec.ecost_orig, argnums=(0, 1)), (xp, u),
                         ids_e)
    zero_row = torch.zeros_like(x[:, :1])
    gx = gx + torch.cat([gex, zero_row], 1)

    def vjp(xv, uv, th, i, yv):
        return grad(lambda a, b: torch.dot(yv, spec.dyn_orig(a, b, th, i)),
                    argnums=(0, 1))(xv, uv)
    aty, ctu = _per_stage(vjp, (xp, u), ids_e, (yc,))
    ctx = torch.cat([aty, zero_row], 1) - y
    return f, gx, gu, ctx, ctu, cdyn, _packed_res(
        bounds, x, u, gx, gu, ctx, ctu, cdyn, zlx, zlu, zux, zuu)


def _packed_res(bounds, x, u, gx, gu, ctx, ctu, cdyn, zlx, zlu, zux, zuu):
    """res [B, 6]: max |stat|, max |c|, min / max d*z over the finite lower
    bounds, min / max d*z over the finite upper ones (NaN propagates)."""
    lb_u, ub_u, lb_x, ub_x = bounds
    stat = torch.maximum(_lane_amax((gx + ctx + zux - zlx).abs(), 0.0),
                         _lane_amax((gu + ctu + zuu - zlu).abs(), 0.0))
    res = [stat, _lane_amax(cdyn.abs(), 0.0)]
    for lower, bx, bu, zx, zu in ((True, lb_x, lb_u, zlx, zlu),
                                  (False, ub_x, ub_u, zux, zuu)):
        mn = torch.full_like(stat, math.inf)
        mx = torch.full_like(stat, -math.inf)
        for t in (_finite_terms(x, zx, bx, lower)
                  + _finite_terms(u, zu, bu, lower)):
            mn = torch.minimum(mn, t.amin(-1))
            mx = torch.maximum(mx, t.amax(-1))
        res += [mn, mx]
    return torch.stack(res, -1)


def lane_tree_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum [B, K] over K in the eval kernel's order: lane j of a warp adds
    terms j, j + 32, ... in turn, then the lanes combine by an xor butterfly
    (every lane ends with the same value: a + b and b + a round alike)."""
    lanes = terms.new_zeros(terms.shape[0], EVAL_LANES)
    for k in range(terms.shape[1]):
        lanes[:, k % EVAL_LANES] = lanes[:, k % EVAL_LANES] + terms[:, k]
    idx = torch.arange(EVAL_LANES, device=terms.device)
    off = EVAL_LANES // 2
    while off >= 1:
        lanes = lanes + lanes[:, idx ^ off]
        off //= 2
    return lanes[:, 0]


def eval_codegen(spec: FusedIterSpec, bounds, x, u, y, x0, zlx, zlu, zux,
                 zuu):
    """What the eval kernel computes, with the stage functions from the
    generated programs over all nodes at once (node T and the root row
    included, as in the kernel) and the objective summed in the kernel's
    order (``lane_tree_sum``); the reductions are order-free.  Same contract
    as ``eval_reference``."""
    T, n = spec.horizon, spec.n
    th0 = x.new_zeros(x.shape[0], 1, 0)
    nodes = torch.arange(T + 1, dtype=torch.int32, device=x.device)
    edges = nodes[:T]
    xp, ue, yc = x[:, :-1], u, y[:, 1:]
    gxn = evaluate(spec.ncost_grad, x, th0, nodes)
    fn = evaluate(spec.ncost, x, th0, nodes)
    ge = evaluate(spec.ecost_grad, xp, ue, th0, edges)
    vj = evaluate(spec.dyn_vjp, xp, ue, th0, edges, yc)
    pred = evaluate(spec.dyn, xp, ue, th0, edges)
    fe = evaluate(spec.ecost, xp, ue, th0, edges)
    zero_row = torch.zeros_like(x[:, :1])
    gx = gxn + torch.cat([ge[..., :n], zero_row], 1)
    ctx = torch.cat([vj[..., :n], zero_row], 1) - y
    gu, ctu = ge[..., n:], vj[..., n:]
    cdyn = torch.cat([(x0 - x[:, 0])[:, None], pred - x[:, 1:]], 1)
    f = lane_tree_sum(torch.cat([fn[:, :T] + fe, fn[:, T:]], 1))
    return f, gx, gu, ctx, ctu, cdyn, _packed_res(
        bounds, x, u, gx, gu, ctx, ctu, cdyn, zlx, zlu, zux, zuu)


# ---------------------------------------------------------------------------
# the CUDA kernels: generated source, build, wrappers
# ---------------------------------------------------------------------------

def _c_float(v: float) -> str:
    return f"{float(v)!r}f"


def _call(prog: ScalarProgram, fn: str, out: str) -> str:
    """A call of the emitted program ``fn`` with the wrapper's argument
    names (the inputs in the program's order, th dropped)."""
    args = [name for name, size in prog.inputs if size is None or size > 0]
    return f"{fn}({', '.join(args + [out])});"


def _c_comp_terms(var, z, lo, hi):
    """The finite bounds' d*z terms of one stage's entries, folded into
    the min/max accumulators (JAX fused_iter.py:572-587)."""
    lines = []
    for j, (l, h) in enumerate(zip(lo, hi)):
        if math.isfinite(l):
            lines.append(f"    fold(cl_mn, cl_mx, ({var}[{j}] - "
                         f"({_c_float(l)})) * {z[0]}[{j}]);")
        if math.isfinite(h):
            lines.append(f"    fold(cu_mn, cu_mx, (({_c_float(h)}) - "
                         f"{var}[{j}]) * {z[1]}[{j}]);")
    return lines


@functools.lru_cache(maxsize=16)
def cuda_source(spec: FusedIterSpec, bounds: tuple) -> str:
    """The four kernels' source for one model: its stage programs and
    finite bounds baked in, ``csrc/fused_iter.cuh`` instantiated behind
    plain C entry points.  ``bounds`` as ``ls_probe.bounds_key`` gives
    it."""
    lb_u, ub_u, lb_x, ub_x = bounds
    progs = dict(dyn=spec.dyn, ncost=spec.ncost, ecost=spec.ecost,
                 dyn_jac=spec.dyn_jac, dyn_vjp=spec.dyn_vjp,
                 ncost_grad=spec.ncost_grad, ecost_grad=spec.ecost_grad,
                 nhess=spec.nhess, ehess=spec.ehess)
    lines = [
        "// Generated by sip_optimal_control_tpu_torch/ops/fused_iter.py "
        "from the",
        "// model's stage functions and their derivatives; see "
        "csrc/fused_iter.cuh."]
    lines += ['#include "fused_iter.cuh"', ""]
    lines += [emit_cuda(p, f"model_{name}") for name, p in progs.items()]
    n, m = spec.n, spec.m
    # n >= GRAM_N: dyn_jac row by row (row r of A and of B), so that the
    # solve kernels' warps share a stage's evaluation
    rows = ([[r * n + j for j in range(n)]
             + [n * n + r * m + j for j in range(m)] for r in range(n)]
            if n >= GRAM_N else [])
    row_progs = [restrict(spec.dyn_jac, idx) for idx in rows]
    lines += [emit_cuda(p, f"model_dyn_jac_row{r}", out_index=idx)
              for r, (p, idx) in enumerate(zip(row_progs, rows))]

    def method(name, params, ret="void"):
        body = (f"    float out; {_call(progs[name], f'model_{name}', '&out')}"
                " return out;" if ret == "float"
                else f"    {_call(progs[name], f'model_{name}', 'out')}")
        return [f"  static __device__ __forceinline__ {ret} {name}("
                f"{params}) {{", body, "  }"]

    def comp(name, var, z, lo, hi):
        return [
            f"  static __device__ __forceinline__ void {name}(",
            f"      const float* {var}, const float* {z[0]}, "
            f"const float* {z[1]},",
            "      float& cl_mn, float& cl_mx, float& cu_mn, float& cu_mx) {",
            "    using fused_iter::fold;",
            *_c_comp_terms(var, z, lo, hi),
            "  }"]

    X, U, I, Y = ("const float* x", "const float* u", "int i",
                  "const float* yc")
    lines += [
        "struct Model {",
        f"  static constexpr int T = {spec.horizon}, N = {spec.n}, "
        f"M = {spec.m};",
        f"  static constexpr bool kExact = {str(spec.exact).lower()};",
        *method("dyn", f"{X}, {U}, {I}, float* out"),
        *method("ncost", f"{X}, {I}", "float"),
        *method("ecost", f"{X}, {U}, {I}", "float"),
        *method("dyn_jac", f"{X}, {U}, {I}, float* out"),
        # rows r of A and B into their places of dyn_jac's out (n >= GRAM_N)
        f"  static __device__ __forceinline__ void dyn_jac_row(int r, {X}, "
        f"{U}, {I}, float* out) {{",
        "    switch (r) {",
        *[f"      case {r}: {_call(p, f'model_dyn_jac_row{r}', 'out')} break;"
          for r, p in enumerate(row_progs)],
        "    }",
        "  }",
        *method("dyn_vjp", f"{X}, {U}, {I}, {Y}, float* out"),
        *method("ncost_grad", f"{X}, {I}, float* out"),
        *method("ecost_grad", f"{X}, {U}, {I}, float* out"),
        *method("nhess", f"{X}, {I}, float* out"),
        # yc is unused (and not read) in the Gauss-Newton form
        *method("ehess", f"{X}, {U}, {I}, {Y}, float* out"),
        "  // d*z of the finite bounds of a node's x and an edge's u, into",
        "  // the lower / upper min-max accumulators",
        *comp("node_comp", "x", ("zlx", "zux"), lb_x, ub_x),
        *comp("edge_comp", "u", ("zlu", "zuu"), lb_u, ub_u),
        "};",
        "",
        'extern "C" {',
        "int fused_factor_f32(int B, const float* x, const float* u,",
        "                     const float* y, const float* r1x,",
        "                     const float* r1u, const float* delta,",
        "                     float* vc, float* fc, float* k, float* g,",
        "                     float* a, float* b, float* vroot,",
        "                     void* stream) {",
        "  return fused_iter::launch_factor<Model>(B, x, u, y, r1x, r1u,",
        "      delta, vc, fc, k, g, a, b, vroot, stream);",
        "}",
        "int fused_solve_bwd_f32(int B, const float* q, const float* c,",
        "                        const float* r, const float* delta,",
        "                        const float* vroot, const float* fc,",
        "                        const float* g, const float* k,",
        "                        const float* a, const float* b,",
        "                        const float* x, const float* u,",
        "                        float* k_out, float* v_out, float* xr,",
        "                        float* yr, void* stream) {",
        "  return fused_iter::launch_solve_bwd<Model>(B, q, c, r, delta,",
        "      vroot, fc, g, k, a, b, x, u, k_out, v_out, xr, yr, stream);",
        "}",
        "int fused_solve_fwd_f32(int B, const float* xr, const float* yr,",
        "                        const float* kv, const float* k,",
        "                        const float* a, const float* b,",
        "                        const float* x, const float* u,",
        "                        const float* c, const float* delta,",
        "                        const float* vv, const float* vc,",
        "                        const float* fc, float* du, float* dx,",
        "                        float* dy, void* stream) {",
        "  return fused_iter::launch_solve_fwd<Model>(B, xr, yr, kv, k, a, b,",
        "      x, u, c, delta, vv, vc, fc, du, dx, dy, stream);",
        "}",
        "int fused_eval_f32(int B, const float* x, const float* u,",
        "                   const float* y, const float* x0,",
        "                   const float* zlx, const float* zlu,",
        "                   const float* zux, const float* zuu, float* gx,",
        "                   float* gu, float* ctx, float* ctu, float* cdyn,",
        "                   float* f, float* res, void* stream) {",
        "  return fused_iter::launch_eval<Model>(B, x, u, y, x0, zlx, zlu,",
        "      zux, zuu, gx, gu, ctx, ctu, cdyn, f, res, stream);",
        "}",
        "void fused_launch_config(int which, int B, int* out) {",
        "  fused_iter::launch_config<Model>(which, B, out);",
        "}",
        '}  // extern "C"',
        ""]
    return "\n".join(lines)


def build_library(spec: FusedIterSpec, bounds):
    """Compile the model's four kernels unless built.  Returns (path,
    seconds spent compiling)."""
    return cuda_build.build("fused_iter",
                            cuda_source(spec, bounds_key(bounds)),
                            ("fused_iter.cuh", "riccati_tiny.cuh",
                             "team.cuh"))


# pointer arguments of each entry point (all after the int B, before the
# stream)
_N_PTR = {"fused_factor": 13, "fused_solve_bwd": 16, "fused_solve_fwd": 16,
          "fused_eval": 15}


@functools.lru_cache(maxsize=None)
def _load(path: str):
    """The four entry points of the library at ``path``."""
    lib = ctypes.CDLL(path)
    out = {}
    for name, n_ptr in _N_PTR.items():
        fn = getattr(lib, f"{name}_f32")
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * (n_ptr + 1)
        fn.restype = ctypes.c_int
        out[name] = fn
    config = lib.fused_launch_config
    config.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    config.restype = None
    out["config"] = config
    return out


def _entries(spec: FusedIterSpec, bounds):
    """The model's kernel entry points, its library built at first use."""
    return _load(build_library(spec, bounds)[0])


def launch_config(entries, name: str, B: int) -> dict:
    """The launch configuration kernel ``name`` takes at batch B: grid and
    block size, dynamic shared memory bytes."""
    out = (ctypes.c_int * 3)()
    entries["config"](KERNEL_NAMES.index(name), B, ctypes.addressof(out))
    return dict(grid=out[0], block=out[1], smem=out[2])


def _check(tensors: dict, shapes: dict, device) -> None:
    """Every kernel operand: the expected shape, contiguous, float32 on
    the one CUDA device."""
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for name, t in tensors.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if t.device != device:
            raise ValueError(f"{name}: on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the fused kernels take float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")


def _iterate_shapes(spec, B):
    T, n, m = spec.horizon, spec.n, spec.m
    return dict(x=(B, T + 1, n), u=(B, T, m), y=(B, T + 1, n),
                r1x=(B, T + 1, n), r1u=(B, T, m), delta=(B,),
                q=(B, T + 1, n), c=(B, T + 1, n), r=(B, T, m),
                x0=(B, n), zlx=(B, T + 1, n), zux=(B, T + 1, n),
                zlu=(B, T, m), zuu=(B, T, m))


def _launch(name, fn, B, tensors, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(B, *[0 if t is None else t.data_ptr() for t in tensors],
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1


def _empty(shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def factor_kernel(spec, x, u, y, r1x, r1u, delta, entries=None,
                  bounds=None) -> FusedFactor:
    """Factor kernel wrapper (replaces JAX fused_iter.py::_factor_kernel);
    same contract as ``factor_reference``.  ``entries``: the model's entry
    points when the caller holds them, else built from ``bounds``."""
    T, n, m = spec.horizon, spec.n, spec.m
    B = x.shape[0]
    _check(dict(x=x, u=u, y=y, r1x=r1x, r1u=r1u, delta=delta),
           _iterate_shapes(spec, B), x.device)
    fns = entries or _entries(spec, bounds)
    s, small = nsym(n), n < GRAM_N
    fac = FusedFactor(
        vc=_empty((T, s, B), x), fc=_empty((T, s, B), x),
        k=_empty((T, m * n, B), x), g=_empty((T, m * m, B), x),
        a=_empty((T, n * n, B), x) if small else None,
        b=_empty((T, n * m, B), x) if small else None,
        vroot=_empty((s, B), x))
    _launch("fused_factor", fns["fused_factor"], B,
            (x, u, y, r1x, r1u, delta, *fac), x.device)
    return fac


def solve_bwd_kernel(spec, fac: FusedFactor, x, u, q, r, c, delta,
                     entries=None, bounds=None) -> FusedSolveBwd:
    """Backward-pass kernel wrapper (replaces JAX fused_iter.py::
    _solve_bwd_kernel); same contract as ``solve_bwd_reference``."""
    T, n, m = spec.horizon, spec.n, spec.m
    B = x.shape[0]
    _check(dict(x=x, u=u, q=q, r=r, c=c, delta=delta),
           _iterate_shapes(spec, B), x.device)
    fns = entries or _entries(spec, bounds)
    out = FusedSolveBwd(k=_empty((T, m, B), x), v=_empty((T, n, B), x),
                        x_root=_empty((n, B), x), y_root=_empty((n, B), x))
    _launch("fused_solve_bwd", fns["fused_solve_bwd"], B,
            (q, c, r, delta, fac.vroot, fac.fc, fac.g, fac.k, fac.a, fac.b,
             x, u, *out), x.device)
    return out


def solve_fwd_kernel(spec, fac: FusedFactor, bwd: FusedSolveBwd, x, u, c,
                     delta, entries=None, bounds=None):
    """Forward-rollout kernel wrapper (replaces JAX fused_iter.py::
    _solve_fwd_kernel); same contract as ``solve_fwd_reference``."""
    T, n, m = spec.horizon, spec.n, spec.m
    B = x.shape[0]
    _check(dict(x=x, u=u, c=c, delta=delta), _iterate_shapes(spec, B),
           x.device)
    fns = entries or _entries(spec, bounds)
    dx, du, dy = _empty((B, T + 1, n), x), _empty((B, T, m), x), \
        _empty((B, T + 1, n), x)
    _launch("fused_solve_fwd", fns["fused_solve_fwd"], B,
            (bwd.x_root, bwd.y_root, bwd.k, fac.k, fac.a, fac.b, x, u, c,
             delta, bwd.v, fac.vc, fac.fc, du, dx, dy), x.device)
    return dx, du, dy


def factor_solve_kernel(spec, x, u, y, r1x, r1u, delta, q, r, c,
                        entries=None, bounds=None):
    """The fused Newton step on the card: factor, backward pass with the
    root solve, statuses, forward rollout (JAX fused_iter.py:635-818).
    Returns (dx [B,N,n], du [B,T,m], dy [B,N,n], status [B])."""
    fns = entries or _entries(spec, bounds)
    fac = factor_kernel(spec, x, u, y, r1x, r1u, delta, fns)
    back = solve_bwd_kernel(spec, fac, x, u, q, r, c, delta, fns)
    dx, du, dy = solve_fwd_kernel(spec, fac, back, x, u, c, delta, fns)
    return dx, du, dy, _statuses(spec, fac, back.x_root)


def eval_kernel(spec, bounds, x, u, y, x0, zlx, zlu, zux, zuu,
                entries=None):
    """Eval kernel wrapper (replaces JAX fused_iter.py::_eval_kernel), the
    terminal node and the root row in the kernel; same contract as
    ``eval_reference``."""
    T, n, m = spec.horizon, spec.n, spec.m
    B = x.shape[0]
    _check(dict(x=x, u=u, y=y, x0=x0, zlx=zlx, zlu=zlu, zux=zux, zuu=zuu),
           _iterate_shapes(spec, B), x.device)
    fns = entries or _entries(spec, bounds)
    gx, ctx, cdyn = (_empty((B, T + 1, n), x) for _ in range(3))
    gu, ctu = _empty((B, T, m), x), _empty((B, T, m), x)
    f, res = _empty((B,), x), _empty((B, 6), x)
    _launch("fused_eval", fns["fused_eval"], B,
            (x, u, y, x0, zlx, zlu, zux, zuu, gx, gu, ctx, ctu, cdyn, f,
             res), x.device)
    return f, gx, gu, ctx, ctu, cdyn, res


# ---------------------------------------------------------------------------
# the entry points the solver calls
# ---------------------------------------------------------------------------

def make_fused_eval(spec: FusedIterSpec, bounds):
    """(x, u, y, x0, zlx, zlu, zux, zuu) -> (f, gx, gu, ctx, ctu, cdyn,
    res).  CPU tensors take the plain twin; CUDA tensors launch the kernel
    or raise (float32 only).  The entry points are looked up at the first
    CUDA call and kept."""
    entries = None

    def fused_eval(x, u, y, x0, zlx, zlu, zux, zuu):
        nonlocal entries
        if x.device.type == "cpu":
            return eval_reference(spec, bounds, x, u, y, x0, zlx, zlu, zux,
                                  zuu)
        if entries is None:
            _check(dict(x=x), _iterate_shapes(spec, x.shape[0]), x.device)
            entries = _entries(spec, bounds)
        return eval_kernel(spec, bounds, x, u, y, x0, zlx, zlu, zux, zuu,
                           entries)
    return fused_eval


def make_fused_factor_solve(spec: FusedIterSpec, bounds):
    """(x, u, y, r1x, r1u, delta, q, r, c) -> (dx, du, dy, status).  CPU
    tensors take the plain twin (``factor_solve_reference``); CUDA tensors
    launch the three kernels or raise."""
    entries = None

    def fused_factor_solve(x, u, y, r1x, r1u, delta, q, r, c):
        nonlocal entries
        if x.device.type == "cpu":
            return factor_solve_reference(spec, x, u, y, r1x, r1u, delta, q,
                                          r, c)
        if entries is None:
            _check(dict(x=x), _iterate_shapes(spec, x.shape[0]), x.device)
            entries = _entries(spec, bounds)
        return factor_solve_kernel(spec, x, u, y, r1x, r1u, delta, q, r, c,
                                   entries)
    return fused_factor_solve


# name -> (source, replaced TPU kernel)
_SOURCE = "sip_optimal_control_tpu_torch/csrc/fused_iter.cuh"
KERNELS = {
    "fused_factor": (_SOURCE, "sip_optimal_control_tpu/ops/fused_iter.py:255"),
    "fused_solve_bwd": (_SOURCE,
                        "sip_optimal_control_tpu/ops/fused_iter.py:361"),
    "fused_solve_fwd": (_SOURCE,
                        "sip_optimal_control_tpu/ops/fused_iter.py:438"),
    "fused_eval": (_SOURCE, "sip_optimal_control_tpu/ops/fused_iter.py:492"),
}
