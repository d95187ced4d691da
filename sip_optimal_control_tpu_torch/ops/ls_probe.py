"""Fused line-search probe: a CUDA kernel per model, for chains and trees.

Counterpart of ``sip_optimal_control_tpu/ops/pallas_ls.py``.
The interior-point line search evaluates the merit function at ``chunk``
candidate step sizes per trip (the reference's ``new_x=false`` callback
path: objective and residuals, no derivatives).  The standard probe
(``solver/sip.py``) evaluates the whole [chunk, B, stage, ...] problem with
``torch.func`` — dozens of launches per trip.  This module replaces it with
one kernel launch (``csrc/ls_probe.cuh``; ``csrc/ls_probe_tree.cuh`` on
other trees) that runs the user's stage functions, compiled from their aten
graphs by ``ops/stage_codegen.py``, for every (scenario, candidate) pair
over the whole chain or tree.

  ===========================  =============================================
  function                     role
  ===========================  =============================================
  ``build_fused_spec``         trace + lower the stage functions (None when
                               ineligible), as pallas_ls.py:65-94
  ``probe_reference``          the plain twin: the port of
                               ``_probe_reference`` over the batch
  ``probe_codegen``            the kernel's arithmetic on the CPU, the
                               scalar programs through ``evaluate``, summed
                               over the stages in turn
  ``cuda_source``              the generated CUDA source of one model
  ``probe_kernel``             the kernel wrapper (one launch)
  ``build_fused_tree_spec``    the same for a tree: one program per node
                               cost, edge cost and edge dynamics with its
                               stage index baked (pallas_ls.py:118-160)
  ``probe_reference_tree``,    the tree's twin, its baked programs on the
  ``probe_codegen_tree``,      CPU (in the TPU kernel's order), its source
                               and its wrapper
  ``cuda_source_tree``,
  ``probe_tree_kernel``
  ``make_fused_probe``         CPU tensors -> twin, CUDA float32 -> kernel
  ``ls_prologue_reference``,   the fused trip's line-search prologue: its
  ``prologue_kernel``,         twin (the solver's PyTorch block), the
  ``ls_prologue``              wrapper of ``csrc/ls_prologue.cu`` and the
                               dispatch
  ===========================  =============================================

Scope (checked by ``model.py::fused_probe_model``): uniform dims, no theta,
no constraint functions, box bounds constant across stages (baked into the
kernel as literals).  Every function takes the iterate and direction as
x, dx [B, N, n], u, du [B, E, m] (a chain: N = T+1, E = T), the root's
initial state x0 [B, n] and the candidates alphas [B, chunk], and returns
(f, theta, logb), each [B, chunk].

The prologue (``ls_prologue``) is what the fused trip's line search needs
at the iterate before it probes: the step limits, the barrier merit, its
slope and the infeasibility, per scenario.  Its kernel does not depend on
the model: one library serves every model.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from .._tree import lane_view, tree_leaves, tree_map
from . import cuda_build
from .stage_codegen import ScalarProgram, build_program, emit_cuda, evaluate

_EPS = 1e-30

# Launches of the probe and prologue kernels; each wrapper adds one where
# it launches.
launch_counts = {"ls_probe": 0, "ls_probe_tree": 0, "ls_prologue": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class FusedLSSpec(NamedTuple):
    """Static model payload of the fused probe: the stage functions'
    scalar programs (closure constants folded in) for the kernel, the
    original closures for the plain twin, and the shapes."""

    dyn_prog: ScalarProgram      # (x, u, th, i) -> [n]
    ncost_prog: ScalarProgram    # (x, th, i) -> scalar
    ecost_prog: ScalarProgram    # (x, u, th, i) -> scalar
    dyn_orig: Callable
    ncost_orig: Callable
    ecost_orig: Callable
    horizon: int
    n: int
    m: int


@functools.lru_cache(maxsize=16)
def build_fused_spec(dynamics, node_cost, edge_cost, horizon: int, n: int,
                     m: int, dtype: torch.dtype = torch.float32,
                     device="cpu") -> Optional[FusedLSSpec]:
    """Trace each stage function at example inputs of ``dtype`` on
    ``device`` (the closure tensors' device) and lower it to a scalar
    program.  None when a function cannot be traced (data-dependent
    control flow) or uses an op without a lowering rule.  Cached: a model
    rebuilt every MPC step traces once."""
    edge = (("x", n), ("u", m), ("th", 0), ("i", None))
    node = (("x", n), ("th", 0), ("i", None))
    progs = (build_program(dynamics, edge, dtype, device),
             build_program(node_cost, node, dtype, device),
             build_program(edge_cost, edge, dtype, device))
    if any(p is None for p in progs):
        return None
    if (progs[0].out_shape != (n,) or progs[1].out_shape != ()
            or progs[2].out_shape != ()):
        return None
    return FusedLSSpec(*progs, dyn_orig=dynamics, ncost_orig=node_cost,
                       ecost_orig=edge_cost, horizon=horizon, n=n, m=m)


def bounds_key(bounds) -> tuple:
    """(lb_u, ub_u, lb_x, ub_x) as a hashable tuple of float tuples."""
    return tuple(tuple(float(v) for v in np.asarray(b).reshape(-1))
                 for b in bounds)


def _safe_log(d):
    return torch.where(d > 0, torch.log(torch.clamp(d, min=_EPS)),
                       -math.inf)


# ---------------------------------------------------------------------------
# the plain twin (pallas_ls.py:355-391, over the batch)
# ---------------------------------------------------------------------------

def _stagewise(fn, *args):
    """Apply a stage function over all leading axes of its arguments."""
    lead = args[0].shape[:-1]
    rows = math.prod(lead)
    flat = [a.reshape((rows,) + a.shape[len(lead):]) for a in args]
    th0 = flat[0].new_zeros(0)
    out = vmap(lambda *a: fn(*a[:-1], th0, a[-1]))(*flat)
    return out.reshape(lead + out.shape[1:])


def probe_reference(spec: FusedLSSpec, bounds, x, dx, u, du, x0, alphas):
    """Plain PyTorch probe with the original stage closures: the same
    outputs and the same math as the kernel, summed in another order."""
    lb_u, ub_u, lb_x, ub_x = bounds
    T = spec.horizon
    a = alphas[..., None, None]                      # [B, chunk, 1, 1]
    xa = x[:, None] + a * dx[:, None]                # [B, chunk, T+1, n]
    ua = u[:, None] + a * du[:, None]
    xp = xa[..., :-1, :]
    ids = torch.arange(T + 1, device=x.device).expand(xa.shape[:-1])
    pred = _stagewise(spec.dyn_orig, xp, ua, ids[..., :-1])
    th = ((pred - xa[..., 1:, :]).abs().sum((-1, -2))
          + (x0[:, None] - xa[..., 0, :]).abs().sum(-1))
    f = (_stagewise(spec.ncost_orig, xa, ids).sum(-1)
         + _stagewise(spec.ecost_orig, xp, ua, ids[..., :-1]).sum(-1))

    return f, th, _logb(ua, lb_u, ub_u) + _logb(xa, lb_x, ub_x)


def _logb(v, lo, hi):
    """Sum over the stages and entries of v [..., S, k] of the finite
    bounds' log terms."""
    out = torch.zeros(v.shape[:-2], dtype=v.dtype, device=v.device)
    for j in range(v.shape[-1]):
        if np.isfinite(lo[j]):
            out = out + _safe_log(v[..., j] - float(lo[j])).sum(-1)
        if np.isfinite(hi[j]):
            out = out + _safe_log(float(hi[j]) - v[..., j]).sum(-1)
    return out


# ---------------------------------------------------------------------------
# the kernel's loop on the CPU, through the scalar programs
# ---------------------------------------------------------------------------

def _bound_terms(v, lo, hi):
    """Per entry j with a finite bound: log(v_j - lo_j) + log(hi_j - v_j)
    (pallas_ls.py:194-207)."""
    terms = []
    for j in range(v.shape[-1]):
        t = None
        if np.isfinite(lo[j]):
            t = _safe_log(v[..., j] - float(lo[j]))
        if np.isfinite(hi[j]):
            s = _safe_log(float(hi[j]) - v[..., j])
            t = s if t is None else t + s
        if t is not None:
            terms.append(t)
    return terms


def probe_codegen(spec: FusedLSSpec, bounds, x, dx, u, du, x0, alphas):
    """What the kernel computes, with every scalar of the generated stage
    programs a [B, chunk] tensor (``stage_codegen.evaluate``) and float32
    accumulators, as the kernel's; the stages are summed in turn, as the
    TPU kernel sums them (the CUDA kernel sums each team lane's items,
    then the lanes: csrc/ls_probe.cuh)."""
    lb_u, ub_u, lb_x, ub_x = bounds
    T = spec.horizon
    a = alphas[..., None]                            # [B, chunk, 1]
    acc = torch.float32
    th0 = x.new_zeros(alphas.shape + (0,))

    def node(t):
        return x[:, None, t] + a * dx[:, None, t]

    def stage_index(t):
        return torch.tensor(t, dtype=torch.int32, device=x.device)

    f = th = lb = torch.zeros(alphas.shape, dtype=acc, device=x.device)
    xp = node(0)
    for t in range(T):
        xc = node(t + 1)
        ue = u[:, None, t] + a * du[:, None, t]
        i = stage_index(t)
        pred = evaluate(spec.dyn_prog, xp, ue, th0, i)
        th_k = (pred - xc).abs().unbind(-1)
        th_k = functools.reduce(lambda p, q: p + q, th_k)
        f_k = (evaluate(spec.ncost_prog, xp, th0, i)
               + evaluate(spec.ecost_prog, xp, ue, th0, i))
        terms = _bound_terms(ue, lb_u, ub_u) + _bound_terms(xp, lb_x, ub_x)
        lb_k = (functools.reduce(lambda p, q: p + q, terms) if terms
                else torch.zeros_like(f_k))
        f, th, lb = f + f_k.to(acc), th + th_k.to(acc), lb + lb_k.to(acc)
        xp = xc
    f = f + evaluate(spec.ncost_prog, xp, th0, stage_index(T)).to(acc)
    root = (x0[:, None] - node(0)).abs().unbind(-1)
    th = th + functools.reduce(lambda p, q: p + q, root).to(acc)
    for t_ in _bound_terms(xp, lb_x, ub_x):
        lb = lb + t_.to(acc)
    return f, th, lb


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def _c_float(v: float) -> str:
    return f"{float(v)!r}f"


def _c_bound_terms(var: str, lo, hi, ns: str = "ls_probe"):
    """The finite bounds' log terms of ``var`` as CUDA expressions, through
    ``safe_log`` of the namespace ``ns``."""
    terms = []
    for j, (l, h) in enumerate(zip(lo, hi)):
        parts = []
        if math.isfinite(l):
            parts.append(f"{ns}::safe_log({var}[{j}] - ({_c_float(l)}))")
        if math.isfinite(h):
            parts.append(f"{ns}::safe_log(({_c_float(h)}) - {var}[{j}])")
        if parts:
            terms.append(" + ".join(parts) if len(parts) == 1
                         else f"({parts[0]} + {parts[1]})")
    return terms


@functools.lru_cache(maxsize=16)
def cuda_source(spec: FusedLSSpec, bounds: tuple) -> str:
    """The kernel's source for one model: its stage functions and finite
    bounds baked in, ``csrc/ls_probe.cuh`` instantiated behind
    ``ls_probe_f32``.  ``bounds`` as ``bounds_key`` gives it."""
    lb_u, ub_u, lb_x, ub_x = bounds
    stage = (_c_bound_terms("u", lb_u, ub_u)
             + _c_bound_terms("x", lb_x, ub_x))
    stage_expr = "0.0f" if not stage else stage[0]
    stage_lines = [f"    float out = {stage_expr};"] + [
        f"    out = out + {t};" for t in stage[1:]] + ["    return out;"]
    term_lines = [f"    acc = acc + {t};"
                  for t in _c_bound_terms("x", lb_x, ub_x)]
    return "\n".join([
        "// Generated by sip_optimal_control_tpu_torch/ops/ls_probe.py from",
        "// the model's stage functions; see csrc/ls_probe.cuh.",
        '#include "ls_probe.cuh"',
        "",
        emit_cuda(spec.dyn_prog, "model_dynamics"),
        emit_cuda(spec.ncost_prog, "model_node_cost"),
        emit_cuda(spec.ecost_prog, "model_edge_cost"),
        "struct Model {",
        f"  static constexpr int T = {spec.horizon}, N = {spec.n}, "
        f"M = {spec.m};",
        "  static __device__ __forceinline__ void dynamics(",
        "      const float* x, const float* u, int i, float* out) {",
        "    model_dynamics(x, u, i, out);",
        "  }",
        "  static __device__ __forceinline__ float node_cost(const float* x,",
        "                                                    int i) {",
        "    float out;",
        "    model_node_cost(x, i, &out);",
        "    return out;",
        "  }",
        "  static __device__ __forceinline__ float edge_cost(",
        "      const float* x, const float* u, int i) {",
        "    float out;",
        "    model_edge_cost(x, u, i, &out);",
        "    return out;",
        "  }",
        "  // bound log-barrier of one stage: controls, then the parent node",
        "  static __device__ __forceinline__ float stage_logb(const float* x,",
        "                                                     const float* u) "
        "{",
        *stage_lines,
        "  }",
        "  // the terminal node's bound terms, added one by one",
        "  static __device__ __forceinline__ float terminal_logb(",
        "      float acc, const float* x) {",
        *term_lines,
        "    return acc;",
        "  }",
        "};",
        "",
        'extern "C" int ls_probe_f32(int B, int chunk, const float* x,',
        "                            const float* dx, const float* u,",
        "                            const float* du, const float* x0,",
        "                            const float* alphas, long long a_sb,",
        "                            long long a_sk, float* f_out,",
        "                            float* th_out, float* lb_out,",
        "                            void* stream) {",
        "  return ls_probe::launch<Model>(B, chunk, x, dx, u, du, x0, alphas,",
        "                                 a_sb, a_sk, f_out, th_out, lb_out,",
        "                                 stream);",
        "}",
        "",
        'extern "C" void ls_probe_launch_config(int B, int* out) {',
        "  ls_probe::launch_config<Model>(B, out);",
        "}",
        ""])


def build_library(spec, bounds):
    """Compile the model's probe library (chain or tree) unless built.
    Returns (path, seconds spent compiling)."""
    if isinstance(spec, TreeLSSpec):
        return cuda_build.build(
            "ls_probe_tree", cuda_source_tree(spec, bounds_key(bounds)),
            ("ls_probe_tree.cuh",))
    return cuda_build.build("ls_probe", cuda_source(spec, bounds_key(bounds)),
                            ("ls_probe.cuh", "riccati_tiny.cuh", "team.cuh"))


@functools.lru_cache(maxsize=None)
def _load(path: str, symbol: str):
    """The entry point ``symbol`` of the built library at ``path`` (one
    per generated source: the path names the source's hash)."""
    fn = getattr(ctypes.CDLL(path), symbol)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [i32, i32] + [ptr] * 6 + [i64, i64] + [ptr] * 4
    fn.restype = i32
    return fn


def launch_config(path: str, B: int) -> dict:
    """The probe's launch at batch ``B``, from the chain's or the tree's
    library built at ``path`` (``build_library(spec, bounds)[0]``): grid,
    block and dynamic shared memory bytes, the lanes of a scenario's
    team."""
    lib = ctypes.CDLL(path)
    fn = getattr(lib, "ls_probe_launch_config", None)
    if fn is None:
        fn = lib.ls_probe_tree_launch_config
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 4)()
    fn(B, out)
    return dict(zip(("grid", "block", "smem", "lanes"), out))


def _entry(spec, bounds):
    """The model's kernel entry point, its library built at first use."""
    symbol = ("ls_probe_tree_f32" if isinstance(spec, TreeLSSpec)
              else "ls_probe_f32")
    return _load(build_library(spec, bounds)[0], symbol)


def _check_args(want, x, dx, u, du, x0, alphas) -> None:
    """Shapes ``want`` by name, one device, float32, contiguous iterates
    (``alphas`` may have any strides), a CUDA device."""
    for name, t in dict(x=x, dx=dx, u=u, du=du, x0=x0,
                        alphas=alphas).items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{want[name]}")
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, expected {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA probe kernel takes float32, "
                            f"got {t.dtype}")
        if name != "alphas" and not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")


def _check(spec: FusedLSSpec, x, dx, u, du, x0, alphas) -> None:
    B, T, n, m = x.shape[0], spec.horizon, spec.n, spec.m
    _check_args(dict(x=(B, T + 1, n), dx=(B, T + 1, n), u=(B, T, m),
                     du=(B, T, m), x0=(B, n), alphas=(B, alphas.shape[-1])),
                x, dx, u, du, x0, alphas)


def _launch(name: str, entry, x, dx, u, du, x0, alphas):
    """One launch of a checked probe kernel; counts it under ``name``."""
    B, chunk = alphas.shape
    out = torch.empty((3, B, chunk), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(B, chunk, x.data_ptr(), dx.data_ptr(), u.data_ptr(),
                    du.data_ptr(), x0.data_ptr(), alphas.data_ptr(),
                    alphas.stride(0), alphas.stride(1), out[0].data_ptr(),
                    out[1].data_ptr(), out[2].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1
    return out[0], out[1], out[2]


def probe_kernel(spec: FusedLSSpec, bounds, x, dx, u, du, x0, alphas,
                 entry=None):
    """The kernel wrapper (replaces pallas_ls.py::_probe_kernel): one
    launch for the whole batch and all candidates.  ``alphas`` may have any
    strides (the solver passes a transposed view).  ``entry``: the model's
    kernel entry point when the caller holds it, else looked up here."""
    _check(spec, x, dx, u, du, x0, alphas)
    return _launch("ls_probe", entry or _entry(spec, bounds), x, dx, u, du,
                   x0, alphas)


# ---------------------------------------------------------------------------
# trees: one program per stage, the stage index baked (pallas_ls.py:96-160)
# ---------------------------------------------------------------------------

class TreeLSSpec(NamedTuple):
    """Static payload of the tree probe: per-stage scalar programs with the
    stage index baked in at trace time (so stage functions that index
    closed-over tables by i, as the scenario tree's per-edge probabilities
    and disturbances do, fold to literals), the original closures for the
    plain twin, and the topology as static ints."""

    node_progs: tuple     # N of (x, th) -> scalar
    ecost_progs: tuple    # E of (xp, u, th) -> scalar
    dyn_progs: tuple      # E of (xp, u, th) -> [n]
    dyn_orig: Callable
    ncost_orig: Callable
    ecost_orig: Callable
    parents: tuple
    children: tuple
    root: int
    num_nodes: int
    n: int
    m: int


# the stage index baked as a Python int (closures without default
# arguments: make_fx traces every parameter of the function it is given)
def _baked_node(fn, i: int):
    return lambda x, th: fn(x, th, i)


def _baked_edge(fn, e: int):
    return lambda x, u, th: fn(x, u, th, e)


@functools.lru_cache(maxsize=16)
def build_fused_tree_spec(dynamics, node_cost, edge_cost, topology, n: int,
                          m: int, dtype: torch.dtype = torch.float32,
                          device="cpu") -> Optional[TreeLSSpec]:
    """Tree analogue of ``build_fused_spec``: one program per node cost,
    edge cost and edge dynamics, each traced with its index baked as a
    Python int.  None when a function cannot be traced or lowered.  Cached
    like ``build_fused_spec``: MPC traces once."""
    edge = (("x", n), ("u", m), ("th", 0))
    node = (("x", n), ("th", 0))
    E = topology.num_edges
    progs = (
        tuple(build_program(_baked_node(node_cost, i), node, dtype, device)
              for i in range(E + 1)),
        tuple(build_program(_baked_edge(edge_cost, e), edge, dtype, device)
              for e in range(E)),
        tuple(build_program(_baked_edge(dynamics, e), edge, dtype, device)
              for e in range(E)))
    shapes = ((), (), (n,))
    if any(p is None or p.out_shape != shape
           for group, shape in zip(progs, shapes) for p in group):
        return None
    return TreeLSSpec(*progs, dyn_orig=dynamics, ncost_orig=node_cost,
                      ecost_orig=edge_cost,
                      parents=tuple(topology.edge_parents),
                      children=tuple(topology.edge_children),
                      root=topology.root, num_nodes=E + 1, n=n, m=m)


def probe_reference_tree(spec: TreeLSSpec, bounds, x, dx, u, du, x0,
                         alphas):
    """Plain PyTorch tree probe with the original stage closures (the port
    of pallas_ls.py::_probe_reference_tree over the batch)."""
    lb_u, ub_u, lb_x, ub_x = bounds
    N, E = spec.num_nodes, len(spec.parents)
    par = torch.as_tensor(spec.parents, device=x.device)
    chl = torch.as_tensor(spec.children, device=x.device)
    a = alphas[..., None, None]                      # [B, chunk, 1, 1]
    xa = x[:, None] + a * dx[:, None]                # [B, chunk, N, n]
    ua = u[:, None] + a * du[:, None]                # [B, chunk, E, m]
    nids = torch.arange(N, device=x.device).expand(xa.shape[:-1])
    eids = torch.arange(E, device=x.device).expand(ua.shape[:-1])
    xp = xa[..., par, :]
    f = (_stagewise(spec.ncost_orig, xa, nids).sum(-1)
         + _stagewise(spec.ecost_orig, xp, ua, eids).sum(-1))
    pred = _stagewise(spec.dyn_orig, xp, ua, eids)
    th = ((pred - xa[..., chl, :]).abs().sum((-1, -2))
          + (x0[:, None] - xa[..., spec.root, :]).abs().sum(-1))
    return f, th, _logb(ua, lb_u, ub_u) + _logb(xa, lb_x, ub_x)


def probe_codegen_tree(spec: TreeLSSpec, bounds, x, dx, u, du, x0, alphas):
    """What the tree kernel computes, with every scalar of the baked stage
    programs a [B, chunk] tensor and float32 accumulators, as the kernel's,
    summed in the TPU kernel's order (the nodes, then the edges, then the
    root row: pallas_ls.py:415-468).  The CUDA kernel adds the same terms
    in another order, per (edge, candidate) item over a team's lanes
    (csrc/ls_probe_tree.cuh), which tests/test_torch_tree_probe_host.py
    bounds."""
    lb_u, ub_u, lb_x, ub_x = bounds
    a = alphas[..., None]                            # [B, chunk, 1]
    acc = torch.float32
    th0 = x.new_zeros(alphas.shape + (0,))

    def total(terms):
        return functools.reduce(lambda p, q: p + q, terms)

    xs = [x[:, None, i] + a * dx[:, None, i] for i in range(spec.num_nodes)]
    f = th = lb = torch.zeros(alphas.shape, dtype=acc, device=x.device)
    for i, xi in enumerate(xs):
        f = f + evaluate(spec.node_progs[i], xi, th0).to(acc)
        for t in _bound_terms(xi, lb_x, ub_x):
            lb = lb + t.to(acc)
    for e, (p, c) in enumerate(zip(spec.parents, spec.children)):
        ue = u[:, None, e] + a * du[:, None, e]
        f = f + evaluate(spec.ecost_progs[e], xs[p], ue, th0).to(acc)
        pred = evaluate(spec.dyn_progs[e], xs[p], ue, th0)
        th = th + total((pred - xs[c]).abs().unbind(-1)).to(acc)
        for t in _bound_terms(ue, lb_u, ub_u):
            lb = lb + t.to(acc)
    root = (x0[:, None] - xs[spec.root]).abs().unbind(-1)
    return f, th + total(root).to(acc), lb


def _dedup_functions(programs, prefix: str):
    """Emit each program once per distinct text: (device functions' source,
    each program's function index among them, named ``{prefix}_{index}``).
    Stages whose baked programs are the same (most of a scenario tree's)
    share one function, so nvcc compiles each distinct stage function
    once."""
    ids, texts, seen = [], [], {}
    for prog in programs:
        text = emit_cuda(prog, "STAGE_FN")
        if text not in seen:
            seen[text] = len(seen)
            texts.append(text.replace("void STAGE_FN(",
                                      f"void {prefix}_{seen[text]}(", 1))
        ids.append(seen[text])
    return texts, ids


def _c_table(name: str, values) -> str:
    return (f"__device__ const int {name}[{len(values)}] = {{"
            + ", ".join(map(str, values)) + "};")


def _c_dispatch(member: str, params: str, table: str, name: str,
                args: str, fns: int, scalar: bool):
    """A ``Model`` member of edge ``e`` that runs the distinct function
    ``{name}_{table[e]}`` on ``args``: one switch over the ``fns`` distinct
    functions, none for one.  ``scalar``: the function's output returned,
    else written through ``out``."""
    def call(i):
        return f"{name}_{i}({args}, {'&out' if scalar else 'out'});"
    body = ["    float out;"] if scalar else []
    if fns == 1:
        body.append(f"    {call(0)}")
    else:
        body.append(f"    switch ({table}[e]) {{")
        body += [f"      case {i}: {call(i)} break;" for i in range(fns - 1)]
        body += [f"      default: {call(fns - 1)} break;", "    }"]
    if scalar:
        body.append("    return out;")
    return [f"  static __device__ __forceinline__ "
            f"{'float' if scalar else 'void'} {member}(int e,",
            f"      {params}) {{", *body, "  }"]


@functools.lru_cache(maxsize=16)
def cuda_source_tree(spec: TreeLSSpec, bounds: tuple) -> str:
    """The tree kernel's source for one model: the distinct stage functions,
    the finite bounds, the tree's tables (each edge's parent and child node
    and the index of its child's node cost, its edge cost and its dynamics
    among the distinct functions) and one switch per kind over the distinct
    functions, ``csrc/ls_probe_tree.cuh`` instantiated behind
    ``ls_probe_tree_f32`` and ``ls_probe_tree_launch_config``."""
    lb_u, ub_u, lb_x, ub_x = bounds
    n, m, N, E = spec.n, spec.m, spec.num_nodes, len(spec.parents)
    ncost_fns, ncost = _dedup_functions(spec.node_progs, "node_cost")
    ecost_fns, ecost = _dedup_functions(spec.ecost_progs, "edge_cost")
    dyn_fns, dyn = _dedup_functions(spec.dyn_progs, "dynamics")
    node_terms = _c_bound_terms("x", lb_x, ub_x, "ls_probe_tree")
    edge_terms = (_c_bound_terms("u", lb_u, ub_u, "ls_probe_tree")
                  + node_terms)

    def logb_fn(name, params, terms):
        body = [f"    float out = {terms[0]};" if terms else
                "    float out = 0.0f;"]
        body += [f"    out = out + {t};" for t in terms[1:]]
        return [f"  static __device__ __forceinline__ float {name}(",
                f"      {params}) {{", *body, "    return out;", "  }"]

    x_, u_ = "const float* __restrict__ x", "const float* __restrict__ u"
    return "\n".join([
        "// Generated by sip_optimal_control_tpu_torch/ops/ls_probe.py from",
        "// the model's stage functions; see csrc/ls_probe_tree.cuh.",
        '#include "ls_probe_tree.cuh"',
        "",
        *ncost_fns, *ecost_fns, *dyn_fns,
        "// each edge's parent and child node; the index of its child's node",
        "// cost, its edge cost and its dynamics among the distinct functions",
        _c_table("tree_parent", spec.parents),
        _c_table("tree_child", spec.children),
        _c_table("tree_child_cost", [ncost[c] for c in spec.children]),
        _c_table("tree_edge_cost", ecost),
        _c_table("tree_dynamics", dyn),
        "",
        "struct Model {",
        f"  static constexpr int kNodes = {N}, kEdges = {E}, N = {n}, "
        f"M = {m}, kRoot = {spec.root};",
        "  static __device__ __forceinline__ int parent(int e) {",
        "    return tree_parent[e];",
        "  }",
        "  static __device__ __forceinline__ int child(int e) {",
        "    return tree_child[e];",
        "  }",
        *_c_dispatch("child_cost", x_, "tree_child_cost", "node_cost", "x",
                     len(ncost_fns), True),
        *_c_dispatch("edge_cost", f"{x_}, {u_}", "tree_edge_cost",
                     "edge_cost", "x, u", len(ecost_fns), True),
        *_c_dispatch("dynamics", f"{x_}, {u_}, float* out", "tree_dynamics",
                     "dynamics", "x, u", len(dyn_fns), False),
        "  static __device__ __forceinline__ float root_cost(",
        f"      {x_}) {{",
        "    float out;",
        f"    node_cost_{ncost[spec.root]}(x, &out);",
        "    return out;",
        "  }",
        "  // a node's state-bound terms, in order",
        *logb_fn("node_logb", x_, node_terms),
        "  // an item's control-bound terms, then its child's state-bound",
        "  // terms",
        *logb_fn("edge_logb", f"{u_}, {x_}", edge_terms),
        "};",
        "",
        'extern "C" int ls_probe_tree_f32(int B, int chunk, const float* x,',
        "                                 const float* dx, const float* u,",
        "                                 const float* du, const float* x0,",
        "                                 const float* alphas, long long a_sb,",
        "                                 long long a_sk, float* f_out,",
        "                                 float* th_out, float* lb_out,",
        "                                 void* stream) {",
        "  return ls_probe_tree::launch<Model>(B, chunk, x, dx, u, du, x0,",
        "                                      alphas, a_sb, a_sk, f_out,",
        "                                      th_out, lb_out, stream);",
        "}",
        "",
        'extern "C" void ls_probe_tree_launch_config(int B, int* out) {',
        "  ls_probe_tree::launch_config<Model>(B, out);",
        "}",
        ""])


def _check_tree(spec: TreeLSSpec, x, dx, u, du, x0, alphas) -> None:
    B, n, m = x.shape[0], spec.n, spec.m
    N, E = spec.num_nodes, len(spec.parents)
    _check_args(dict(x=(B, N, n), dx=(B, N, n), u=(B, E, m), du=(B, E, m),
                     x0=(B, n), alphas=(B, alphas.shape[-1])),
                x, dx, u, du, x0, alphas)


def probe_tree_kernel(spec: TreeLSSpec, bounds, x, dx, u, du, x0, alphas,
                      entry=None):
    """The tree kernel's wrapper (replaces pallas_ls.py::_probe_kernel_tree):
    one launch for the whole batch, all candidates and the whole tree;
    ``alphas`` may have any strides.  ``entry`` as for ``probe_kernel``."""
    _check_tree(spec, x, dx, u, du, x0, alphas)
    return _launch("ls_probe_tree", entry or _entry(spec, bounds), x, dx, u,
                   du, x0, alphas)


def make_fused_probe(spec, bounds):
    """The probe the solver calls: (x, dx, u, du, x0, alphas [B, chunk])
    -> (f, theta, logb) [B, chunk], for a chain (FusedLSSpec) or a tree
    (TreeLSSpec), as pallas_ls.py:568-574 dispatches.  CPU tensors take the
    plain twin; CUDA tensors launch the kernel or raise (float32 only).
    The kernel's entry point is looked up at the first CUDA call and
    kept."""
    tree = isinstance(spec, TreeLSSpec)
    twin = probe_reference_tree if tree else probe_reference
    check = _check_tree if tree else _check
    kernel = probe_tree_kernel if tree else probe_kernel
    entry = None

    def probe(x, dx, u, du, x0, alphas):
        nonlocal entry
        if x.device.type == "cpu":
            return twin(spec, bounds, x, dx, u, du, x0, alphas)
        if entry is None:
            check(spec, x, dx, u, du, x0, alphas)    # raise before a build
            entry = _entry(spec, bounds)
        return kernel(spec, bounds, x, dx, u, du, x0, alphas, entry)
    return probe


# ---------------------------------------------------------------------------
# the fused trip's line-search prologue
# ---------------------------------------------------------------------------

PROLOGUE_OUTPUTS = ("alpha_p", "alpha_d", "theta0", "phi_bar0", "d_phi")


def ls_prologue_reference(vars, dv, zl, zu, dzl, dzu, gx, gu, cdyn, f, mu,
                          lower, upper, tau_min):
    """The plain twin: the fused trip's PyTorch block at the iterate
    ``vars`` (Primal) with direction ``dv``, bound multipliers ``zl``,
    ``zu`` and their directions ``dzl``, ``dzu`` (Primal), the objective
    gradients ``gx`` [B, N, n], ``gu`` [B, E, m], the equality residuals
    ``cdyn`` [B, N, n], the objective ``f`` and barrier parameter ``mu``
    [B] and the bounds shared by every scenario: the fraction-to-the-
    boundary step limits ``alpha_p`` and ``alpha_d``, the infeasibility
    ``theta0``, the barrier merit ``phi_bar0`` and its slope ``d_phi``,
    each [B] (PROLOGUE_OUTPUTS)."""
    # imported here: solver/sip.py imports this module
    from ..solver.sip import _EPS, Primal, _lmin, _lsum, _tdot, _tsum
    has_lb = tree_map(torch.isfinite, lower)
    has_ub = tree_map(torch.isfinite, upper)
    dl = tree_map(lambda v, lb, h: torch.where(h, v - lb, 1.0), vars, lower,
                  has_lb)
    du = tree_map(lambda v, ub, h: torch.where(h, ub - v, 1.0), vars, upper,
                  has_ub)

    def log_barrier():
        def logs(dists, has):
            return _tsum(tree_map(lambda d, h: torch.where(
                h, torch.log(torch.clamp(d, min=_EPS)), 0.0), dists, has))
        return logs(dl, has_lb) + logs(du, has_ub)

    def max_step(val, dval, mask, tau):
        bad = mask & (dval < 0)
        a = torch.where(bad, -lane_view(tau, val) * val
                        / torch.where(bad, dval, -1.0), 1.0)
        return torch.clamp(_lmin(a), max=1.0)

    def min_steps(vals, dvals, msks, tau, sign=1.0):
        out = torch.full(f.shape, 1.0, dtype=f.dtype, device=f.device)
        for v_, d_, m_ in zip(tree_leaves(vals), tree_leaves(dvals),
                              tree_leaves(msks)):
            out = torch.minimum(out, max_step(v_, sign * d_, m_, tau))
        return out

    tau = torch.clamp(1.0 - mu, min=tau_min)
    alpha_p = torch.minimum(min_steps(dl, dv, has_lb, tau),
                            min_steps(du, dv, has_ub, tau, -1.0))
    alpha_d = torch.minimum(min_steps(zl, dzl, has_lb, tau),
                            min_steps(zu, dzu, has_ub, tau))
    theta0 = _lsum(cdyn.abs())
    phi_bar0 = f - mu * log_barrier()
    d_phi = (_tdot(Primal(x=gx, u=gu, theta=vars.theta * 0), dv)
             - mu * _tsum(tree_map(
                 lambda dx_, d, h: torch.where(h, dx_ / d, 0.0), dv, dl,
                 has_lb))
             + mu * _tsum(tree_map(
                 lambda dx_, d, h: torch.where(h, dx_ / d, 0.0), dv, du,
                 has_ub)))
    return alpha_p, alpha_d, theta0, phi_bar0, d_phi


def build_prologue():
    """Compile the prologue's library (one for every model) unless built.
    Returns (path, seconds spent compiling)."""
    return cuda_build.build_file("ls_prologue", "ls_prologue.cu")


@functools.lru_cache(maxsize=None)
def _load_prologue(path: str):
    """The entry point of the prologue library built at ``path``."""
    fn = ctypes.CDLL(path).ls_prologue_f32
    ptr, f32 = ctypes.c_void_p, ctypes.c_float
    fn.argtypes = ([ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
                   + [ptr] * 22 + [f32, f32, ptr, ptr])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _prologue_entry():
    """The prologue kernel's entry point, its library built at first use."""
    return _load_prologue(build_prologue()[0])


# each leaf's operands, in the kernel's entry point's order
_PROLOGUE_OPERANDS = ("v", "dv", "g", "c", "zl", "zu", "dzl", "dzu", "lower",
                      "upper")


def _prologue_leaves(vars, dv, zl, zu, dzl, dzu, gx, gu, cdyn, lower,
                     upper):
    """The kernel's operands of each leaf (``_PROLOGUE_OPERANDS``; the
    controls have no residuals c: None)."""
    return ((vars.x, dv.x, gx, cdyn, zl.x, zu.x, dzl.x, dzu.x, lower.x,
             upper.x),
            (vars.u, dv.u, gu, None, zl.u, zu.u, dzl.u, dzu.u, lower.u,
             upper.u))


def _check_prologue(leaves, f, mu, thetas) -> None:
    """[B, N, n] / [B, E, m] operands with [N, n] / [E, m] bounds, f and mu
    [B], no theta; one CUDA device, float32, contiguous."""
    x, u = leaves[0][0], leaves[1][0]
    if x.dim() != 3 or u.dim() != 3:
        raise ValueError("the prologue takes x [B, N, n] and u [B, E, m]")
    if any(t.numel() for t in thetas):
        raise ValueError("the prologue kernel takes no theta")
    B = x.shape[0]
    named = [("f", f, (B,)), ("mu", mu, (B,))]
    for leaf, ops in zip("xu", leaves):
        rows = tuple(ops[0].shape[1:])
        named += [(f"{leaf}.{name}", t, rows if name in ("lower", "upper")
                   else (B,) + rows)
                  for name, t in zip(_PROLOGUE_OPERANDS, ops) if t is not None]
    for name, t, want in named:
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{want}")
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, expected {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the prologue kernel takes float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")


def prologue_kernel(vars, dv, zl, zu, dzl, dzu, gx, gu, cdyn, f, mu, lower,
                    upper, tau_min):
    """The prologue kernel's wrapper (``csrc/ls_prologue.cu``): one launch
    for the whole batch, no synchronisation; the twin's arguments and
    outputs (views of one [5, B] tensor).  The library is built at the
    first call, after the inputs are checked."""
    from ..solver.sip import _EPS
    leaves = _prologue_leaves(vars, dv, zl, zu, dzl, dzu, gx, gu, cdyn,
                              lower, upper)
    _check_prologue(leaves, f, mu, (vars.theta, dv.theta, zl.theta,
                                    zu.theta, lower.theta))
    x, u = leaves[0][0], leaves[1][0]
    B = x.shape[0]
    out = torch.empty((len(PROLOGUE_OUTPUTS), B), dtype=torch.float32,
                      device=x.device)
    fn = _prologue_entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(B, x[0].numel(), u[0].numel(),
                 *[0 if t is None else t.data_ptr() for ops in leaves
                   for t in ops], f.data_ptr(), mu.data_ptr(),
                 float(tau_min), _EPS, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ls_prologue launch failed: CUDA error {err}")
    launch_counts["ls_prologue"] += 1
    return tuple(out)


def ls_prologue(vars, dv, zl, zu, dzl, dzu, gx, gu, cdyn, f, mu, lower,
                upper, tau_min):
    """What the fused trip calls: CPU tensors take the plain twin
    (``ls_prologue_reference``); CUDA tensors launch the kernel or raise
    (float32, contiguous, no theta)."""
    args = (vars, dv, zl, zu, dzl, dzu, gx, gu, cdyn, f, mu, lower, upper,
            tau_min)
    if f.device.type == "cpu":
        return ls_prologue_reference(*args)
    return prologue_kernel(*args)


# name -> (source, replaced TPU kernel)
KERNELS = {
    "ls_probe": ("sip_optimal_control_tpu_torch/csrc/ls_probe.cuh",
                 "sip_optimal_control_tpu/ops/pallas_ls.py:180"),
    "ls_probe_tree": ("sip_optimal_control_tpu_torch/csrc/ls_probe_tree.cuh",
                      "sip_optimal_control_tpu/ops/pallas_ls.py:394"),
}
