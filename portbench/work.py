"""The yardstick's arithmetic: work counted from shapes, and the H100's peaks.

Nothing here reads a time.  Two counts:

* ``trip_flops`` / ``trip_bytes``: the linear-algebra core of one
  interior-point trip of one scenario (condensation, Riccati factor and
  solve, multiplier recovery, KKT residual) and its memory traffic with no
  fusion credit.  Copied from the JAX package's ``bench.py``
  (``flops_per_newton_iteration``, ``bytes_per_newton_iteration``) with the
  constraint rows at zero, as the benchmark's configurations have none.  It
  counts the same work whatever code does it.
* ``kernel_work``: the operations and bytes of one launch of each of the
  port's kernels at a cell's shapes, by kernel name.  The Riccati algebra is
  copied from ``chip_smoke.py`` (``_riccati_flops``); the bytes follow
  ``chip_smoke.py``'s ``fused_bytes`` for the fused kernels and each
  operand read once and each result written once for the Riccati kernels
  and the probe.  Operations count the Riccati algebra and the forward
  stage functions (one per scalar result of each operation of the plain
  reference's function); the derivative programs are left out, so the
  operations are a lower bound and a roofline share never reads high.
"""

from __future__ import annotations

import math
import re

# NVIDIA H100 SXM, published: float32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FLOAT = 4

# the fused kernels' storage (csrc/fused_iter.cuh): symmetric blocks packed
# from n = 6 on, the Gram form from n = 8 on
PACK_N, GRAM_N = 6, 8


def trip_flops(T: int, n: int, m: int) -> float:
    """bench.py::flops_per_newton_iteration with no constraint rows."""
    n, m = float(max(n, 1)), float(max(m, 1))
    factor = (n ** 3 / 3 + 2 * n ** 3 + 2 * n ** 3 + 2 * n * n * m
              + 2 * n * m * m + m ** 3 / 3 + 2 * m * m * n
              + 2 * n ** 3 + 2 * n * n * m)
    solve = 12 * n * n + 8 * n * m
    resid = 8 * n * n + 8 * n * m
    return T * (factor + solve + resid)


def trip_bytes(T: int, n: int, m: int, itemsize: int = FLOAT) -> float:
    """bench.py::bytes_per_newton_iteration with no constraint rows."""
    n, m = float(max(n, 1)), float(max(m, 1))
    nn, nm, mm = n * n, n * m, m * m
    model_out = (nn + nm) + (nn + 2 * nm + mm) + (n + m)
    cond = nn + mm + nm
    factor = (nn + mm + nm) + (nn + nm + n) + (2 * nn + mm + nm + nn)
    solve = (2 * nn + nm) + 3 * n + m + (2 * n + m)
    ls = 2 * (2 * (n + m))
    return itemsize * T * (model_out + cond + factor + solve + ls)


def riccati_flops(name: str, n: int, m: int) -> float:
    """chip_smoke.py::_riccati_flops: operations per scenario and edge of
    each Riccati kernel (a multiply-add is 2; Cholesky n^3/3, a triangular
    solve with c columns c n^2)."""
    if name == "factor":
        return (3 * n * n + n ** 3 / 3 + 2 * n ** 3 + 3 * n * n
                + 2 * m * n * n + 2 * m * m * n + m ** 3 / 3 + 2 * n ** 3
                + 2 * m * n * n + 2 * n * m * m + 2 * n ** 3 + 2 * m * n * n
                + 2 * n * n)
    if name == "factor_gram":
        return (3 * n * n + n ** 3 / 3 + n * n + n * m + n ** 3 + m * n * n
                + 2 * m * (m + 1) * n + m ** 3 / 3 + 4 * m * n * n
                + 2 * n * m * m + n * (n + 1) / 2 * (4 * n + 2 * m))
    if name == "solve_bwd":
        return (6 * n + 2 * n * n + 2 * m * n + 2 * m * m + 2 * n * n
                + 2 * m * n + 2 * n)
    if name == "solve_fwd":
        return 2 * m * n + 2 * n * n + 2 * m * n + 4 * n + 2 * n * n \
            + 2 * n * n
    raise KeyError(name)


_VIEWS = {"view", "expand", "select", "slice", "unsqueeze", "squeeze", "t",
          "transpose", "permute", "alias", "_unsafe_view", "as_strided",
          "detach", "diagonal", "split", "split_with_sizes", "unbind",
          "reshape", "lift_fresh_copy", "clone", "_to_copy", "empty",
          "zeros", "full", "new_zeros", "new_empty", "scalar_tensor"}


def scalar_ops(fn, *args) -> int:
    """Scalar operations of ``fn`` at ``args``: the number of elements each
    operation of its traced graph produces, views and copies left out."""
    from torch.fx.experimental.proxy_tensor import make_fx
    import torch
    total = 0
    for node in make_fx(fn)(*args).graph.nodes:
        if node.op != "call_function":
            continue
        packet = getattr(node.target, "_overloadpacket", None)
        if (packet.__name__ if packet else str(node.target)) in _VIEWS:
            continue
        val = node.meta.get("val")
        vals = val if isinstance(val, (tuple, list)) else (val,)
        total += sum(v.numel() for v in vals if isinstance(v, torch.Tensor))
    return total


class CellWork:
    """Per-launch operations and bytes of the port's kernels at one cell's
    shapes: horizon T, sizes (n, m), the batch, the line search's chunk,
    exact or Gauss-Newton Hessians, the count of finite control and state
    bound entries of a stage, and the forward stage functions' scalar
    operations (``ops``: dynamics, node cost, edge cost)."""

    def __init__(self, T, n, m, batch, chunk, exact, finite_u, finite_x,
                 ops):
        self.T, self.n, self.m, self.batch = T, n, m, batch
        self.chunk, self.exact = chunk, exact
        self.finite_u, self.finite_x = finite_u, finite_x
        self.ops = ops

    def trip(self):
        """(operations, bytes) of one trip over the batch."""
        T, n, m = self.T, self.n, self.m
        return (self.batch * trip_flops(T, n, m),
                self.batch * trip_bytes(T, n, m))

    # ----- per scenario ---------------------------------------------------
    def _fused_bytes(self, name):
        """chip_smoke.py::fused_bytes."""
        T, n, m = self.T, self.n, self.m
        s = n * (n + 1) // 2 if n >= PACK_N else n * n
        small = n < GRAM_N
        jac = T * (n * n + n * m) if small else T * (n + m)
        if name == "factor":
            floats = (2 * (T + 1) * n + 2 * T * m + (T * n if self.exact
                                                     else 0) + 1
                      + T * (2 * s + m * n + m * m) + s
                      + (T * (n * n + n * m) if small else 0))
        elif name == "solve_bwd":
            floats = (2 * (T + 1) * n + T * m + 1 + s
                      + T * (s + m * m + m * n) + jac + T * (m + n) + 2 * n)
        elif name == "solve_fwd":
            floats = (2 * n + T * (m + m * n + n + n + 2 * s) + jac + 1
                      + T * m + 2 * (T + 1) * n)
        else:
            floats = (2 * (T + 1) * n + T * m + n + 2 * (T + 1) * n
                      + 2 * T * m + 3 * (T + 1) * n + 2 * T * m + 7)
        return FLOAT * floats

    def _fused(self, name):
        T, n, m = self.T, self.n, self.m
        fin = T * (self.finite_u + self.finite_x) + self.finite_x
        if name == "factor":
            edge = riccati_flops("factor_gram" if n >= GRAM_N else "factor",
                                 n, m)
            flops = T * (2 * n * n + n + m * m + m + edge) + n
        elif name == "solve_bwd":
            flops = (T * riccati_flops("solve_bwd", n, m) + 2 * n * n
                     + n ** 3 / 3 + 2 * n * n + 4 * n + 2 * n * n)
        elif name == "solve_fwd":
            flops = T * riccati_flops("solve_fwd", n, m)
        else:
            dyn, nc, ec = self.ops
            flops = (T * (dyn + nc + ec + 9 * n + 6 * m) + nc + 9 * n
                     + 4 * fin)
        return flops, self._fused_bytes(name)

    def _riccati(self, name):
        T, n, m = self.T, self.n, self.m
        nn, nm, mm = n * n, n * m, m * m
        flops = T * riccati_flops(name, n, m)
        if name.startswith("factor"):
            # Q, delta, A, B, M, R in; V, F_chol, K, G_chol out
            floats = ((T + 1) * (nn + n) + T * (nn + 2 * nm + mm)
                      + 2 * (T + 1) * nn + T * (nm + mm))
        elif name == "solve_bwd":
            # q, r, c, delta, F_chol, G_chol, K, A, B in; k, v out
            floats = ((T + 1) * (3 * n + nn) + T * (m + mm + 2 * nm + nn)
                      + T * (m + n))
        else:
            # x_root, k, K, A, B, c, delta, v, V, F_chol in; x, u, y out
            floats = (n + T * (m + 2 * nm + nn) + (T + 1) * (3 * n + 2 * nn)
                      + (T + 1) * 2 * n + T * m)
        return flops, FLOAT * floats

    def _probe(self):
        """Per scenario and launch: every candidate's trial point, stage
        programs, L1 infeasibility and log-barrier terms (chip_smoke.py::
        probe_flops); reads the iterate, the direction and x0, writes three
        sums per candidate."""
        T, n, m, k = self.T, self.n, self.m, self.chunk
        dyn, nc, ec = self.ops
        finite = self.finite_u + self.finite_x
        per_stage = dyn + nc + ec + 2 * (n + m) + 3 * n + 4
        flops = k * (T * per_stage + nc + 5 * n + 3 * finite * (T + 1))
        floats = 2 * (T + 1) * n + 2 * T * m + n + k + 3 * k
        return flops, FLOAT * floats

    def kernel(self, name: str):
        """(operations, bytes) of one launch of the kernel the profiler
        names ``name`` over the batch, or None for a kernel this cell does
        not count."""
        hit = re.search(r"\b(fused_iter|riccati|ls_probe)::(\w+)", name)
        if hit is None:
            return None
        space, kern = hit.groups()
        if space == "ls_probe":
            per = self._probe() if kern == "probe_kernel" else None
        elif space == "fused_iter":
            per = {"factor_thread_kernel": "factor",
                   "factor_team_kernel": "factor",
                   "solve_bwd_kernel": "solve_bwd",
                   "solve_fwd_kernel": "solve_fwd",
                   "eval_kernel": "eval"}.get(kern)
            per = per and self._fused(per)
        else:
            per = {"factor_kernel": "factor",
                   "factor_gram_kernel": "factor_gram",
                   "solve_bwd_kernel": "solve_bwd",
                   "solve_fwd_kernel": "solve_fwd"}.get(kern)
            per = per and self._riccati(per)
        if not per:
            return None
        return per[0] * self.batch, per[1] * self.batch


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory rate."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def is_port_kernel(name: str) -> bool:
    """Whether the profiler's kernel ``name`` is one of the port's own."""
    return re.search(r"\b(fused_iter|riccati|ls_probe|ls_probe_tree)::",
                     name) is not None


def finite_count(t) -> int:
    return int(sum(1 for v in t.flatten().tolist() if math.isfinite(v)))
