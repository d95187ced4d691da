"""Small dense linear-algebra primitives for the Riccati recursion.

PyTorch port of ``sip_optimal_control_tpu/ops/linalg.py`` (reference:
sip_optimal_control/lqr.cpp:473-549).  Stage matrices are tiny (n, m <= ~32)
and throughput comes from batching thousands of scenarios, so the
factorizations are unrolled entry by entry: every unrolled op is one
elementwise op over all leading (batch, stage) axes.

Failure is reported as data (bool), never as an exception — a batched solver
cannot abort on one bad scenario.  Non-PD inputs yield NaNs in the factor,
detected from the diagonal like Eigen's llt.info() check.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Above this size the unrolled graphs get large; use torch.linalg instead.
_UNROLL_LIMIT = 24


def _chol_unrolled(a: torch.Tensor) -> torch.Tensor:
    """Unrolled lower Cholesky over the last two dims."""
    n = a.shape[-1]
    col = [[None] * n for _ in range(n)]   # col[j][i] = L[i, j], i >= j
    for j in range(n):
        s = a[..., j, j]
        for k in range(j):
            s = s - col[k][j] * col[k][j]
        d = torch.sqrt(s)
        col[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = a[..., i, j]
            for k in range(j):
                s = s - col[k][i] * col[k][j]
            col[j][i] = s * inv_d
    zero = torch.zeros_like(a[..., 0, 0])
    rows = [torch.stack([col[j][i] if j <= i else zero for j in range(n)],
                        dim=-1) for i in range(n)]
    return torch.stack(rows, dim=-2)


def _tri_solve_unrolled(l: torch.Tensor, b: torch.Tensor,
                        transpose: bool) -> torch.Tensor:
    """Solve L x = b (or L^T x = b) by unrolled substitution.

    b: [..., n] or [..., n, k]; L lower triangular [..., n, n].
    """
    n = l.shape[-1]
    matrix_rhs = b.dim() == l.dim()

    def lij(i, j):
        v = l[..., i, j]
        return v[..., None] if matrix_rhs else v

    x = [None] * n
    order = range(n - 1, -1, -1) if transpose else range(n)
    for i in order:
        s = b[..., i, :] if matrix_rhs else b[..., i]
        ks = range(i + 1, n) if transpose else range(i)
        for k in ks:
            coeff = lij(k, i) if transpose else lij(i, k)
            s = s - coeff * x[k]
        x[i] = s / lij(i, i)
    return torch.stack(x, dim=-2 if matrix_rhs else -1)


def cholesky_with_ok(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower Cholesky factor plus a validity flag over the leading axes
    (cf. Eigen::LLT info(), reference: lqr.cpp:505-508, 697-700)."""
    n = a.shape[-1]
    if n <= _UNROLL_LIMIT:
        l = _chol_unrolled(a)
    else:
        l, _ = torch.linalg.cholesky_ex(a)
    diag = torch.diagonal(l, dim1=-2, dim2=-1)
    ok = torch.all(torch.isfinite(diag) & (diag > 0), dim=-1)
    return l, ok


def tri_solve(l: torch.Tensor, b: torch.Tensor,
              transpose: bool = False) -> torch.Tensor:
    n = l.shape[-1]
    if n <= _UNROLL_LIMIT:
        return _tri_solve_unrolled(l, b, transpose)
    vec = b.dim() == l.dim() - 1
    if vec:
        b = b[..., None]
    lt = l.transpose(-1, -2) if transpose else l
    x = torch.linalg.solve_triangular(lt, b, upper=transpose)
    return x[..., 0] if vec else x


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b given lower factor L.  b: [..., n] or [..., n, k]."""
    return tri_solve(l, tri_solve(l, b, transpose=False), transpose=True)


def sym(a: torch.Tensor) -> torch.Tensor:
    """Symmetrize; the recursion only guarantees the lower triangle
    analytically (reference mirrors lower->upper, helpers.cpp:155-158)."""
    return 0.5 * (a + a.transpose(-1, -2))
