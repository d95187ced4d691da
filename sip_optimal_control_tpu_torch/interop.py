"""Conversion from the JAX package's containers to this package's.

``from_jax_numpy(cls, src)`` builds a container of this package (LQRData,
LQRFactorization, StageModelData, Primal, YVec, ZVec, SolveResult, ...) from
an object with the same field names whose leaves are arrays — the JAX
package's dataclasses and NamedTuples after ``np.asarray`` on each leaf.
Both packages use the same field names and batched layouts, so the
conversion is field by field.  Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.kkt import StageModelData
from .solver.sip import ModelEval, Primal, SolveResult, YVec, ZVec

# container fields that hold another container
_NESTED = {
    (SolveResult, "vars"): Primal, (SolveResult, "s"): ZVec,
    (SolveResult, "y"): YVec, (SolveResult, "z"): ZVec,
    (SolveResult, "zl"): Primal, (SolveResult, "zu"): Primal,
    (ModelEval, "grad"): Primal, (ModelEval, "c"): YVec,
    (ModelEval, "g"): ZVec, (ModelEval, "stage"): StageModelData,
}


def _field_names(cls):
    if dataclasses.is_dataclass(cls):
        return [f.name for f in dataclasses.fields(cls)]
    return list(cls._fields)


def from_jax_numpy(cls, src, device=None, dtype=None):
    """Build a ``cls`` from ``src``'s same-named fields.  Float arrays keep
    their precision unless ``dtype`` is given; integer arrays stay
    integer."""
    values = {}
    for name in _field_names(cls):
        value = getattr(src, name)
        nested = _NESTED.get((cls, name))
        if nested is not None:
            values[name] = from_jax_numpy(nested, value, device, dtype)
            continue
        arr = np.array(value)
        t = torch.as_tensor(arr, device=device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        values[name] = t
    return cls(**values)

