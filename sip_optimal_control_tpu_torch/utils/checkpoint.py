"""Warm-start checkpointing: persist solver state across processes.

PyTorch port of ``sip_optimal_control_tpu/utils/checkpoint.py``, with the
same ``.npz`` fields, so a file written by either package loads in the
other.  The reference has no file checkpointing; its checkpoint/resume
equivalent is the caller-visible warm-start state
`sip_workspace.vars.{x,y}` that persists across solve() calls
(reference: tests/variable_dimensions_test.cpp:437-446, SURVEY section 5).
Here that state is (Primal, YVec), so persisting it is a plain array dump:
save the primal/dual iterates of a (possibly batched) solve to one
``.npz`` file and resume a receding-horizon MPC loop in a fresh process.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..solver.sip import Primal, YVec

_FIELDS = ("x", "u", "theta", "y_dyn", "y_nc", "y_ec")


def save_warm_start(path: str, vars: Primal, y: YVec) -> None:
    """Write warm-start state (batched or not) to ``path`` (.npz).

    Accepts tensors on any device, or NumPy arrays; everything is copied
    to the host.  Written to a temporary file and renamed over ``path``:
    no torn checkpoint on a crash.
    """
    arrays = dict(x=vars.x, u=vars.u, theta=vars.theta,
                  y_dyn=y.dyn, y_nc=y.nc, y_ec=y.ec)
    host = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in arrays.items()}
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **host)
    os.replace(tmp, path)


def load_warm_start(path: str, device="cuda",
                    dtype: Optional[torch.dtype] = None
                    ) -> Tuple[Primal, YVec]:
    """Load state saved by :func:`save_warm_start` (by either package) as
    tensors on ``device`` (the card unless the caller asks for the CPU),
    in the file's precision unless ``dtype`` is given; pass them straight
    to ``solve(problem, settings, init_vars=vars, init_y=y)``."""
    with np.load(path) as data:
        missing = [k for k in _FIELDS if k not in data]
        if missing:
            raise ValueError(
                f"{path} is not a warm-start checkpoint: missing {missing}")
        t = {k: torch.as_tensor(data[k], device=device, dtype=dtype)
             for k in _FIELDS}
    return (Primal(x=t["x"], u=t["u"], theta=t["theta"]),
            YVec(dyn=t["y_dyn"], nc=t["y_nc"], ec=t["y_ec"]))
