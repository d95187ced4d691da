"""Flat-vector interop: the reference's flat primal/equality/inequality
layouts over the stagewise containers the solver uses.

PyTorch port of ``sip_optimal_control_tpu/ops/flatten.py``.  The C++
reference hands the SIP core flat vectors and keeps offset tables mapping
(node/edge) -> position (reference: types.cpp:24-64,
populate_workspace_metadata):

  primal x = [x_0, u_0, x_1, u_1, ..., x_{E-1}, u_{E-1}, x_E, theta]
             (node i interleaved with edge i; types.cpp:33-41)
  equality y = [dyn_0, node_c_0, ..., dyn_E, node_c_E, edge_c_0, ...]
             (types.cpp:43-53; dyn_root is the root/initial-state row)
  inequality z = [node_g_0, ..., node_g_E, edge_g_0, ...]
             (types.cpp:55-63)

The solver never computes on these layouts (stagewise tensors, padded to
the max dims, are the compute format); this module serves parity tests
against dense oracles in the reference's coordinates and users migrating
flat warm starts or bounds from the C++ stack.

The offsets are Python ints and NumPy arrays derived from `Dimensions`
(``build_flat_layout``, the JAX package's code).  The conversions are one
gather or scatter along the last axis with the layout's index arrays,
made on the data's device once per (layout, device); every leading axis
(the scenario batch) is carried through, as the JAX functions carry a
vmapped one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..types import Dimensions
from .kkt import KKTVector, apply_K


@dataclasses.dataclass(frozen=True, eq=False)
class FlatLayout:
    """Offset tables + gather indices for one `Dimensions`.

    Offset semantics match the reference's workspace metadata
    (reference: types.cpp:33-63): `x_state_offsets[i]` is where node i's
    state starts in the flat primal, etc.  `*_gather` arrays index into the
    *flattened padded* stagewise storage (concatenated in the order of the
    ``_*_concat`` helpers below).
    """

    dims: Dimensions
    x_state_offsets: np.ndarray    # [N]
    x_control_offsets: np.ndarray  # [E]
    theta_offset: int
    y_dyn_offsets: np.ndarray      # [N]
    y_node_c_offsets: np.ndarray   # [N]
    y_edge_c_offsets: np.ndarray   # [E]
    z_node_offsets: np.ndarray     # [N]
    z_edge_offsets: np.ndarray     # [E]
    # flat position -> index into the concatenated raveled padded arrays
    primal_gather: np.ndarray      # [x_dim]
    y_gather: np.ndarray           # [y_dim]
    z_gather: np.ndarray           # [z_dim]

    @property
    def x_dim(self) -> int:
        return self.dims.x_dim

    @property
    def y_dim(self) -> int:
        return self.dims.y_dim

    @property
    def z_dim(self) -> int:
        return self.dims.z_dim

    @property
    def kkt_dim(self) -> int:
        return self.dims.x_dim + self.dims.y_dim + self.dims.z_dim


def build_flat_layout(dims: Dimensions) -> FlatLayout:
    N, E = dims.num_nodes, dims.num_edges
    n = max(dims.max_state_dim, 1)
    m = max(dims.max_control_dim, 1)
    cn, ce = dims.max_node_c_dim, dims.max_edge_c_dim
    gn, ge = dims.max_node_g_dim, dims.max_edge_g_dim

    # --- primal offsets (reference: types.cpp:33-41) -----------------------
    x_state_offsets = np.zeros(N, dtype=np.int64)
    x_control_offsets = np.zeros(E, dtype=np.int64)
    off = 0
    for node in range(N):
        x_state_offsets[node] = off
        if node < E:
            off += dims.state_dims[node]
            x_control_offsets[node] = off
            off += dims.control_dims[node]
    theta_offset = dims.stagewise_x_dim

    # --- y offsets (reference: types.cpp:43-53) ----------------------------
    y_dyn_offsets = np.zeros(N, dtype=np.int64)
    y_node_c_offsets = np.zeros(N, dtype=np.int64)
    off = 0
    for node in range(N):
        y_dyn_offsets[node] = off
        off += dims.state_dims[node]
        y_node_c_offsets[node] = off
        off += dims.node_c_dims[node]
    y_edge_c_offsets = np.zeros(E, dtype=np.int64)
    for edge in range(E):
        y_edge_c_offsets[edge] = off
        off += dims.edge_c_dims[edge]

    # --- z offsets (reference: types.cpp:55-63) ----------------------------
    z_node_offsets = np.zeros(N, dtype=np.int64)
    off = 0
    for node in range(N):
        z_node_offsets[node] = off
        off += dims.node_g_dims[node]
    z_edge_offsets = np.zeros(E, dtype=np.int64)
    for edge in range(E):
        z_edge_offsets[edge] = off
        off += dims.edge_g_dims[edge]

    # --- gather maps into concatenated raveled padded storage --------------
    # primal concat order: [x (N*n) | u (E*m) | theta (p)]
    primal_gather = np.zeros(dims.x_dim, dtype=np.int64)
    for node in range(N):
        o = x_state_offsets[node]
        d = dims.state_dims[node]
        primal_gather[o:o + d] = node * n + np.arange(d)
    for edge in range(E):
        o = x_control_offsets[edge]
        d = dims.control_dims[edge]
        primal_gather[o:o + d] = N * n + edge * m + np.arange(d)
    primal_gather[theta_offset:] = N * n + E * m + np.arange(dims.theta_dim)

    # y concat order: [y_dyn (N*n) | y_nc (N*cn) | y_ec (E*ce)]
    y_gather = np.zeros(dims.y_dim, dtype=np.int64)
    for node in range(N):
        o = y_dyn_offsets[node]
        d = dims.state_dims[node]
        y_gather[o:o + d] = node * n + np.arange(d)
        o = y_node_c_offsets[node]
        d = dims.node_c_dims[node]
        y_gather[o:o + d] = N * n + node * cn + np.arange(d)
    for edge in range(E):
        o = y_edge_c_offsets[edge]
        d = dims.edge_c_dims[edge]
        y_gather[o:o + d] = N * n + N * cn + edge * ce + np.arange(d)

    # z concat order: [z_n (N*gn) | z_e (E*ge)]
    z_gather = np.zeros(dims.z_dim, dtype=np.int64)
    for node in range(N):
        o = z_node_offsets[node]
        d = dims.node_g_dims[node]
        z_gather[o:o + d] = node * gn + np.arange(d)
    for edge in range(E):
        o = z_edge_offsets[edge]
        d = dims.edge_g_dims[edge]
        z_gather[o:o + d] = N * gn + edge * ge + np.arange(d)

    return FlatLayout(
        dims=dims,
        x_state_offsets=x_state_offsets,
        x_control_offsets=x_control_offsets,
        theta_offset=theta_offset,
        y_dyn_offsets=y_dyn_offsets,
        y_node_c_offsets=y_node_c_offsets,
        y_edge_c_offsets=y_edge_c_offsets,
        z_node_offsets=z_node_offsets,
        z_edge_offsets=z_edge_offsets,
        primal_gather=primal_gather,
        y_gather=y_gather,
        z_gather=z_gather,
    )


@functools.lru_cache(maxsize=32)
def _index(layout: FlatLayout, name: str, device: torch.device):
    """The layout's gather array ``name`` as an int64 tensor on
    ``device``, made once per (layout, device)."""
    return torch.as_tensor(getattr(layout, name), device=device)


def _ravel(*arrays) -> torch.Tensor:
    """Concatenate the stagewise arrays, each raveled over its last two
    axes (the stage and row axes), along the last axis."""
    return torch.cat([a.reshape(a.shape[:-2] + (-1,)) for a in arrays],
                     dim=-1)


def _gather(layout: FlatLayout, name: str, cat: torch.Tensor):
    return cat.index_select(-1, _index(layout, name, cat.device))


def _scatter(layout: FlatLayout, name: str, flat: torch.Tensor, total: int):
    cat = flat.new_zeros(flat.shape[:-1] + (total,))
    return cat.index_copy(-1, _index(layout, name, flat.device), flat)


# ---------------------------------------------------------------------------
# stagewise -> flat
# ---------------------------------------------------------------------------

def flatten_primal(layout: FlatLayout, x, u, theta) -> torch.Tensor:
    """(x [..., N, n], u [..., E, m], theta [..., p]) -> flat primal
    [..., x_dim]."""
    return _gather(layout, "primal_gather",
                   torch.cat([_ravel(x, u), theta], dim=-1))


def flatten_y(layout: FlatLayout, y_dyn, y_nc, y_ec) -> torch.Tensor:
    return _gather(layout, "y_gather", _ravel(y_dyn, y_nc, y_ec))


def flatten_z(layout: FlatLayout, z_n, z_e) -> torch.Tensor:
    return _gather(layout, "z_gather", _ravel(z_n, z_e))


def flatten_kkt(layout: FlatLayout, v: KKTVector) -> torch.Tensor:
    """KKTVector -> flat [..., x_dim + y_dim + z_dim] in the reference
    ordering [x | y | z] (the ordering add_Kx_to_y is defined over,
    reference: helpers.cpp:953-977)."""
    return torch.cat([
        flatten_primal(layout, v.x, v.u, v.theta),
        flatten_y(layout, v.y_dyn, v.y_nc, v.y_ec),
        flatten_z(layout, v.z_n, v.z_e)], dim=-1)


# ---------------------------------------------------------------------------
# flat -> stagewise (padded entries come back as zeros)
# ---------------------------------------------------------------------------

def unflatten_primal(layout: FlatLayout, flat) -> Tuple[torch.Tensor, ...]:
    dims = layout.dims
    N, E = dims.num_nodes, dims.num_edges
    n = max(dims.max_state_dim, 1)
    m = max(dims.max_control_dim, 1)
    lead = flat.shape[:-1]
    cat = _scatter(layout, "primal_gather", flat,
                   N * n + E * m + dims.theta_dim)
    x = cat[..., :N * n].reshape(lead + (N, n))
    u = cat[..., N * n:N * n + E * m].reshape(lead + (E, m))
    theta = cat[..., N * n + E * m:]
    return x, u, theta


def unflatten_y(layout: FlatLayout, flat):
    dims = layout.dims
    N, E = dims.num_nodes, dims.num_edges
    n = max(dims.max_state_dim, 1)
    cn, ce = dims.max_node_c_dim, dims.max_edge_c_dim
    lead = flat.shape[:-1]
    cat = _scatter(layout, "y_gather", flat, N * n + N * cn + E * ce)
    y_dyn = cat[..., :N * n].reshape(lead + (N, n))
    y_nc = cat[..., N * n:N * n + N * cn].reshape(lead + (N, cn))
    y_ec = cat[..., N * n + N * cn:].reshape(lead + (E, ce))
    return y_dyn, y_nc, y_ec


def unflatten_z(layout: FlatLayout, flat):
    dims = layout.dims
    N, E = dims.num_nodes, dims.num_edges
    gn, ge = dims.max_node_g_dim, dims.max_edge_g_dim
    lead = flat.shape[:-1]
    cat = _scatter(layout, "z_gather", flat, N * gn + E * ge)
    z_n = cat[..., :N * gn].reshape(lead + (N, gn))
    z_e = cat[..., N * gn:].reshape(lead + (E, ge))
    return z_n, z_e


def unflatten_kkt(layout: FlatLayout, flat) -> KKTVector:
    xd, yd = layout.x_dim, layout.y_dim
    x, u, theta = unflatten_primal(layout, flat[..., :xd])
    y_dyn, y_nc, y_ec = unflatten_y(layout, flat[..., xd:xd + yd])
    z_n, z_e = unflatten_z(layout, flat[..., xd + yd:])
    return KKTVector(x=x, u=u, theta=theta, y_dyn=y_dyn, y_nc=y_nc,
                     y_ec=y_ec, z_n=z_n, z_e=z_e)


# ---------------------------------------------------------------------------
# dense operators in flat coordinates (test/parity oracles)
# ---------------------------------------------------------------------------

def dense_kkt_matrix(layout: FlatLayout, model, regs, sched) -> torch.Tensor:
    """Materialize every scenario's full regularized Newton-KKT matrix
    [B, kkt_dim, kkt_dim] in the reference's flat coordinates by applying
    the stagewise apply_K operator to the basis vectors, one column of
    every scenario per application: a test oracle, mirroring the dense
    cross-check pattern of the reference's tests (reference:
    tests/lqr_test.cpp:859-929)."""
    batch, D = model.A.shape[0], layout.kkt_dim
    dtype, device = model.A.dtype, model.A.device
    cols = []
    for j in range(D):
        e = torch.zeros(batch, D, dtype=dtype, device=device)
        e[:, j] = 1.0
        cols.append(flatten_kkt(layout, apply_K(
            model, regs, unflatten_kkt(layout, e), sched)))
    return torch.stack(cols, dim=-1)
