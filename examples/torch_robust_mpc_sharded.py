"""Robust MPC over a scenario tree, batched and sharded over processes
(BASELINE config 5), on the PyTorch + CUDA port.

The port's counterpart of examples/robust_mpc_sharded.py.  Each solve
optimizes a control policy over a disturbance tree: a shared first stage,
then branches with different wind drifts, so the control at the shared
stage must hedge across futures (the tree-LQR machinery the reference
benchmarks as shallow_wide/binary trees, reference:
benchmarks/lqr_benchmark.cpp:209-271, here through the full interior-point
solve).  One process per GPU holds its rows of the batch of initial
states (``shard_scenarios``) and solves them; the cross-scenario
statistics are reduced over the processes with ``all_reduce``.

Run on N GPUs (NCCL):
  torchrun --nproc-per-node N examples/torch_robust_mpc_sharded.py
on the CPU (gloo):
  torchrun --nproc-per-node 2 examples/torch_robust_mpc_sharded.py \
      --device cpu
or alone, as a mesh of one process:
  python examples/torch_robust_mpc_sharded.py [--device cpu]
"""

import argparse
import datetime
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch
import torch.distributed as dist

import sip_optimal_control_tpu_torch as soc
from sip_optimal_control_tpu_torch.solver.settings import LineSearchSettings


def _at(table, i):
    """``table[i]`` for the stage index ``i``: a Python int (the fused tree
    probe bakes it) or a 0-dim tensor, through ``index_select`` so that
    the solver's batched derivatives over the stages can take it."""
    if isinstance(i, int):
        return table[i]
    return torch.index_select(table, 0, i.reshape(1).long())[0]


def wind_tree(shared=2, branch_len=4, winds=(-0.3, 0.0, 0.3), dt=0.1,
              dtype=torch.float32, device="cuda"):
    """Chain of `shared` stages, then one branch per wind hypothesis."""
    parents, children, drift = [], [], []
    node = 1
    prev_shared = 0
    for _ in range(shared):
        parents.append(prev_shared)
        children.append(node)
        drift.append(0.0)
        prev_shared = node
        node += 1
    for w in winds:
        prev = prev_shared
        for _ in range(branch_len):
            parents.append(prev)
            children.append(node)
            drift.append(w)
            prev = node
            node += 1
    E = len(parents)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    drift_arr = t(drift)
    A = t([[1.0, dt], [0.0, 1.0]])
    B = t([[0.0], [dt]])
    push = t([dt, 0.0])

    def dynamics(x, u, th, i):
        return A @ x + B @ u[:1] + _at(drift_arr, i) * push

    def node_cost(x, th, i):
        return 0.5 * torch.sum(x ** 2)

    def edge_cost(x, u, th, i):
        return 0.5 * 0.05 * torch.sum(u ** 2)

    spec = soc.ModelSpec(dynamics=dynamics, node_cost=node_cost,
                         edge_cost=edge_cost)
    topo = soc.Topology.tree(0, parents, children)
    dims = soc.Dimensions.uniform(num_edges=E, state_dim=2, control_dim=1)
    return spec, dims, topo


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (NCCL, one GPU per process) or 'cpu' "
                             "(gloo)")
    parser.add_argument("--dtype", choices=("float32", "float64"),
                        default="float32")
    parser.add_argument("--per-rank", type=int, default=4,
                        help="scenarios per process")
    args = parser.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    on_gpu = args.device != "cpu"

    if "RANK" in os.environ:                  # started by torchrun
        if on_gpu:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl" if on_gpu else "gloo",
                                timeout=datetime.timedelta(seconds=60))
    try:
        mesh = soc.scenario_mesh(device=None if on_gpu else "cpu")
        spec, dims, topo = wind_tree(dtype=dtype, device=mesh.device)
        B = args.per_rank * mesh.size

        # every rank draws the same global batch and keeps its rows
        rng = np.random.default_rng(0)
        x0s = np.stack([np.array([1.0, 0.0]) + 0.2 * rng.standard_normal(2)
                        for _ in range(B)])
        x0s = soc.shard_scenarios(torch.as_tensor(x0s, dtype=dtype), mesh)

        lower, upper = soc.box_bounds(dims, u_lower=-2.0, u_upper=2.0,
                                      dtype=dtype, device=mesh.device)
        common = dict(max_iterations=60,
                      line_search=LineSearchSettings(fused_probe=True))
        settings = (soc.Settings(tol=1e-6, **common)
                    if dtype == torch.float64 else
                    soc.Settings(tol=1e-3, mu_min=1e-5, reg_floor=1e-5,
                                 prox_reg=1e-5, **common))
        u, statuses, stats = soc.solve_batch_sharded(
            spec, dims, topo, x0s, settings, mesh, lower, upper)
        if mesh.rank == 0:
            print(f"ranks: {mesh.size} ({mesh.device}), scenarios: {B} "
                  f"({args.per_rank} per rank)")
            print(f"solved {int(stats.total_solved)}/{B}, "
                  f"mean iterations {float(stats.mean_iterations):.1f}, "
                  f"max kkt {float(stats.max_kkt_error):.2e}")
            # the shared-stage control hedges across the wind branches
            print(f"first-stage control, scenario 0: "
                  f"{float(u[0, 0, 0]):+.4f}")
        assert int(stats.total_solved) == B, int(stats.total_solved)
        assert bool((statuses == 0).all())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
