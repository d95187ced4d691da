"""The benchmark of sip_optimal_control_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  The cell's entry in BENCHMARK.json names its configuration
(``portbench/configs/<config>.json``) and traffic
(``portbench/traffic/<traffic>.json``); each metric is read by
``portbench/metrics/<metric>.py``.  The run sets up (kernels from the
checkout's build cache, the problem, the warm periods), measures for
``--seconds``, profiles a few more periods when ``--trace 1``, checks the
recorded periods against the plain reference, and prints one JSON line
last on standard output: the cell's end-to-end metrics (``--trace 0``) or
its per-layer metrics (``--trace 1``).  Without a CUDA card, or with fewer
than the cell asks for, it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# what the port may never load in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "sip_optimal_control_tpu")
CACHE = os.path.join(ROOT, "_portbench_cache")


def load_cell(workload: str, root: str = ROOT) -> tuple:
    """(cell, configuration, traffic, metrics) of ``workload``: its
    BENCHMARK.json entry, the configuration and traffic files found by
    name, and the metric entries that apply to it, end-to-end first."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(root, "portbench", "traffic",
                           cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)

    def applies(metric):
        return workload in metric.get("workloads", (workload,))
    metrics = dict(end_to_end=[m for m in bench["end_to_end"]
                               if applies(m)],
                   per_layer=[m for m in bench["per_layer"] if applies(m)])
    return cell, cfg, traffic, metrics


def reader(name: str, root: str = ROOT):
    """The ``read(ctx)`` function of ``portbench/metrics/<name>.py``."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def _smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"


def _caches():
    """Every build and kernel cache at a fixed directory in the checkout
    (the port builds its kernels into its own ``_build/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)


def measure(cell, cfg, traffic, metrics, seed, seconds, trace, device,
            fleet_cls=None):
    """The run itself, from set-up to the check; returns the result
    object.  ``fleet_cls`` replaces the fleet runner (tests)."""
    import torch
    from portbench import check, fleet, work
    fleet_cls = fleet_cls or fleet.Fleet
    run = fleet_cls(cfg, traffic, seed, device)
    run.warm()
    setup_s = time.perf_counter() - T_START
    run.window(seconds)
    traced = run.traced(traffic["trace_periods"]) if trace else None
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    pairs = run.checked_pairs()
    run.free()
    correct, table, compared = check.judge(cfg, pairs)

    ref_model = check.reference_model(cfg, torch.float32, "cpu")
    ops = (work.scalar_ops(ref_model.dynamics, torch.zeros(run.n),
                           torch.zeros(run.m)),
           work.scalar_ops(ref_model.node_cost, torch.zeros(run.n),
                           torch.tensor(1.0)),
           work.scalar_ops(ref_model.edge_cost, torch.zeros(run.n),
                           torch.zeros(run.m)))
    ls = cfg["settings"]["line_search"]
    ctx = types.SimpleNamespace(
        batch=run.batch, period_s=list(run.period_s),
        window_s=run.window_s, setup_s=setup_s, iterations=run.iterations,
        trips=run.trips, launches=dict(run.launches),
        peak_window_bytes=run.peak_window_bytes, trace=traced,
        work=work.CellWork(
            run.T, run.n, run.m, run.batch, max(1, int(ls["chunk"])),
            cfg["hessian_mode"] == "exact",
            work.finite_count(run.lower.u[0]) + work.finite_count(
                run.upper.u[0]),
            work.finite_count(run.lower.x[0]) + work.finite_count(
                run.upper.x[0]), ops))
    kind = "per_layer" if trace else "end_to_end"
    values = {}
    for m in metrics[kind]:
        value = reader(m["name"])(ctx)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run.batch * len(run.period_s),
              "failed": run.failed, "metrics": values, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in table.items()}
    result["check"]["pairs_compared"] = compared
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell, cfg, traffic, metrics = load_cell(args.workload)
    _caches()
    sys.path.insert(0, ROOT)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(device)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {_smi()}", flush=True)
    result = measure(cell, cfg, traffic, metrics, args.seed, args.seconds,
                     args.trace, device)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        if isinstance(v, dict):
            print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
                  file=sys.stderr)
        else:
            print(f"check {k} = {v}", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
