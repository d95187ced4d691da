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

The traffic's ``kind`` names the runner, ``portbench/<kind>.py``'s
``Runner`` (``fleet.py``: a chain MPC fleet on one card).  A cell over
``chips`` > 1 cards runs one process a card (``launch``): the ranks join
one process group, each runs the runner over its own rows, and rank 0
merges what they measured; the process started here prints the line once
every rank has ended well, and ends every rank when one fails or the run
passes ``DEADLINE_S``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# what the port may never load in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "sip_optimal_control_tpu")
CACHE = os.path.join(ROOT, "_portbench_cache")
# a run over several cards ends, every rank with it, once it is this old
# (a checkout's first run, which builds the kernels, may take 1,200 s)
DEADLINE_S = 1150
# a collective of the ranks' group that waits this long raises
GROUP_TIMEOUT_S = 300


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


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: str = ROOT):
    """The ``read(ctx)`` function of ``portbench/metrics/<name>.py``."""
    return _module(os.path.join(root, "portbench", "metrics", name + ".py"),
                   "portbench_metric_" + name.replace(".", "_")).read


def runner_class(kind: str, root: str = ROOT):
    """The ``Runner`` of ``portbench/<kind>.py``: built with ``(cfg,
    traffic, seed, device, rank, ranks)``, after the ranks' process group
    exists (so it may call the port's ``scenario_mesh()``).  It has
    ``warm()``, ``window(seconds)``, ``traced(periods)``,
    ``checked_pairs()``, ``free()`` and ``work()``; after its window
    ``batch`` (its own rows), ``period_s``, ``window_s``, ``iterations``,
    ``trips``, ``failed``, ``launches`` and ``peak_window_bytes``.  One
    that runs over several ranks also has ``window(seconds, over)``, which
    calls ``over(t_start)`` after each of its periods has synchronised on
    its rank and ends the window when it returns True; and may have
    ``build()``, which builds every kernel its periods use with no
    collective: rank 0 calls it before the other ranks build their
    runners."""
    return _module(os.path.join(root, "portbench", kind + ".py"),
                   "portbench_runner_" + kind).Runner


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


def _part(run, trace: int, traffic: dict, device):
    """What one rank's runner measured once its window closed: its
    figures, the traced periods (``--trace 1``), its memory peak, its
    checked pairs (its state freed afterwards) and its work counts."""
    import torch
    traced = run.traced(traffic["trace_periods"]) if trace else None
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    pairs = run.checked_pairs()
    run.free()
    return types.SimpleNamespace(
        batch=run.batch, period_s=list(run.period_s), window_s=run.window_s,
        iterations=run.iterations, trips=run.trips, failed=run.failed,
        launches=dict(run.launches), peak_window_bytes=run.peak_window_bytes,
        memory_peak_bytes=peak, trace=traced, pairs=pairs, work=run.work())


def report(metrics, trace: int, setup_s: float, parts: list, judged,
           device, root: str = ROOT) -> dict:
    """The result object from every rank's ``_part`` (rank 0's first) and
    the check's ``judged`` (``check.judge`` over all their pairs).  The
    metric readers' ``ctx`` holds rank 0's figures, except ``batch``, the
    rows of every rank, ``iterations`` and ``failed``, summed, and
    ``peak_window_bytes``, the largest; ``ctx.ranks`` holds every rank's
    own."""
    import torch
    first = parts[0]
    peaks = [p.peak_window_bytes for p in parts]
    ctx = types.SimpleNamespace(
        batch=sum(p.batch for p in parts), period_s=list(first.period_s),
        window_s=first.window_s, setup_s=setup_s,
        iterations=sum(p.iterations for p in parts), trips=first.trips,
        launches=dict(first.launches),
        peak_window_bytes=None if None in peaks else max(peaks),
        trace=first.trace, work=first.work, ranks=parts)
    kind = "per_layer" if trace else "end_to_end"
    values = {}
    for m in metrics[kind]:
        value = reader(m["name"], root)(ctx)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else "cpu"),
           "count": len(parts),
           "memory_peak_bytes": (max(p.memory_peak_bytes for p in parts)
                                 if on_card else None)}
    result = {"correct": judged[0], "attempted": ctx.batch * len(
        ctx.period_s), "failed": sum(p.failed for p in parts),
        "metrics": values, "device": dev}
    if first.trace is not None:
        # busy over the cards' time: every rank's busy seconds, averaged
        dev["busy_s"] = sum(p.trace["busy_s"] for p in parts) / len(parts)
        dev["window_s"] = first.trace["window_s"]
        result["breakdown"] = {"device_ops": first.trace["device_ops"],
                               "idle_gaps": first.trace["idle_gaps"]}
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in judged[1].items()}
    result["check"]["pairs_compared"] = judged[2]
    return result


def measure(cell, cfg, traffic, metrics, seed, seconds, trace, device,
            runner_cls=None, root=ROOT):
    """The run of a one-card cell in this process, from set-up to the
    check; returns the result object.  ``runner_cls`` replaces the
    traffic's runner (tests)."""
    from portbench import check
    runner_cls = runner_cls or runner_class(traffic["kind"], root)
    run = runner_cls(cfg, traffic, seed, device, 0, 1)
    run.warm()
    setup_s = time.perf_counter() - T_START
    run.window(seconds)
    part = _part(run, trace, traffic, device)
    return report(metrics, trace, setup_s, [part],
                  check.judge(cfg, part.pairs, root), device, root)


# ----- a cell over several cards: one process a card ------------------------
_BUILT = "rank0_built"


def _all_ranks(value: float, device) -> float:
    """A one-element all_reduce (sum) over the ranks' group; its wait ends
    when every rank has reached it."""
    import torch
    import torch.distributed as dist
    t = torch.tensor([value], dtype=torch.float32, device=device)
    dist.all_reduce(t)
    return t.item()


def rank_main(args, spec: dict) -> int:
    """One rank of a cell over several cards (``launch`` starts it): joins
    the group, runs the runner over its own rows (rank 0 builds first),
    hands its part to rank 0, which checks every rank's pairs at once and
    writes the result to the group's directory."""
    import datetime
    import torch
    import torch.distributed as dist
    from portbench import check
    rank, ranks, group = spec["rank"], spec["ranks"], spec["group"]
    root = spec["root"]
    _, cfg, traffic, metrics = load_cell(args.workload, root)
    if spec["device"] == "cuda":
        torch.cuda.set_device(rank)
        device, backend = torch.device("cuda", rank), "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    store = dist.FileStore(os.path.join(group, "store"), ranks)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=ranks,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        runner_cls = runner_class(traffic["kind"], root)
        if rank == 0:
            if device.type == "cuda":
                print(f"device: {torch.cuda.get_device_name(device)} x "
                      f"{torch.cuda.device_count()}; nvidia-smi: {_smi()}",
                      flush=True)
            run = runner_cls(cfg, traffic, args.seed, device, rank, ranks)
            if hasattr(run, "build"):
                run.build()
            store.set(_BUILT, "1")
        else:
            store.wait([_BUILT], datetime.timedelta(seconds=DEADLINE_S))
            run = runner_cls(cfg, traffic, args.seed, device, rank, ranks)
        run.warm()
        _all_ranks(1.0, device)
        setup_s = time.perf_counter() - spec["started"]

        def over(t_start):
            # rank 0's clock decides; the reduce ends the period
            done = rank == 0 and time.perf_counter() - t_start >= args.seconds
            return _all_ranks(float(done), device) > 0
        run.window(args.seconds, over)
        part = _part(run, args.trace, traffic, device)
        part.pairs = {k: v.cpu() for k, v in part.pairs.items()}
        if rank:
            torch.save(part, os.path.join(group, f"rank{rank}.pt"))
        _all_ranks(1.0, device)
        if rank == 0:
            parts = [part] + [torch.load(os.path.join(group, f"rank{r}.pt"),
                                         weights_only=False)
                              for r in range(1, ranks)]
            pairs = {k: torch.cat([p.pairs[k] for p in parts]).to(device)
                     for k in part.pairs}
            result = report(metrics, args.trace, setup_s, parts,
                            check.judge(cfg, pairs, root), device, root)
            tmp = os.path.join(group, "result.json.tmp")
            with open(tmp, "w") as fh:
                json.dump(result, fh)
            os.replace(tmp, os.path.join(group, "result.json"))
    finally:
        dist.destroy_process_group()
    found = forbidden_modules()
    if found:
        print(f"rank {rank} loaded {', '.join(found)}", file=sys.stderr)
        return 3
    return 0


def _wait(procs, deadline: float) -> int:
    """0 once every rank has exited 0; the first failing rank's code (1
    for a signal), or 1 past ``deadline`` (host clock), otherwise."""
    while True:
        codes = [p.poll() for p in procs]
        for r, code in enumerate(codes):
            if code not in (None, 0):
                print(f"rank {r} exited with {code}; ending every rank",
                      file=sys.stderr)
                return code if code > 0 else 1
        if all(code == 0 for code in codes):
            return 0
        if time.perf_counter() > deadline:
            print("the ranks passed the deadline; ending every rank",
                  file=sys.stderr)
            return 1
        time.sleep(0.05)


def launch(workload: str, seed: int, seconds: float, trace: int,
           ranks: int, root: str = ROOT, device: str = "cuda",
           started: float = None, deadline_s: float = DEADLINE_S) -> int:
    """Runs a cell over ``ranks`` processes, rank r on ``cuda:r`` with
    ``LOCAL_RANK`` r (``device`` "cpu": gloo ranks on the CPU, for tests),
    joined through a file store in a fresh directory under ``TMPDIR``;
    prints the result once every rank has exited 0 and returns the exit
    code.  A rank that fails, the run passing ``started`` (this process's
    start by default) + ``deadline_s``, or SIGTERM ends every rank (each in
    a process group of its own, whatever it started included); the
    directory is removed."""
    started = time.perf_counter() if started is None else started
    group = tempfile.mkdtemp(prefix="portbench-ranks-")
    procs, result = [], None

    def stop(signum, frame):
        raise SystemExit(128 + signum)
    previous = signal.signal(signal.SIGTERM, stop)
    # the ranks share this host: NCCL's bootstrap stays on the loopback
    env = {"NCCL_SOCKET_IFNAME": "lo", **os.environ}
    try:
        for r in range(ranks):
            spec = dict(rank=r, ranks=ranks, group=group, started=started,
                        root=root, device=device)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--workload",
                 workload, "--seed", str(seed), "--seconds", repr(seconds),
                 "--trace", str(trace), "--rank-spec", json.dumps(spec)],
                env=env | {"LOCAL_RANK": str(r)}, start_new_session=True))
        rc = _wait(procs, started + deadline_s)
        if rc == 0:
            with open(os.path.join(group, "result.json")) as fh:
                result = json.load(fh)
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        shutil.rmtree(group, ignore_errors=True)
        signal.signal(signal.SIGTERM, previous)
    if rc:
        return rc
    return _print_result(result)


def _print_result(result: dict) -> int:
    """The check's numbers beside their limits on standard error and the
    result line last on standard output, unless this process holds a
    module the run may not load (exit 3)."""
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # one rank of a cell over several cards, as ``launch`` starts it
    p.add_argument("--rank-spec", type=json.loads, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    _caches()
    sys.path.insert(0, ROOT)
    if args.rank_spec is not None:
        return rank_main(args, args.rank_spec)
    cell, cfg, traffic, metrics = load_cell(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if cell["chips"] > 1:
        return launch(args.workload, args.seed, args.seconds, args.trace,
                      cell["chips"], started=T_START)
    device = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(device)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {_smi()}", flush=True)
    return _print_result(measure(cell, cfg, traffic, metrics, args.seed,
                                 args.seconds, args.trace, device))


if __name__ == "__main__":
    sys.exit(main())
