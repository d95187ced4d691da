#!/usr/bin/env python3
"""Time variants of the line-search probe kernels on the card.

Builds csrc/ls_probe.cuh with its tuning constants replaced (``kGroup``, the
candidates of a pass, and a register cap through the blocks per SM of
``__launch_bounds__``) and, with ``--header LABEL=PATH``, other versions
of the kernel (a checkout's, such as the parent commit unpacked by ``git
archive``, or a header file), for the
cartpole and chain16 paths' models at the main path's shapes (B=4096, T=50,
6 candidates, ``chip_smoke.probe_inputs``), one nvcc per variant, all at
once.  With ``--tree`` it does the same for csrc/ls_probe_tree.cuh on the
robust_tree path's model (N=51, E=50), at each of ``--windows`` (its
``kMaxWindow``, the edges of a window at most) and each register cap; a
checkout given by ``--header`` there brings its own
generated source (its ``ops/ls_probe.py::cuda_source_tree``, run in a
subprocess in that checkout).  Then it checks each variant against the
plain twin (``chip_smoke.probe_match``) and times them in turn,
``--rounds`` times over: device ms per launch (torch.profiler,
``chip_smoke.kernel_device_ms``) beside each variant's ptxas line and SASS
instruction count (cuobjdump).  Run from the repository root on a machine
with a GPU:

    python3 scripts/ls_probe_variants.py \\
        --header parent=_archive_check/parent --groups 6 --min-blocks 0,4,8
    python3 scripts/ls_probe_variants.py --tree \\
        --header parent=_archive_check/parent --windows 64,32 --min-blocks 0,8

``--out PATH`` also writes every reading there as JSON.
"""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def variant_header(text, group, min_blocks, window=0):
    """A probe header's text with kGroup = ``group``; ``min_blocks``
    blocks per SM in its launch bounds and (the tree's) kMaxWindow =
    ``window``, each unless 0."""
    def replace(text, old, value):
        start = text.index(old) + len(old)
        return text[:start] + str(value) + text[text.index(";", start):]
    text = replace(text, "constexpr int kGroup = ", group)
    if min_blocks:
        old = "__launch_bounds__(kThreads)"
        assert old in text
        text = text.replace(old, f"__launch_bounds__(kThreads, {min_blocks})")
    if window:
        text = replace(text, "constexpr int kMaxWindow = ", window)
    return text


def variant_source(spec, bounds, header, tree=False):
    """The model's generated source with ``header`` in place of its
    #include of the probe header, without the launch-configuration entry
    point (another version of the kernel may lack it or take other
    arguments)."""
    from sip_optimal_control_tpu_torch.ops import ls_probe
    if tree:
        src = ls_probe.cuda_source_tree(spec, ls_probe.bounds_key(bounds))
        name, entry = "ls_probe_tree.cuh", "ls_probe_tree_launch_config"
    else:
        src = ls_probe.cuda_source(spec, ls_probe.bounds_key(bounds))
        name, entry = "ls_probe.cuh", "ls_probe_launch_config"
    src = src[:src.index(f'extern "C" void {entry}')]
    return src.replace(f'#include "{name}"',
                       header.replace("#pragma once", ""))


# a checkout's generated robust_tree probe source, printed by its own code
_CHECKOUT_TREE_SOURCE = """
import sys
sys.path.insert(0, ".")
import chip_smoke as cs
from sip_optimal_control_tpu_torch.ops import ls_probe
prob, _ = cs.path_problem("robust_tree", "cpu", batch=1)
spec, bounds, _ = prob.fused_ls
sys.stdout.write(ls_probe.cuda_source_tree(spec, ls_probe.bounds_key(bounds)))
"""


def checkout_tree_source(root):
    """The robust_tree probe source that the checkout at ``root``
    generates, its csrc/ls_probe_tree.cuh pasted in place of the #include
    (the other headers it names come from this checkout's csrc/), without
    a launch-configuration entry point."""
    src = subprocess.run([sys.executable, "-c", _CHECKOUT_TREE_SOURCE],
                         cwd=root, capture_output=True, text=True,
                         check=True).stdout
    cut = src.find('extern "C" void ls_probe_tree_launch_config')
    with open(os.path.join(root, "sip_optimal_control_tpu_torch", "csrc",
                           "ls_probe_tree.cuh")) as fh:
        header = fh.read().replace("#pragma once", "")
    return (src if cut < 0 else src[:cut]).replace(
        '#include "ls_probe_tree.cuh"', header)


def ptxas_of(path, names):
    """ptxas's line for the first of ``names`` that the library has."""
    for name in names[:-1]:
        try:
            return cs.ptxas_line(path, name)
        except AssertionError:
            pass
    return cs.ptxas_line(path, names[-1])


def sass_size(path, name):
    """Instructions in the SASS of the first function whose name holds
    ``name`` (cuobjdump of the CUDA toolkit), or None without cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True).stdout
    count, inside = 0, False
    for line in text.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = name in line
        elif inside and line.strip().startswith("/*") and ";" in line:
            count += 1
    return count


def main():
    import torch
    from sip_optimal_control_tpu_torch.ops import cuda_build, ls_probe

    ap = argparse.ArgumentParser()
    ap.add_argument("--header", action="append", default=[],
                    help="LABEL=PATH: a checkout or a probe header to time")
    ap.add_argument("--tree", action="store_true",
                    help="the tree probe on robust_tree")
    ap.add_argument("--windows", default="64",
                    help="the tree probe's kMaxWindow values")
    ap.add_argument("--groups", default="6")
    ap.add_argument("--min-blocks", default="0,4")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="a JSON file for the readings")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("ls_probe_variants: needs a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cs.log(smi)

    if opts.tree:
        hname, kernel, counter = ("ls_probe_tree.cuh", "probe_tree_kernel",
                                  "ls_probe_tree")
        models, twin = ("robust_tree",), ls_probe.probe_reference_tree
        entry_name, windows = "ls_probe_tree_f32", opts.windows.split(",")
    else:
        hname, kernel, counter = "ls_probe.cuh", "probe_kernel", "ls_probe"
        models, twin = cs.CHAIN_PATHS, ls_probe.probe_reference
        entry_name, windows = "ls_probe_f32", ("0",)
    with open(os.path.join(cuda_build.CSRC, hname)) as fh:
        header = fh.read()
    # label -> (source of a model's spec and bounds, its kernel's name in
    # ptxas's log); a checkout's tree source is its own
    sources = {}
    for item in opts.header:
        label, path = item.split("=", 1)
        if opts.tree and os.path.isdir(path):
            text = checkout_tree_source(path)
            sources[label] = (lambda spec, bounds, s=text: s, (kernel,))
            continue
        if os.path.isdir(path):
            path = os.path.join(path, "sip_optimal_control_tpu_torch",
                                "csrc", hname)
        with open(path) as fh:
            text = fh.read()
        sources[label] = (
            lambda spec, bounds, h=text: variant_source(spec, bounds, h,
                                                        opts.tree),
            ("probe_kernelI5ModelLi6E", kernel))
    for g in map(int, opts.groups.split(",")):
        for mb in map(int, opts.min_blocks.split(",")):
            for w in map(int, windows):
                label = f"group{g}_minblocks{mb}" + (f"_window{w}" if w
                                                     else "")
                text = variant_header(header, g, mb, w)
                sources[label] = (
                    lambda spec, bounds, h=text: variant_source(
                        spec, bounds, h, opts.tree), (kernel,))

    cases = {}
    for seed, model in enumerate(models):
        prob, dims = cs.path_problem(model, device)
        spec, bounds, _ = prob.fused_ls
        cases[model] = (spec, bounds, cs.probe_inputs(dims, cs.BATCH, seed,
                                                      device))
    jobs = {(model, label): make(spec, bounds)
            for model, (spec, bounds, _) in cases.items()
            for label, (make, _) in sources.items()}

    def build(key):
        return cuda_build.build("ls_probe_variant", jobs[key],
                                ("ls_probe.cuh", "riccati_tiny.cuh",
                                 "team.cuh"))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(build, jobs)))
    cs.log(f"built {len(built)} variants; longest nvcc "
           f"{max(s for _, s in built.values()):.1f} s")

    wrapper = (ls_probe.probe_tree_kernel if opts.tree
               else ls_probe.probe_kernel)
    calls, out = {}, {}
    for (model, label), (path, _) in built.items():
        spec, bounds, args = cases[model]
        entry = ls_probe._load(path, entry_name)
        calls[model, label] = (
            lambda s=spec, b=bounds, a=args, e=entry:
            wrapper(s, b, *a, entry=e))
        err = cs.probe_match(f"{model} {label}", calls[model, label](),
                             twin(spec, bounds, *args))
        ptxas = ptxas_of(path, sources[label][1])
        out[f"{model} {label}"] = {
            "ptxas": ptxas, "max_abs_err": err, "device_ms": [],
            "sass_instructions": sass_size(path, ptxas.split(":")[0])}
    prefix = "void ls_probe_tree::" if opts.tree else "void ls_probe::"
    for _ in range(opts.rounds):
        for key, fn in calls.items():
            ms = cs.kernel_device_ms([fn], prefix, {counter: kernel},
                                     reps=20)
            out[" ".join(key)]["device_ms"].append(ms[kernel])
    for key, rec in out.items():
        cs.log(f"variant[{key}] B={cs.BATCH} chunk={cs.CHUNK}: device ms "
               + " / ".join(f"{v:.4f}" for v in rec["device_ms"])
               + f"; max abs err {rec['max_abs_err']:.3e}; SASS "
               f"{rec['sass_instructions']} instructions; ptxas "
               f"{rec['ptxas']}")
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump({"device": smi, "variants": out}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
