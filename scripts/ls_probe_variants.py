#!/usr/bin/env python3
"""Time variants of the chain line-search probe kernel on the card.

Builds csrc/ls_probe.cuh with its tuning constants replaced (``kGroup``, the
candidates of a pass, and a register cap through the blocks per SM of
``__launch_bounds__``) and, with ``--header LABEL=PATH``, other versions
of the kernel (a checkout's, such as the parent commit unpacked by ``git
archive``, or a header file), for the
cartpole and chain16 paths' models at the main path's shapes (B=4096, T=50,
6 candidates, ``chip_smoke.probe_inputs``), one nvcc per variant, all at
once.  Then it checks each variant against the plain twin
(``chip_smoke.probe_match``) and times them in turn, ``--rounds`` times
over: device ms per launch (torch.profiler, ``chip_smoke.kernel_device_ms``)
beside each variant's ptxas line and SASS instruction count (cuobjdump).
Run from the repository root on a
machine with a GPU:

    python3 scripts/ls_probe_variants.py \\
        --header parent=_archive_check/parent --groups 6 --min-blocks 0,4,8

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


def variant_header(text, group, min_blocks):
    """csrc/ls_probe.cuh's text with kGroup = ``group`` and, unless 0,
    ``min_blocks`` blocks per SM in its launch bounds."""
    old = "constexpr int kGroup = "
    start = text.index(old) + len(old)
    text = text[:start] + str(group) + text[text.index(";", start):]
    if min_blocks:
        old = "__launch_bounds__(kThreads)"
        assert old in text
        text = text.replace(old, f"__launch_bounds__(kThreads, {min_blocks})")
    return text


def variant_source(spec, bounds, header):
    """The model's generated source with ``header`` in place of its
    #include of ls_probe.cuh, without the launch-configuration entry point
    (another version of the kernel may lack it or take other arguments)."""
    from sip_optimal_control_tpu_torch.ops import ls_probe
    src = ls_probe.cuda_source(spec, ls_probe.bounds_key(bounds))
    src = src[:src.index('extern "C" void ls_probe_launch_config')]
    return src.replace('#include "ls_probe.cuh"',
                       header.replace("#pragma once", ""))


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
                    help="LABEL=PATH: a checkout or an ls_probe.cuh to time")
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

    with open(os.path.join(cuda_build.CSRC, "ls_probe.cuh")) as fh:
        header = fh.read()
    # label -> (header text, its kernel's name in ptxas's log)
    headers = {}
    for item in opts.header:
        label, path = item.split("=", 1)
        if os.path.isdir(path):
            path = os.path.join(path, "sip_optimal_control_tpu_torch",
                                "csrc", "ls_probe.cuh")
        with open(path) as fh:
            headers[label] = (fh.read(), ("probe_kernelI5ModelLi6E",
                                          "probe_kernel"))
    for g in map(int, opts.groups.split(",")):
        for mb in map(int, opts.min_blocks.split(",")):
            headers[f"group{g}_minblocks{mb}"] = (
                variant_header(header, g, mb), ("probe_kernel",))

    cases = {}
    for seed, model in enumerate(cs.CHAIN_PATHS):
        prob, dims = cs.path_problem(model, device)
        spec, bounds, _ = prob.fused_ls
        cases[model] = (spec, bounds, cs.probe_inputs(dims, cs.BATCH, seed,
                                                      device))
    jobs = {(model, label): (spec, bounds, text)
            for model, (spec, bounds, _) in cases.items()
            for label, (text, _) in headers.items()}

    def build(key):
        spec, bounds, text = jobs[key]
        return cuda_build.build("ls_probe_variant",
                                variant_source(spec, bounds, text),
                                ("riccati_tiny.cuh", "team.cuh"))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(build, jobs)))
    cs.log(f"built {len(built)} variants; longest nvcc "
           f"{max(s for _, s in built.values()):.1f} s")

    calls, out = {}, {}
    for (model, label), (path, _) in built.items():
        spec, bounds, args = cases[model]
        entry = ls_probe._load(path, "ls_probe_f32")
        calls[model, label] = (
            lambda s=spec, b=bounds, a=args, e=entry:
            ls_probe.probe_kernel(s, b, *a, entry=e))
        err = cs.probe_match(f"{model} {label}", calls[model, label](),
                             ls_probe.probe_reference(spec, bounds, *args))
        ptxas = ptxas_of(path, headers[label][1])
        out[f"{model} {label}"] = {
            "ptxas": ptxas, "max_abs_err": err, "device_ms": [],
            "sass_instructions": sass_size(path, ptxas.split(":")[0])}
    for _ in range(opts.rounds):
        for key, fn in calls.items():
            ms = cs.kernel_device_ms([fn], "void ls_probe::",
                                     ["probe_kernel"], reps=20)
            out[" ".join(key)]["device_ms"].append(ms["probe_kernel"])
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
