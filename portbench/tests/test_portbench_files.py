"""The benchmark's files: found by name, each matching its BENCHMARK.json
entry, and BENCHMARK.json's limits on names, units and sizes."""

import json
import os
import re

import pytest

from portbench import run

ROOT = run.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as _fh:
    BENCH = json.load(_fh)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    got, cfg, traffic, metrics = run.load_cell(cell["name"])
    assert got == cell
    conf = {c["name"]: c for c in BENCH["configs"]}[cell["config"]]
    assert cfg["name"] == conf["name"] == cell["config"]
    assert conf["file"] == f"portbench/configs/{cell['config']}.json"
    # the traffic's kind names the runner module
    assert NAME.match(traffic["kind"])
    assert callable(run.runner_class(traffic["kind"]))
    if traffic["kind"] == "fleet":
        for key in ("batch", "start_state", "start_jitter", "disturbance",
                    "warm_periods", "check_scenarios", "trace_periods"):
            assert key in traffic
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = {m["name"] for m in metrics["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert metrics["per_layer"]
    for m in metrics["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_complete(conf):
    with open(os.path.join(ROOT, conf["file"])) as fh:
        cfg = json.load(fh)
    assert set(cfg["check"]["limits"]) == {"off_share", "x_next_gap_p50"}
    assert cfg["check"]["control"] in ("tf32", "bf16")
    # the reference reads every setting the program is given
    from portbench.fleet import program_settings
    import dataclasses
    st = dataclasses.asdict(program_settings(cfg))
    st.pop("logging")
    assert st == cfg["settings"]
    assert os.path.exists(os.path.join(
        ROOT, "portbench", "reference", cfg["reference_model"] + ".py"))


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(run.reader(metric["name"]))
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["per_layer"]:
        assert "workloads" in metric
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_names_and_text_fields():
    names = [c["name"] for c in BENCH["configs"]] + [
        w["name"] for w in BENCH["workloads"]] + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200
        assert "\n" not in entry["why"] and "\t" not in entry["why"]
    for c in BENCH["configs"]:
        assert len(c["source"]) <= 200 and not c["reduced"]
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"interior-point loop", "trip", "kernels", "device",
                      "scenario sharding"}


def test_a_new_metric_is_a_new_file(tmp_path):
    """A metric added as a file is found by its name, with no other
    edit."""
    os.makedirs(tmp_path / "portbench" / "metrics")
    (tmp_path / "portbench" / "metrics" / "new_metric.x.py").write_text(
        "def read(ctx):\n    return ctx.batch * 2\n")
    import types
    assert run.reader("new_metric.x", str(tmp_path))(
        types.SimpleNamespace(batch=3)) == 6
