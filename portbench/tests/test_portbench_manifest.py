"""BENCHMARK.json against the contract's form, and every file found by name."""

import json
import shutil

import pytest

from portbench import harness

ROOT = harness.ROOT
M = harness.manifest()
WIDTHS = ("hidden_size", "intermediate_size", "head_dim", "state_size", "time_step_rank", "num_experts_per_tok",
          "expand", "num_attention_heads", "num_key_value_heads", "num_local_experts", "vocab_size")


def test_keys_and_names():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert harness.check_manifest(M) == []
    assert M["command"] == ["python3", "portbench/run.py"] and M["paths"] == ["portbench"]
    for x in M["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
    e2e = {x["name"] for x in M["end_to_end"]}
    assert "setup_s" in e2e
    for x in M["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert x["moves"] in e2e
    assert len(json.dumps(M)) < 64 * 1024


@pytest.mark.parametrize("name,ok", [("phi35moe-chat-prefill", True), ("mfu.train", True), ("_x", True),
                                     ("a b", False), ("a/b", False), ("-x", False), ("é", False), ("a" * 65, False)])
def test_name_rule(name, ok):
    assert bool(harness.NAME_RE.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [("tokens/s", True), ("%", True), ("GiB", True), ("ms", True),
                                     ("tokens per s", False), ("µs", False), ("a" * 17, False), ("", False)])
def test_unit_rule(unit, ok):
    assert bool(harness.UNIT_RE.match(unit)) is ok


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_each_cell_found_by_name(cell):
    w = next(x for x in M["workloads"] if x["name"] == cell)
    assert w["chips"] == 1
    run = harness.Run(cell, 7, 1.0, False, device="cpu")
    assert run.config["name"] == w["config"]
    harness.module("entries", run.workload["entry"])
    harness.module("traffic", run.mix["generator"])
    e2e = [x["name"] for x in harness.cell_metrics(M, cell, False)]
    layer = [x["name"] for x in harness.cell_metrics(M, cell, True)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for name in e2e + layer:
        assert callable(harness.module("metrics", name).read)


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    f = harness.load_json(ROOT / config["file"])
    assert f["name"] == config["name"] and f["source"] == config["source"]
    assert f["reduced"] == config["reduced"] == ["num_hidden_layers"]
    assert not set(config["reduced"]) & set(WIDTHS)
    assert f["published"]["num_hidden_layers"] > f["num_hidden_layers"]


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    """Copy the benchmark, add a cell, a mix and a metric as new files and
    manifest entries: the harness finds them, and no file it had changed."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    m = json.loads(json.dumps(M))
    mix = dict(harness.load_json(ROOT / "portbench/traffic/chat_1k.json"), median=2048)
    (tmp_path / "portbench/traffic/chat_2k.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/workloads/phi35moe-chat2k-prefill.json").write_text(
        (ROOT / "portbench/workloads/phi35moe-chat-prefill.json").read_text())
    (tmp_path / "portbench/metrics/prompt_count.py").write_text(
        "def read(run):\n    return float(len(run.records.get('requests', [])))\n")
    m["workloads"].append({"name": "phi35moe-chat2k-prefill", "config": "phi35moe-16of32", "traffic": "chat_2k",
                           "chips": 1, "why": "longer chat prompts"})
    m["per_layer"].append({"name": "prompt_count", "unit": "requests", "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "prefill_tokens_per_s",
                           "workloads": ["phi35moe-chat2k-prefill"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    run = harness.Run("phi35moe-chat2k-prefill", 7, 1.0, True, device="cpu", root=tmp_path)
    assert run.mix["median"] == 2048
    names = [x["name"] for x in harness.cell_metrics(run.manifest, run.cell, True)]
    assert names == ["prompt_count"]
    run.records["requests"] = [{}, {}]
    assert harness.module("metrics", "prompt_count", tmp_path).read(run) == 2.0
    assert all(p.read_bytes() == b for p, b in before.items())
