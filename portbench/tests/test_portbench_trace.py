"""The idle share, the time in ranges, the gaps and the p95 on synthetic traces."""

import pytest

from portbench import harness
from portbench.trace import Summary, covered, overlap, union

W = harness.module("metrics", "_window")


def test_union_counts_overlaps_once():
    assert union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]
    assert covered([(0, 10), (2, 3), (5, 15)]) == 15


def test_idle_share_from_one_window():
    ops = [("gemm", 0, 40), ("elementwise", 30, 50), ("gemm", 70, 100)]  # 20 ns idle of 100
    s = Summary(window=(0, 100), ops=ops, device_ranges=[])
    assert s.busy_ns == 80 and s.window_ns == 100
    run = type("R", (), {"trace_summary": s, "records": {"requests": [{}]}})()
    assert harness.module("metrics", "idle_share.prefill").read(run) == pytest.approx(20.0)


def test_time_inside_ranges():
    ops = [("a", 0, 10), ("b", 10, 30), ("c", 40, 60)]
    ranges = [("moe.experts", 5, 35), ("moe.sort", 20, 25), ("model.mlp", 40, 60)]
    s = Summary(window=(0, 60), ops=ops, device_ranges=ranges)
    assert s.time_in_ranges("moe.") == 5 + 20
    assert s.time_in_ranges("attn.") is None
    assert overlap(ops, [(0, 100)]) == 50


def test_gaps_named_by_the_host():
    ops = [("k", 0, 10), ("k", 50, 60), ("k", 65, 100)]
    host = [("portbench.window", 0, 100), ("aten::item", 8, 55), ("aten::copy_", 9, 12), ("aten::add", 59, 64)]
    s = Summary(window=(0, 100), ops=ops, device_ranges=[], host=host)
    assert s.gaps() == [("host in aten::copy_", 40), ("host in aten::add", 5)]
    b = s.breakdown()
    assert b["device_ops"] == [["k", 55e-9]] and len(b["idle_gaps"]) == 2


def test_p95_nearest_rank():
    assert W.p95(list(range(1, 101))) == 95
    assert W.p95(list(range(1, 21))) == 19
    assert W.p95([3.0]) == 3.0 and W.p95([]) is None


def test_rates_take_all_the_work_and_all_the_time():
    """The window's requests over the time until the last was done; a failed one adds time and no work."""
    run = type("R", (), {"seconds": 2.0, "device": "cuda", "root": harness.ROOT, "config": {}, "records": {
        "requests": [{"len": 100, "t_issue": 0.0, "t_done": 1.0, "ok": True},
                     {"len": 300, "t_issue": 1.0, "t_done": 1.9, "ok": True},
                     {"len": 700, "t_issue": 1.9, "t_done": 2.5, "ok": True},
                     {"len": 50, "t_issue": 2.5, "t_done": 2.75, "ok": False}]}})()
    assert harness.module("metrics", "prefill_tokens_per_s").read(run) == pytest.approx(1100 / 2.75)
    assert harness.module("metrics", "service_p95_ms").read(run) == 2000.0
    run.records["requests"].pop()
    assert harness.module("metrics", "service_p95_ms").read(run) == pytest.approx(1000.0)
