"""``service_p95_ms``: the nearest-rank 95th percentile, over every request
issued in the window, of the ms from its issue to its token id on the host
(host clock; with every request queued, its service time); a request that
failed counts as the whole window's length."""

from portbench.harness import module


def read(run):
    w = module("metrics", "_window", run.root)
    reqs = run.records.get("requests", [])
    if not reqs or not w.on_card(run):
        return None
    return w.p95([(r["t_done"] - r["t_issue"]) * 1e3 if r["ok"] else run.seconds * 1e3 for r in reqs])
