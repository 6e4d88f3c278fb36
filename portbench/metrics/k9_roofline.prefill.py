"""``k9_roofline.prefill``: the bound of the traced requests' K9 launches
(one a layer, ``(1, L, d_inner, state)``; the largest of bytes at the HBM
rate, float32 operations, and exponentials at the SFU rate) over K9's
summed kernel time, in %."""

from portbench import counts


def read(run):
    t = run.trace_summary
    reqs = run.records.get("requests", [])
    cfg = run.config
    if t is None or not reqs or cfg["family"] != "ssm":
        return None
    ns = sum(v for name, v in t.by_name().items() if counts.kind_of(name) == "K9")
    if not ns:
        return None
    di, st = cfg["intermediate_size"], cfg["state_size"]
    bound = sum(cfg["num_hidden_layers"] * counts.bound_s(counts.k9_counts(1, r["len"], di, st)) for r in reqs)
    return 100.0 * bound / (ns / 1e9)
