"""``k10_roofline.train``: the bound of the traced steps' K10 launches (one a
layer, ``(B, S, d_inner, state)`` with checkpoints every 32 steps; the
function's own inputs and outputs) over K10's summed kernel time (its
kernel and its reduction), in %."""

from portbench import counts

CHUNK = 32  # the checkpoint interval K10 reads


def read(run):
    t = run.trace_summary
    steps = run.records.get("steps", [])
    cfg = run.config
    if t is None or not steps:
        return None
    ns = sum(v for name, v in t.by_name().items() if counts.kind_of(name) == "K10")
    if not ns:
        return None
    rows, seq = run.records["shape"]
    c = counts.k10_counts(rows, seq, cfg["intermediate_size"], cfg["state_size"], CHUNK)
    return 100.0 * len(steps) * cfg["num_hidden_layers"] * counts.bound_s(c) / (ns / 1e9)
