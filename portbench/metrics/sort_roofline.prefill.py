"""``sort_roofline.prefill``: the byte bound of the traced requests' sorts on
S1 and K4 (every MoE layer's routing sort of ``2 L`` int32 keys with int32
values, and the sampler's top-k of a bfloat16 vocab row) at the HBM rate,
over S1's and K4's summed kernel time, in %."""

from portbench import counts


def read(run):
    t = run.trace_summary
    reqs = run.records.get("requests", [])
    cfg = run.config
    if t is None or not reqs or cfg["family"] != "moe":
        return None
    ns = sum(v for name, v in t.by_name().items() if counts.kind_of(name) == "S1" or counts.is_k4(name))
    if not ns:
        return None
    k = cfg["num_experts_per_tok"]
    nbytes = sum(cfg["num_hidden_layers"] * counts.kv_sort_bytes(k * r["len"])
                 + counts.topk_bytes(cfg["vocab_size"], run.mix["top_k"], 2) for r in reqs)
    return 100.0 * (nbytes / counts.PEAKS["hbm_bytes"]) / (ns / 1e9)
