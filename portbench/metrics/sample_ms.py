"""``sample_ms``: the mean, over the window's requests, of the ms from the
prefill's logits being ready to the sampled token being ready, by two CUDA
events around ``topk_sample``."""


def read(run):
    ms = run.records.get("sample_ms")
    return sum(ms) / len(ms) if ms else None
