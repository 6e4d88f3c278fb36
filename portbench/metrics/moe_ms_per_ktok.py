"""``moe_ms_per_ktok``: device ms inside the program's ``moe.*`` profiler
ranges (as they show on the device timeline) per 1000 prompt tokens, read
from the requests served after the window with the host's operators
traced (``entries/prefill_sample.py``, ``RANGE_REQUESTS``)."""


def read(run):
    t = run.records.get("range_summary")
    if t is None or not run.records.get("range_tokens"):
        return None
    ns = t.time_in_ranges("moe.")
    if ns is None:
        return None
    return ns / 1e6 / (run.records["range_tokens"] / 1e3)
