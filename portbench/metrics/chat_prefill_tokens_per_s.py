"""``chat_prefill_tokens_per_s``: ``prefill_tokens_per_s`` of the chat cell, a
metric of its own so that the host-bound chat prefill's spread (its bound)
does not widen the document cell's."""

from portbench.harness import module


def read(run):
    return module("metrics", "prefill_tokens_per_s", run.root).read(run)
