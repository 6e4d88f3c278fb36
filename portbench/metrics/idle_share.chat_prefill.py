"""``idle_share.chat_prefill``: ``idle_share.prefill`` of the chat cell, beside its own rate."""

from portbench.harness import module


def read(run):
    return module("metrics", "idle_share.prefill", run.root).read(run)
