"""The harness end to end on the CPU at tiny sizes: a sound run is correct, a run
with its timed path broken is not, and a run without a card refuses."""

import json
import subprocess
import sys

import pytest
import torch

import portbench_tiny as tiny
from portbench import control, harness


def _go(run):
    harness.execute(run)
    return run


@pytest.mark.parametrize("cell", ["phi35moe-chat-prefill", "falconmamba-doc-prefill", "falconmamba-pack-train"])
def test_sound_run_is_correct(cell):
    run = _go(tiny.run(cell))
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    assert [c[0] for c in run.checks] == list(run.workload["check"]["limits"])


def _altered_token(name, fn):
    def serve(tokens, greedy):
        logits, caches, tok, ev = fn(tokens, greedy)
        return logits, caches, (tok + 1) % logits.shape[-1], ev

    return serve


def _dropped_layer(name, fn):
    """The answer altered where it is produced: the logits of a model that skipped its last layer's output."""
    def serve(tokens, greedy):
        logits, caches, tok, ev = fn(tokens, greedy)
        return logits + 0.5 * logits.std() * torch.randn_like(logits), caches, tok, ev

    return serve


def _altered_cache(name, fn):
    """Every layer's cache altered past the sequence's first quarter, the last position's logits left as they were."""
    def serve(tokens, greedy):
        logits, caches, tok, ev = fn(tokens, greedy)
        for key, t in caches["sub0"].items():
            if key in ("k", "v"):
                t[:, :, t.shape[2] // 4:] *= 1.5
            else:
                t *= 1.5
        return logits, caches, tok, ev

    return serve


@pytest.mark.parametrize("cell", ["phi35moe-chat-prefill", "falconmamba-doc-prefill"])
@pytest.mark.parametrize("fault", [_altered_token, _dropped_layer, _altered_cache],
                         ids=["token_altered", "logits_altered", "cache_altered"])
def test_broken_serving_is_not_correct(fault, cell):
    run = tiny.run(cell)
    run.wrap = fault
    assert not _go(run).correct


@pytest.mark.parametrize("fault", [control.unchanged, control.half_batch], ids=["state_unchanged", "half_batch"])
def test_broken_training_is_not_correct(fault):
    run = tiny.run("falconmamba-pack-train")
    run.workload["check"] = {"limits": {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4}}
    run.wrap = fault
    assert not _go(run).correct


def test_no_card_refuses():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "phi35moe-chat-prefill", "--seed",
                          str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("served", [3, 40, 500])
def test_sample_holds_the_longest_and_draws_the_rest(served):
    """The check's sample: the first request of the longest length and n - 1
    others, drawn from every request served, the same for the same seed."""
    mix = dict(harness.load_json(harness.find("traffic", "chat_1k")), **tiny.PREFILL_MIX)
    reqs = harness.module("traffic", mix["generator"]).make(mix, 5, 256)
    ps = harness.module("entries", "prefill_sample")

    def kept(seed):
        sample = ps.Sample(reqs, 6, seed)
        for i in range(served):
            slot = sample.slot(i)
            if slot is not None:
                sample.slots[slot] = i
        return sample.slots

    a, b = kept(11), kept(11)
    longest = ps.Sample(reqs, 6, 11).longest
    held = [i for i in a if i is not None]
    assert a == b and len(held) == min(6, served) and (longest in held) == (longest < served)
    assert reqs.length(longest) == max(reqs.lengths)
    if served == 500:
        assert max(held) > 100 and a != kept(12)


def test_result_line_shape():
    out = harness.execute(tiny.run("falconmamba-doc-prefill"))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(out)[-1] == "checks"
    assert json.loads(json.dumps(out)) == out
