"""Prefill then sample: one stream of prompts, served one at a time in order.

Each request is one ``make_prefill_step`` of a ``(1, L)`` prompt and one
``serving.topk_sample(..., backend="kernel")`` of its last position's
logits, and ends when the token id is on the host.  Every request of the
mix (``traffic/lognormal_requests.py``) is waiting when the window opens,
and the next is served as soon as the last is done.  Set-up makes the
weights from the seed, on the card, in the type they are served in, and
serves every length of the mix once, the longest first, greedy and
sampled in turn.  The window runs for ``--seconds``; with ``--trace 1``
the profiler records the device's activities over it, and then, with the
host's operators and the program's ranges, :data:`RANGE_REQUESTS` more
requests, from which the metrics that read ranges take their numbers
(recording every host operator in the window itself would slow the host
by about a third).

The check, once the window has closed and the peak memory is read: every
request's token against the program's own logits (``sampler_miss``: a
greedy request's token has the largest of them, a sampled one lies among
the top ``k``), then a sample of the window's requests (:class:`Sample`:
the first of the longest length and others drawn from the seed) against
the plain reference in float32 (TF32 off) over the same prompt
(:func:`compare`): the last position's logits, and the caches the
prefill returned, every layer's keys and values at every position of a
MoE model (the first ``cache_layers`` of the cell's file, where it names
them), every layer's final scan state of a Mamba model.  The sample's
caches are copied, as they are served, into a buffer on the card that
set-up allocates.  The cell's file names the numbers compared and their
limits.  The reference converts the benchmark's
weights a layer at a time.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import random
from typing import Dict, List, Optional

import torch

from portbench import weights
from portbench.harness import card, clock, module
from portbench.reference import model as ref


RANGE_REQUESTS = 8


def profiler(dev: str, host: bool):
    from torch.profiler import ProfilerActivity, profile

    if dev != "cuda":
        return profile(activities=[ProfilerActivity.CPU])
    return profile(activities=([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA])


def port_config(cfg: Dict):
    """The port's config for the configuration file, its widths held to the file's."""
    from repro_torch.configs import get_config

    pc = dataclasses.replace(get_config(cfg["port"]["arch"]), **cfg["port"]["options"])
    want = {"d_model": cfg["hidden_size"], "num_layers": cfg["num_hidden_layers"], "vocab_size": cfg["vocab_size"]}
    if cfg["family"] == "moe":
        want.update(num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
                    resolved_head_dim=cfg["head_dim"], d_ff=cfg["intermediate_size"],
                    num_experts=cfg["num_local_experts"], experts_per_token=cfg["num_experts_per_tok"],
                    capacity_factor=cfg["as_run"]["capacity_factor"], rope_theta=cfg["rope_theta"])
    else:
        want.update(d_inner=cfg["intermediate_size"], ssm_state=cfg["state_size"], ssm_conv=cfg["conv_kernel"],
                    dt_rank=cfg["time_step_rank"])
    want.update(rms_eps=cfg["as_run"]["rms_eps"], tie_embeddings=cfg["as_run"]["tie_word_embeddings"],
                dtype=cfg["as_run"]["dtype"])
    got = {k: getattr(pc, k) for k in want}
    if got != want:
        raise ValueError(f"the port's config differs from {cfg['name']}: {got} != {want}")
    return pc


def serve_fn(run, pc, params):
    """The timed path: ``serve(tokens (L,), greedy) -> (logits (1, V), caches, token (1,), events)``,
    the events (on the card) recorded when the logits and when the token are ready."""
    from repro_torch.serving import topk_sample
    from repro_torch.train import make_prefill_step

    prefill = make_prefill_step(pc)
    gen = torch.Generator(device=run.device)
    gen.manual_seed(run.seed % (1 << 63))
    k, temp = run.mix["top_k"], run.mix["temperature"]
    timed = run.device == "cuda"

    def serve(tokens: torch.Tensor, greedy: bool):
        logits, caches = prefill(params, {"tokens": tokens[None]})
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) if timed else None
        if timed:
            events[0].record()
        tok = topk_sample(logits, gen, k=k, temperature=0.0 if greedy else temp, backend="kernel")
        if timed:
            events[1].record()
        return logits, caches, tok, events

    return run.wrap("serve", serve)


CACHE_KEYS = {"moe": ("k", "v"), "ssm": ("ssm",)}


class Sample:
    """The requests the check compares with the reference: the first of the
    mix's longest length, and ``n - 1`` others drawn uniformly, from the
    seed, from every other request served (a reservoir).  Each of the ``n``
    slots holds its request's cache (:meth:`keep`) in a buffer on the device
    that set-up allocates once (:meth:`alloc`), so that keeping one is a copy
    on the card, and the peak memory, less the buffer, is the program's."""

    def __init__(self, reqs, n: int, seed: int):
        self.longest = next(i for i in range(len(reqs.lengths)) if reqs.length(i) == max(reqs.lengths))
        self.n, self.max_len = n, max(reqs.lengths)
        self.rng = random.Random(seed ^ 0x5EED)
        self.seen = 0
        self.slots: List[Optional[int]] = [None] * n  # the request each slot holds
        self.lens = [0] * n
        self.buf: Dict[str, torch.Tensor] = {}

    def slot(self, i: int) -> Optional[int]:
        """The slot request ``i``, served next, takes, or None (call once a request, in order)."""
        if i == self.longest:
            return 0
        self.seen += 1
        j = self.seen - 1 if self.seen < self.n else self.rng.randrange(self.seen)
        return j + 1 if j < self.n - 1 else None

    def alloc(self, cfg: Dict, layers: Optional[int], device) -> None:
        """The slots' buffers: a MoE model's keys and values of the first
        ``layers`` layers (every layer when None), a Mamba model's final scan
        states."""
        nl = min(layers or cfg["num_hidden_layers"], cfg["num_hidden_layers"])
        if cfg["family"] == "moe":
            shape = (self.n, nl, self.max_len, cfg["num_key_value_heads"], cfg["head_dim"])
            dtype = compute_dtype(cfg)
        else:
            shape, dtype = (self.n, nl, cfg["intermediate_size"], cfg["state_size"]), torch.float32
        self.buf = {key: torch.empty(shape, dtype=dtype, device=device) for key in CACHE_KEYS[cfg["family"]]}

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.buf.values())

    def keep(self, slot: int, i: int, caches: Dict) -> None:
        """Copy request ``i``'s prefill caches into ``slot``."""
        if set(caches) != {"sub0"}:
            raise ValueError(f"one group of layers expected, got {sorted(caches)}")
        for key, buf in self.buf.items():
            src = caches["sub0"][key][:buf.shape[1], 0]
            buf[slot, :, :src.shape[1]].copy_(src)
            self.lens[slot] = src.shape[1]
        self.slots[slot] = i

    def kept(self, logits: Dict[int, torch.Tensor]) -> Dict[int, tuple]:
        """``{i: (last-position logits, cache)}`` of the requests the slots
        hold, the cache one row a layer: ``k``, ``v`` ``(layers, L, kv, hd)``
        or ``ssm`` ``(layers, d_inner, state)``."""
        out = {}
        for slot, i in enumerate(self.slots):
            if i is not None:
                out[i] = (logits[i], {key: (buf[slot, :, :self.lens[slot]] if key in ("k", "v") else buf[slot])
                                      for key, buf in self.buf.items()})
        return out


def run(run) -> None:
    cfg = run.config
    pc = port_config(cfg)
    dev = run.device
    if dev == "cuda":
        card(run)
    params = weights.make(cfg, run.seed, dev, compute=compute_dtype(cfg))
    reqs = module("traffic", run.mix["generator"], run.root).make(run.mix, run.seed, cfg["vocab_size"])
    serve = serve_fn(run, pc, params)
    gen = torch.Generator(device=dev)
    gen.manual_seed((run.seed + 1) % (1 << 63))
    for j, n in enumerate(sorted(set(reqs.lengths), reverse=True)):  # every length once, the longest first
        serve(torch.randint(1, cfg["vocab_size"], (n,), generator=gen, device=dev), j % 2 == 0)[2].item()
    run.sample = Sample(reqs, run.workload["check"]["requests"], run.seed)
    run.sample.alloc(cfg, run.workload["check"].get("cache_layers"), dev)
    sync(dev)
    recs = window(run, reqs, serve)
    if run.trace and dev == "cuda":
        ranges(run, reqs, serve, len(recs))
    t = clock()
    check(run, reqs, recs, params)
    run.records["check_s"] = clock() - t


def ranges(run, reqs, serve, first: int) -> None:
    """:data:`RANGE_REQUESTS` requests after the window, traced with the host's operators."""
    from portbench.trace import summarise

    prof = profiler(run.device, host=True)
    with prof:
        with torch.profiler.record_function("portbench.window"):
            for i in range(first, first + RANGE_REQUESTS):
                serve(reqs.tokens(i, run.device), reqs.greedy(i))[2].item()
            sync(run.device)
    run.records["range_summary"] = summarise(prof)
    run.records["range_tokens"] = sum(reqs.length(i) for i in range(first, first + RANGE_REQUESTS))


def compute_dtype(cfg: Dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["as_run"]["dtype"]]


def sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def steady_host() -> set:
    """Pin the serving thread to one core and stop the cyclic collector for
    the window: the host sets the pace of one stream of prefills, and a
    thread moved between cores, or a collection of the set-up's objects,
    moved a run's rate by tens of percent.  Returns the thread's cores before."""
    cpus = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(cpus)})
    gc.collect()
    gc.freeze()
    gc.disable()
    return cpus


def window(run, reqs, serve) -> List[Dict]:
    dev = run.device
    prof = profiler(dev, host=False) if run.trace else None
    if prof is not None:
        prof.__enter__()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    recs: List[Dict] = []
    cpus = steady_host()
    t0 = clock()
    run.setup_s = t0 - run.t_start
    with torch.profiler.record_function("portbench.window"):
        i = 0
        while True:
            t_issue = clock()
            if t_issue - t0 >= run.seconds:
                break
            greedy = reqs.greedy(i)
            toks = reqs.tokens(i, dev)
            try:
                logits, caches, tok, events = serve(toks, greedy)
                token = int(tok.item())
                ok = 0 <= token < run.config["vocab_size"]
            except RuntimeError as e:  # counted as failed; the run goes on
                print(f"portbench: request {i} failed: {e}")
                logits, caches, token, events, ok = None, None, -1, None, False
            t_done = clock()
            slot = run.sample.slot(i) if ok else None
            if slot is not None:
                run.sample.keep(slot, i, caches)
            del caches
            recs.append({"i": i, "len": int(toks.shape[0]), "greedy": greedy, "t_issue": t_issue - t0,
                         "t_done": t_done - t0, "token": token, "ok": ok, "logits": logits, "events": events})
            i += 1
        sync(dev)
    gc.unfreeze()
    gc.enable()
    os.sched_setaffinity(0, cpus)
    if prof is not None:
        prof.__exit__(None, None, None)
        from portbench.trace import summarise

        run.trace_summary = summarise(prof) if dev == "cuda" else None
        del prof
    run.memory_peak_bytes = torch.cuda.max_memory_allocated() - run.sample.nbytes if dev == "cuda" else 0
    run.attempted = len(recs)
    run.failed = sum(not r["ok"] for r in recs)
    run.records.update(requests=[{k: r[k] for k in ("len", "t_issue", "t_done", "ok")} for r in recs])
    if dev == "cuda":
        run.records["sample_ms"] = [r["events"][0].elapsed_time(r["events"][1]) for r in recs if r["events"]]
    return recs


def check(run, reqs, recs: List[Dict], params: Dict) -> None:
    """The numbers that decide ``correct`` (see the module's doc)."""
    k = run.mix["top_k"]
    miss = 0
    for r in recs:
        if r["logits"] is None:
            continue
        row = r["logits"][0].float()
        v = row[r["token"]]
        kth = torch.topk(row, 1 if r["greedy"] else k).values[-1]
        miss += int(bool(v < kth))
    kept = run.sample.kept({i: recs[i]["logits"][0].float().clone() for i in run.sample.slots if i is not None})
    for r in recs:
        r["logits"] = None
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    ref.exact()
    numbers = {"sampler_miss": float(miss),
               **compare(run.config, params, reqs, kept, run.device)}
    run.checks = [(name, numbers[name], limit) for name, limit in run.workload["check"]["limits"].items()]


def _cache_gaps(cfg: Dict, cache: Dict[str, torch.Tensor], device):
    """A callback for the reference's layers and the gaps it collects, one a
    layer the cache holds, of the program's ``cache`` (:meth:`Sample.kept`)
    against the reference's.  For a MoE model the median over positions of the gap of
    each position's keys and values, ``|got - want| / |want|``, which the
    few tokens routed otherwise at a near tie do not move; for a Mamba
    model the gap of the final scan state."""
    gaps: List[float] = []

    def each(i: int, keep: Dict) -> None:
        if i >= next(iter(cache.values())).shape[0]:
            return
        if cfg["family"] == "moe":
            want = torch.cat([keep["k"], keep["v"]], -1).flatten(1)
            got = torch.cat([cache["k"][i], cache["v"][i]], -1)[:want.shape[0]].to(device).float().flatten(1)
            gaps.append(float(((got - want).norm(dim=-1) / want.norm(dim=-1)).median()))
        else:
            want = keep["ssm"][0]
            gaps.append(float((cache["ssm"][i].to(device).float() - want).norm() / want.norm()))

    return each, gaps


def compare(cfg: Dict, params: Dict, reqs, kept: Dict[int, tuple], device, detail=None) -> Dict[str, float]:
    """The numbers of the kept requests, ``{i: (last-position logits,
    cache)}`` (:meth:`Sample.kept`), against the reference over the same
    prompts.  A MoE model's
    reference gives a row for every routing of the last token that a near
    tie allows (``reference.model.last_logits_variants``), and each request
    reads the row nearest to the program's.  The logits' gaps are over the
    reference's standard deviation of the row.

    * ``logit_err``: the largest absolute gap of any logit, over the requests;
    * ``logit_rms_q25``: the nearest-rank 25th percentile, over the requests,
      of the gaps' root mean square;
    * ``cache_gap``: the largest, over the requests and the layers the
      cache holds, of the cache's gap (:func:`_cache_gaps`): every kept
      request held at every position of those layers.

    ``detail``, a list, gets each request's readings."""
    errs, rmss, cgaps = [], [], []
    for i, (logits, cache) in kept.items():
        tokens = reqs.tokens(i, device)
        each, layer_gaps = _cache_gaps(cfg, cache, device)
        want = (ref.last_logits_variants(cfg, params, tokens, each_layer=each) if cfg["family"] == "moe"
                else ref.last_logits(cfg, params, tokens, each_layer=each)[None])
        sd = float(want[0].std())
        diff = logits.to(device)[None] - want
        errs.append(float(diff.abs().amax(-1).min()) / sd)
        rmss.append(float(diff.square().mean(-1).sqrt().min()) / sd)
        cgaps.append(max(layer_gaps))
        if detail is not None:
            detail.append({"i": i, "len": int(tokens.shape[0]), "max": errs[-1], "rms": rmss[-1],
                           "cache": layer_gaps, "variants": int(want.shape[0])})
    q25 = sorted(rmss)[max(0, math.ceil(0.25 * len(rmss)) - 1)] if rmss else 0.0
    return {"logit_err": max(errs, default=0.0), "logit_rms_q25": q25, "cache_gap": max(cgaps, default=0.0)}
