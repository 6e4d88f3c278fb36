"""Where the time goes: decode steps, samples, a prefill and a train step, traced.

    PYTHONPATH=src python -m repro_torch.launch.profile

Runs on the card only.  For full-width tinyllama-1.1b with random weights,
at the serving shapes of ``chip_smoke.py`` (batch 2, max_seq 64): one
decode step and one top-k sample of one vocab row through the K4 path.
Then for full-width falcon-mamba-7b (fused scan, random weights), at the
shapes of ``chip_smoke.py``'s SSM phase: one ``make_prefill_step`` of a
(1, 32768) prompt (64 K9 launches) and one ``make_decode_step`` with its
top-k sample.  Then full-width hymba-1.5b (fused scan, random weights),
one ``make_prefill_step`` of a (1, 16384) prompt (32 K9 launches; every
layer on the blockwise attention, the prompt being past
``FULL_ATTENTION_THRESHOLD``), split by kind of device operation:
attention's einsums, the other matrix products, softmax, K9, the
elementwise passes, copies and reductions, the shapes of ``chip_smoke.py``'s
attention phase.  Then full-width moonshot-v1-16b-a3b (all 48 layers,
random weights, ``moe_dispatch="merge_path_pallas"``), one
``make_prefill_step`` of a (1, 4096) prompt (one S1 and 6 K4 launches a
layer for the routing sort), split the same way with the MoE layer's
kinds apart: S1, K4, the expert einsums, the dispatch and combine
gathers and scatters, and the routing, the shapes of ``chip_smoke.py``'s
MoE phase.  Last, one ``make_train_step`` of falcon-mamba-7b at its
published widths cut to 16 of 64 layers (fused scan, float32 masters from
seed 0) on a (1, 4096) batch of ``SyntheticLMPipeline``, the shapes of
``chip_smoke.py``'s training phase.
It prints, per phase:

* wall ms per call (host clock, ended by ``torch.cuda.synchronize()``);
* device busy ms per call: the sum of CUDA kernel and copy times that
  ``torch.profiler`` records, and the idle share ``1 - busy / wall``;
* host us per launch: wall time over the number of device activities;
* the top device activities by total time;
* for the train step, the share of the device time spent in K10
  (``ssm_scan_bwd``) and in K9 (``ssm_scan_kernel``), the device time by
  kind of kernel, and the backward's device time by the autograd node
  that launched it: the profiler's own ``autograd::engine::evaluate_function``
  ranges, each holding its node's kernels, the sums into the gradients it
  feeds, and the forward that remat recomputes where the node unpacks a
  dropped activation.  What lies outside them is the forward and the
  optimizer.

Where the profiler records no device time, it says "not measured".
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import TrainConfig, get_config
from repro_torch.data.pipeline import PipelineConfig, SyntheticLMPipeline
from repro_torch.models import forward_decode, init_caches, init_params
from repro_torch.models.transformer import _dtype
from repro_torch.serving import topk_sample
from repro_torch.telemetry import WALL
from repro_torch.train import init_train_state, make_decode_step, make_prefill_step, make_train_step
from repro_torch.train.steps import _cast

ARCH, BATCH, MAX_SEQ, ITERS = "tinyllama-1.1b", 2, 64, 5
SSM_ARCH, SSM_PROMPT = "falcon-mamba-7b", 32768
HYBRID_ARCH, HYBRID_PROMPT = "hymba-1.5b", 16384
MOE_ARCH, MOE_PROMPT = "moonshot-v1-16b-a3b", 4096
TRAIN_LAYERS, TRAIN_SEQ = 16, 4096  # 16 of 64 layers: the float32 masters and moments of all 64 need 112 GB


def _trace(fn, iters: int) -> dict:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = WALL.now()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = (WALL.now() - t0) / 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # the device activities; a range of the model's code also shows on the device timeline, around its kernels
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith(_RANGES)]
    busy_ms = sum(e.device_time_total for e in events) / 1e3 / iters  # profiler times are us
    top: dict = {}
    for e in events:
        top[e.name] = top.get(e.name, 0.0) + e.device_time_total / 1e3 / iters
    nodes: dict = {}
    linked = []  # (kernel, the operator that launched it, the model's ranges around it (innermost first), ms)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            if e.name.startswith(_NODE):
                name = e.name[len(_NODE):]
                nodes[name] = nodes.get(name, 0.0) + e.device_time_total / 1e3 / iters
            if e.kernels:
                ranges = tuple(a.name for a in _ancestors(e) if a.name.startswith(_RANGES))
                linked += [(k.name, e.name, ranges, k.duration / 1e3 / iters) for k in e.kernels]
    return {
        "wall_ms": wall_ms,
        "busy_ms": busy_ms if events else None,
        "launches": len(events) / iters,
        "top": sorted(top.items(), key=lambda kv: -kv[1])[:6],
        "by_name": top,
        "by_node": nodes,
        "linked": linked,
    }


_NODE = "autograd::engine::evaluate_function: "
# the prefixes of the profiler ranges the model opens while the profiler records:
# models/moe.py's, and model.encoder, model.cross and model.mlp (models/model.py,
# transformer.py, layers.py)
_RANGES = ("moe.", "model.")


def _ancestors(e):
    """``e`` and the CPU ranges that enclose it, innermost first."""
    while e is not None:
        yield e
        e = e.cpu_parent


def _report(name: str, r: dict) -> None:
    if r["busy_ms"] is None:
        print(f"{name}: wall {r['wall_ms']:.3f} ms; device busy: not measured")
        return
    print(f"{name}: wall {r['wall_ms']:.3f} ms, device busy {r['busy_ms']:.3f} ms, "
          f"idle share {1 - r['busy_ms'] / r['wall_ms']:.3f}, {r['launches']:.0f} device activities, "
          f"host {r['wall_ms'] * 1e3 / max(1.0, r['launches']):.1f} us per activity")
    for kname, ms in r["top"]:
        print(f"    {ms:9.4f} ms  {kname[:110]}")


def profile_train_step(cfg, tcfg: TrainConfig, state: dict, batch: dict) -> dict:
    """Trace one ``make_train_step`` step on ``state`` (updated in place:
    the warm-up and timed steps step it on) and ``batch``: the report of
    :func:`_trace`, with the device ms of K10 and K9 and their shares of
    the busy time (None where the profiler recorded no device time)."""
    step_fn = make_train_step(cfg, tcfg)
    holder = {"state": state}

    def step():
        holder["state"], _ = step_fn(holder["state"], batch)

    r = _trace(step, 1)
    for key, pattern in (("k10", "ssm_scan_bwd"), ("k9", "ssm_scan_kernel")):
        ms = sum(v for k, v in r["by_name"].items() if pattern in k)
        r[f"{key}_ms"] = ms if r["busy_ms"] else None
        r[f"{key}_share"] = ms / r["busy_ms"] if r["busy_ms"] else None
    return r


# device activities by kind, matched on their names in this order (the first match wins)
KINDS = (
    ("K10", ("ssm_scan_bwd",)),
    ("K9", ("ssm_scan_kernel",)),
    ("S1", ("sort_tiles_kernel",)),
    ("K3/K4", ("sort_round_seg_kernel",)),
    ("matrix products", ("gemm", "gemv", "nvjet", "cutlass", "sm90_")),
    ("copies", ("direct_copy", "Memcpy", "Memset")),
    ("softmax", ("softmax", "SoftMax")),
    ("reductions", ("reduce_kernel", "logsumexp")),
    ("elementwise", ("elementwise",)),
)


def kind_of(name: str) -> str:
    """The kind (``KINDS``) of a device activity, by its name; "other" if none."""
    return next((k for k, pats in KINDS if any(p in name for p in pats)), "other")


def by_kind(by_name: dict) -> dict:
    """Device ms per kind of activity (``KINDS``; the rest under "other")."""
    out = dict.fromkeys([k for k, _ in KINDS] + ["other"], 0.0)
    for name, ms in by_name.items():
        out[kind_of(name)] += ms
    return out


def report_train(r: dict) -> None:
    _report("train step", r)
    if r["busy_ms"] is None:
        print("    K10 and K9 shares: not measured")
        return
    print(f"    K10 (ssm_scan_bwd, both passes) {r['k10_ms']:.3f} ms = {r['k10_share']:.3f} of the device time; "
          f"K9 (ssm_scan_kernel) {r['k9_ms']:.3f} ms = {r['k9_share']:.3f}")
    print("    by kind: " + ", ".join(f"{k} {ms:.3f} ms ({ms / r['busy_ms']:.3f})"
                                       for k, ms in by_kind(r["by_name"]).items()))
    bwd = sum(r["by_node"].values())
    print(f"    backward nodes (remat's recompute included) {bwd:.3f} ms, the rest (forward, optimizer) "
          f"{r['busy_ms'] - bwd:.3f} ms; top nodes: " + ", ".join(
              f"{k} {ms:.3f} ms" for k, ms in sorted(r["by_node"].items(), key=lambda kv: -kv[1])[:8]))


# the kinds of a prefill: each kernel by the operator that launched it and the
# model's ranges around it (the encoder's whole, then cross-attention, a MoE
# layer's parts and the MLP), the rest by its name
PREFILL_KINDS = ("S1", "K4", "K3", "K9", "encoder (all of it)", "cross-attention", "MoE expert einsums",
                 "MoE dispatch and combine (gathers, scatters)", "MoE routing (router, top-k, positions)", "MLP",
                 "attention einsums (aten::bmm)", "other matrix products", "softmax", "elementwise", "copies",
                 "reductions", "other")


def prefill_kind(kernel: str, op, ranges=()) -> str:
    """The ``PREFILL_KINDS`` entry of one kernel launched by ``op`` inside
    the model's profiler ranges ``ranges`` (innermost first; ``op`` None
    where the profiler linked the kernel to no operator)."""
    kind = kind_of(kernel)
    if kind == "K3/K4":  # the template's second argument: true for K4 (with values), false for K3
        return "K4" if "true" in kernel.split("sort_round_seg_kernel<", 1)[-1].split(">", 1)[0] else "K3"
    if kind in ("S1", "K9"):
        return kind
    if "model.encoder" in ranges:
        return "encoder (all of it)"
    if "model.cross" in ranges:
        return "cross-attention"
    moe_range = next((r for r in ranges if r.startswith("moe.")), None)
    if moe_range == "moe.experts" and kind == "matrix products":
        return "MoE expert einsums"
    if moe_range in ("moe.dispatch", "moe.combine"):
        return "MoE dispatch and combine (gathers, scatters)"
    if moe_range in ("moe.route", "moe.positions", "moe.sort"):
        return "MoE routing (router, top-k, positions)"
    if "model.mlp" in ranges:
        return "MLP"
    if op == "aten::bmm":
        return "attention einsums (aten::bmm)"
    return "other matrix products" if kind == "matrix products" else kind


def profile_prefill(prefill, params: dict, batch: dict, cache_len: int) -> dict:
    """Trace one ``make_prefill_step`` call on ``batch`` (its tokens, with
    a VLM's ``prefix_emb`` or an audio model's ``frames``): the report of
    :func:`_trace` with the device ms by kind (:data:`PREFILL_KINDS`): S1,
    K3, K4 and K9, the audio encoder, the decoder's cross-attention, a MoE
    layer's expert products, its dispatch and combine and its routing, the
    dense MLP (by the ranges the model opens while the profiler records),
    attention's einsums (the kernels ``aten::bmm`` launches itself), the
    other products and the rest by name.  A kernel the profiler linked to
    no operator (S1 and K4, which ``ctypes`` launches) is classed by its
    name alone."""
    r = _trace(lambda: prefill(params, batch, cache_len), 1)
    kinds = dict.fromkeys(PREFILL_KINDS, 0.0)
    unlinked = dict(r["by_name"])
    for kernel, op, ranges, ms in r["linked"]:
        kinds[prefill_kind(kernel, op, ranges)] += ms
        unlinked[kernel] = unlinked.get(kernel, 0.0) - ms
    for kernel, ms in unlinked.items():
        kinds[prefill_kind(kernel, None)] += ms
    r["kinds"] = kinds
    return r


def report_prefill(name: str, r: dict) -> None:
    _report(name, r)
    if r["busy_ms"] is None:
        print("    by kind: not measured")
        return
    print("    by kind: " + ", ".join(f"{k} {ms:.3f} ms ({ms / r['busy_ms']:.3f})" for k, ms in r["kinds"].items()
                                       if ms))


def main_train() -> None:
    cfg = dataclasses.replace(get_config(SSM_ARCH), ssm_backend="fused", num_layers=TRAIN_LAYERS)
    tcfg = TrainConfig(z_loss=1e-4, grad_clip=1.0)
    state = init_train_state(cfg, tcfg, seed=0, device="cuda")
    state["step"].fill_(1)
    batch = SyntheticLMPipeline(cfg, 1, TRAIN_SEQ, PipelineConfig(seed=0)).batch_at(1)
    print(f"{cfg.name} at full width, {TRAIN_LAYERS} of 64 layers, fused scan, batch (1, {TRAIN_SEQ})")
    report_train(profile_train_step(cfg, tcfg, state, batch))


def main() -> None:
    cfg = get_config(ARCH)
    params = init_params(cfg, seed=0, device="cuda")
    caches = init_caches(cfg, BATCH, MAX_SEQ, device="cuda")
    tok = torch.ones((BATCH, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((BATCH,), 8, dtype=torch.int64, device="cuda")
    logits, _ = forward_decode(cfg, params, caches, tok, pos)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print(f"card: {torch.cuda.get_device_name(0)}; {cfg.name} full width, batch {BATCH}")
    _report("decode step", _trace(lambda: forward_decode(cfg, params, caches, tok, pos), ITERS))
    _report("top-k sample (1, V)", _trace(
        lambda: topk_sample(logits[:1], gen, k=40, temperature=0.8, backend="kernel"), ITERS))
    x = torch.zeros(16, device="cuda")
    _report("tiny op (x.add_(1))", _trace(lambda: x.add_(1), 200))
    del params, caches, logits

    cfg = dataclasses.replace(get_config(SSM_ARCH), ssm_backend="fused")
    params = _cast(init_params(cfg, seed=0, device="cuda"), _dtype(cfg))  # once: the steps then copy nothing
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    tokens = torch.randint(1, cfg.vocab_size, (1, SSM_PROMPT), generator=gen, device="cuda")
    print(f"{cfg.name} full width, fused scan, prompt (1, {SSM_PROMPT})")
    _report("prefill", _trace(lambda: prefill(params, {"tokens": tokens}), 1))
    logits, caches = prefill(params, {"tokens": tokens})
    tok = torch.ones((1, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((1,), SSM_PROMPT, dtype=torch.int64, device="cuda")

    def step():
        out, _ = decode(params, caches, tok, pos)
        topk_sample(out, gen, k=40, temperature=0.8, backend="kernel")

    _report("decode step with its top-k sample", _trace(step, ITERS))
    del params, caches, logits
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config(HYBRID_ARCH), ssm_backend="fused")
    params = _cast(init_params(cfg, seed=0, device="cuda"), _dtype(cfg))
    tokens = torch.randint(1, cfg.vocab_size, (1, HYBRID_PROMPT), generator=gen, device="cuda")
    print(f"{cfg.name} full width, fused scan, prompt (1, {HYBRID_PROMPT})")
    report_prefill("prefill",
                   profile_prefill(make_prefill_step(cfg), params, {"tokens": tokens}, HYBRID_PROMPT + 16))
    del params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config(MOE_ARCH), moe_dispatch="merge_path_pallas")
    params = _cast(init_params(cfg, seed=0, device="cuda"), _dtype(cfg))
    tokens = torch.randint(1, cfg.vocab_size, (1, MOE_PROMPT), generator=gen, device="cuda")
    print(f"{cfg.name} full width, {cfg.num_layers} layers, merge_path_pallas dispatch, prompt (1, {MOE_PROMPT})")
    report_prefill("prefill", profile_prefill(make_prefill_step(cfg), params, {"tokens": tokens}, MOE_PROMPT + 16))
    del params
    torch.cuda.empty_cache()
    main_train()


if __name__ == "__main__":
    main()
