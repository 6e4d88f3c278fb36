#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    PYTHONPATH=src python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. card: the name and power limit as ``nvidia-smi`` reports them;
2. build: every kernel under ``src/repro_torch/kernels/csrc`` with ``nvcc``,
   one process per source, all started together; each source's build time
   and what ``ptxas -v`` says of its kernels;
3. K4 against its plain version on the card, bit for bit: every wide
   round of the sampler's sort (m = 32768 + 512, widths 512 ... 16384) on
   int16 and int32 keys drawn from adversarial rows, widths of half, one
   and two of K4's spans over three pairs of the widest, pair widths 1 ...
   8 at tiles 2 ... 16, every wide round of (64, 32768) int16 rows (timed
   too), then whole top-k sorts at (1, 32000) and (64, 32000); with
   CUDA-event times of the kernel, the plain version and one stable
   ``torch.sort`` (a yardstick the port never calls); S1 with values on one
   sampled row's keys;
4. merge and sort at 2 x 2^24 elements (:func:`phase_merge_sort`): K1, K2,
   K3 and the tile sort S1 (keys alone and with values) against their plain
   versions, bit for bit, over adversarial input families, K1 and K2 also
   at the edges of their block span (views off a 16-byte boundary,
   lopsided lengths, disjoint ranges, totals around one span); the whole path
   (``ops.merge``, ``ops.merge_kv``, ``ops.sort``, ``ops.sort_batched``)
   driven once with the launch counts read; CUDA-event times of each
   kernel, its plain version and one PyTorch call, and of K1 for each key
   dtype; ``ops.sort`` beside one stable ``torch.sort`` and split into S1,
   K3's rounds and the rest; K3 and K4 on keys (and values) one element
   off a 16-byte boundary; K1, K3 and K4 on unsorted inputs, which must
   not fault; a float32 ``ops.sort`` and an int32 ``ops.sort_kv`` of 2^24
   against a stable ``torch.sort``, timed beside it and split into S1 with
   values, K4's wide rounds and the rest, the float sort's rest pass by
   pass;
5. the batched, ragged and k-way merges (:func:`phase_batched`): K5, K6,
   K7 and K8 against their plain versions, bit for bit, at (64, 2^18) +
   (64, 2^18) over every key dtype, ragged lengths with edge rows, a short
   last tile, a (T, S) sweep and the benchmark's small rows; K5-K8 at
   the edges of their row spans (totals around ``MERGE_ROWS_SPAN`` and
   ``MERGE_ROWS_KV_SPAN``, rows and views off a 16-byte boundary, 2-byte
   keys with 4-byte values, lopsided and disjoint rows, ragged totals on a
   seam, unsorted rows that must not fault) and ``ops.merge_k`` at k = 3
   and 6 over odd widths;
   ``ops.merge_k`` (3 K7 rounds each) on k = 8 runs of 2^21, on the sample
   sort's combine and on k = 5; the ragged top-k and the samplers' masked
   vocab; the path driven once with the launch counts read; CUDA-event
   times of each kernel, its plain version, one PyTorch call and the
   whole ``ops`` call;
6. serving: ``ServingEngine`` on tinyllama-1.1b at full width (random
   weights from a seed), 4 requests with top-k sampling; the K4 launch
   count must be 6 per sampled token, S1's 1.  Then the reduced config on the card
   against the same weights on the CPU;
7. SSM (:func:`phase_ssm`): K9, the fused selective scan, against its plain
   version at falcon-mamba's layer shapes (D = 8192, state 16) and at edge
   shapes; falcon-mamba-7b at full width (random weights from a seed, fused
   scan) prefilled on a (1, 32768) prompt with ``make_prefill_step`` (K9
   once per layer: 64 launches), then 16 tokens sampled with top-k 40 on S1
   and K4 through ``make_decode_step``; K9 on layer 0's own inputs, twice
   bit-identical, with and without checkpoints; a bfloat16 x of rows that
   break K9's 16-byte rule raises; prefill against stepping at full width;
   the reduced config on the card against the CPU; CUDA-event times of K9
   and its plain version;
8. training (:func:`phase_train`): K10, the selective scan's backward,
   against its plain version at falcon-mamba's layer shapes (D = 8192,
   state 16) and at edge shapes, two launches bit-identical; the
   autograd Function (K9 forward, K10 backward) against autograd through
   the plain scan; fused against plain-scan train steps at full width (2
   layers); falcon-mamba-7b at full width cut to 16 of 64 layers trained
   3 steps on (1, 4096) batches through ``make_train_step`` (K10 once per
   layer and step, K9 twice); K10 on layer 0's own operands with its
   times, and a traced step; the reduced config on the card against the
   CPU;
9. attention (:func:`phase_attention`): hymba-1.5b at full width (random
   weights from a seed, fused scan) prefilled on a (1, 16384) prompt
   through ``make_prefill_step`` (past the dense threshold: every layer
   on the blockwise attention, the window layers' rings wrapped; K9 once
   per layer, 32 launches), then 16 tokens sampled with top-k 40 (6 K4
   and 1 S1 launches each); K9 on layer 0's own inputs against its plain
   version, timed at hymba's width; the prefill traced by kind of device
   operation; prefill against stepping on layer 0's k, v, conv and ssm
   caches; hymba trained 3 steps of (1, 4096) at all 32 layers with
   ``remat_policy="full"`` (64 K9 and 32 K10 launches a step) and 3 with
   ``"dots"``; K10 on layer 0's own operands, timed; tinyllama-1.1b at
   full width prefilled on (1, 4096) (the dense path), against stepping,
   and trained 3 steps of (1, 4096); the reduced hymba and tinyllama on
   the card against the CPU; gemma3-12b at full width served by
   ``ServingEngine`` (2 requests at batch 1; 9 K4 launches and 1 S1 per
   sampled token);
10. MoE (:func:`phase_moe`): moonshot-v1-16b-a3b at full width and all 48
    layers (random weights from a seed, ``moe_dispatch="merge_path_pallas"``)
    prefilled on a (1, 4096) prompt through ``make_prefill_step`` (each
    layer's routing sort of 24576 slots: one S1 launch and 6 K4 rounds),
    then 16 tokens sampled with top-k 40 through ``make_decode_step``
    (each decode step one S1 launch a layer at chunk 8, each sample one S1
    and 9 K4); S1 and K4 on layer 0's own routing keys bit for bit against
    their plain versions, the three dispatch modes' positions equal, with
    CUDA-event times of the dispatch, S1, K4 and a stable ``torch.sort`` of
    the same keys; two prefills bit-identical; the prefill traced by kind;
    prefill against stepping on layer 0's k and v; moonshot trained 3
    steps of (1, 4096) at 4 of 48 layers; ``moe_apply``'s gradients on the
    kernel route and the core route bit-identical; phi3.5-moe-42b-a6.6b at
    full width cut to 8 of 32 layers prefilled and sampled; the reduced
    moonshot and phi3.5-moe on the card against the CPU;
11. distributed (:func:`phase_distributed`): the distributed merges,
    the sample sort and the top-k of ``repro_torch.core.distributed`` at
    world size 1 over NCCL in this process (2 x 2^24 merges under both
    exchanges against ``ops.merge``; 2^24 int32 and float32 sorts with the
    local sort on S1 and K3 or K4, launch counts read; (8, 262144) top-k
    against the kernel sampler); four gloo ranks on CPU tensors holding
    every public function against single-process ``repro_torch.core``; the
    sample sort's per-rank stages at P = 8 on the card, 2^21 keys a rank,
    with the exchange emulated on the device (S1, K3/K4 and K7 against
    their plain versions on rank 0's own work);
12. runtime and telemetry (:func:`phase_runtime`): every guarded op of
    ``repro_torch.kernels.ops`` and ``ssm_scan`` at phase 4/5/7 sizes with
    verification forced on, bit-identical to the same call with the guard
    off and with the same launch counts; each fault class
    (``launch``, ``vmem``, ``exchange``, ``nan``) injected on six ops,
    raising where the reference's first attempt fails; ROADMAP R10's
    NaN-laced keys raising ``VerificationError``; the cost of verification
    (CUDA events) and of the guard (host us per call); full-width
    tinyllama-1.1b served under an injected decode fault, its trace
    replayed byte-identically; the trace smoke and its ``--check``; its
    numbers on a line of their own;
13. VLM and audio (:func:`phase_vlm_audio`): paligemma-3b at full width
    prefilled on a (1, 256) prefix and (1, 8192) tokens (8448 positions,
    blockwise attention under the prefix mask), 16 tokens sampled on S1
    and K4, prefill against stepping, trained 3 steps; whisper-large-v3 at
    full width (32 + 32 layers) prefilled on (4, 1500) frames, its
    ``enc_kv`` against ``encoder_forward``, 32 sampled steps with
    cross-attention, prefill against stepping, trained 3 steps at all 64
    layers; S1 and K4 on a sampled row of each vocab against their plain
    versions; the bfloat16 gelu against the CPU; both prefills traced by
    kind; the reduced configs against the CPU; its numbers on a line of
    their own;
14. the parallel layer and the dry run (:func:`phase_parallel`):
    nemotron-4-340b at full width cut to 2 of 96 layers prefilled on (1,
    4096) and 16 tokens sampled on S1 and K4 (read per token), S1 and K4 on
    a sampled row against their plain versions, prefill against stepping;
    tinyllama-1.1b trained with gradient compression (``"topk"``,
    ``"int8"``) beside ``"none"``, ``compress_grads`` on the card against
    the CPU bit for bit; context-parallel decode attention over a cache of
    524288 positions, sharded and over NCCL at world size 1, against dense
    attention; one dry-run cell on the single-pod mesh of fake ranks in a
    process of its own; its numbers on a line of their own;
15. the kernel checker and the autotuner (:func:`phase_analysis`):
    ``analysis.check_kernels`` on the card over the whole lattice with
    every launch count set to 0 first (0 violations, every kernel
    launched); at every trace point the wrapper calls the ops make equal
    to the checker's launch model and each equal to its plain version;
    A005's shared-memory model equal to each source's
    ``<kernel>_smem_bytes`` at every launch of the lattice, static plus
    dynamic within 227 KB; ``tune.build_table()`` and ``tune.autotune``
    of 2^24 int32 keys; its numbers on a line of their own;
16. the ``kernels`` line, the card line and the result line.

It imports nothing of JAX or of the JAX package, and needs one card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
SFU_EX2_PER_S = 16 * 132 * 1.98e9  # H100 SXM exponentials: 16 per SM per clock, 132 SMs, 1.98 GHz
M, TILE, LEAF = 32768, 512, 32  # tinyllama's vocab 32000 pads to 32768
WIDTHS = tuple(1 << e for e in range(9, 15))  # the 6 wide rounds: 512 ... 16384
CSRC = "src/repro_torch/kernels/csrc"
REPLACES = "src/repro/kernels/merge_path.py"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int = 20) -> float:
    """Device milliseconds per call.  A sleep kernel keeps the card busy
    while the host queues the timed calls, so host overhead between
    launches does not count."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def round_bound(m: int, key_bytes: int, values: bool = True) -> dict:
    """Least time of one round: the m data keys (and values) read once and
    all m + T written once (the tail block writes constants and reads
    nothing), against the few comparisons per data element of the in-tile
    searches."""
    nbytes = (2 * m + TILE) * (key_bytes + (4 if values else 0))
    ops = m * (math.log2(LEAF) + 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
    return {"ms": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations"}


def adversarial_floats(kind: str, n: int, dtype, gen):
    """One row family of logits, as the sampler sees them."""
    import torch

    x = (torch.randn(n, generator=gen, device="cuda") * 3).to(dtype)
    if kind == "logits":
        return x
    if kind == "all_equal":
        return torch.full((n,), 1.5, dtype=dtype, device="cuda")
    if kind == "dups":
        return torch.randint(-3, 4, (n,), generator=gen, device="cuda").to(dtype)
    if kind == "specials":  # -0.0, +0.0, NaNs of both signs, +-inf
        r = torch.rand(n, generator=gen, device="cuda")
        x = torch.where(r < 0.1, torch.tensor(-0.0, dtype=dtype, device="cuda"), x)
        x = torch.where((r >= 0.1) & (r < 0.2), torch.tensor(0.0, dtype=dtype, device="cuda"), x)
        x = torch.where((r >= 0.2) & (r < 0.25), torch.tensor(math.nan, dtype=dtype, device="cuda"), x)
        x = torch.where((r >= 0.25) & (r < 0.3), -torch.tensor(math.nan, dtype=dtype, device="cuda"), x)
        x = torch.where((r >= 0.3) & (r < 0.33), torch.tensor(math.inf, dtype=dtype, device="cuda"), x)
        return torch.where((r >= 0.33) & (r < 0.36), torch.tensor(-math.inf, dtype=dtype, device="cuda"), x)
    raise ValueError(kind)


def round_inputs(keys, width: int, vals=None, tile: int = TILE):
    """A flat round input on the keys' device: runs of ``width`` sorted
    stably with their values (by default each key's index), then the tail of
    ``tile`` sentinel keys and zero values."""
    import torch

    from repro_torch.core.merge_path import max_sentinel

    m, dev = keys.shape[0], keys.device
    vals = torch.arange(m, dtype=torch.int32, device=dev) if vals is None else vals
    ks, perm = torch.sort(keys.view(-1, width), dim=1, stable=True)
    vs = torch.gather(vals.view(-1, width), 1, perm)
    kf = torch.cat([ks.reshape(-1), torch.full((tile,), max_sentinel(keys.dtype), dtype=keys.dtype, device=dev)])
    vf = torch.cat([vs.reshape(-1), torch.zeros((tile,), dtype=torch.int32, device=dev)])
    return kf, vf


def phase_k4(gen) -> dict:
    import torch

    from repro_torch.core import topk_batched as core_topk
    from repro_torch.core.merge_path import flip_desc, total_order_keys
    from repro_torch.kernels import ops
    from repro_torch.kernels.merge_path import (SORT_ROUND_KV_SPAN, sort_round_kv, sort_round_kv_ref, sort_tiles_kv,
                                                sort_tiles_kv_ref)

    max_err = 0
    cases = 0

    def compare(got, want, what):
        nonlocal max_err, cases
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and g.shape == w.shape, f"{what}: dtype/shape {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
            err = int((g.long() - w.long()).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"{what}: kernel differs from its plain version (max abs err {err})")
        cases += 1

    rounds = {}
    for key_dtype, float_dtype in ((torch.int16, torch.bfloat16), (torch.int32, torch.float32)):
        imax = torch.iinfo(key_dtype).max
        families = {
            kind: total_order_keys(flip_desc(adversarial_floats(kind, M, float_dtype, gen)))
            for kind in ("logits", "all_equal", "dups", "specials")
        }
        mixed = torch.randint(-1000, 1000, (M,), generator=gen, device="cuda").to(key_dtype)
        families["iinfo_max"] = torch.where(torch.rand(M, generator=gen, device="cuda") < 0.5, imax, mixed)
        families["iinfo_max_runs"] = torch.full((M,), imax, dtype=key_dtype, device="cuda")
        families["iinfo_max_runs"][: M // 4] = mixed[: M // 4]
        for kind, keys in families.items():
            check(keys.dtype == key_dtype, f"{kind}: keys are {keys.dtype}")
            for w in WIDTHS:
                kf, vf = round_inputs(keys, w)
                got = sort_round_kv(kf, vf, w, tile=TILE, leaf=LEAF)
                compare(got, sort_round_kv_ref(kf, vf, w, tile=TILE), f"{key_dtype} {kind} width {w}")
        # every round size the kernel's span rule tells apart (m = 2^15 ... 2^18:
        # one to all of kE outputs a thread; at 2^18 the full span,
        # SORT_ROUND_KV_SPAN, so widths of half, one and two spans over 32 or
        # more pairs), every width from tile / 2, and pairs narrower than a
        # thread's outputs (widths 1 ... 8 at tiles 2 ... 16)
        span = SORT_ROUND_KV_SPAN
        for kind in ("logits", "dups", "iinfo_max_runs"):
            keys = families[kind].repeat(8)
            for m in (1 << 15, 1 << 16, 1 << 17, 1 << 18):
                widths = [TILE << i >> 1 for i in range((m // TILE).bit_length())]  # tile / 2 ... m / 2
                check(m < 1 << 18 or {span // 2, span, 2 * span} <= set(widths), f"widths {widths} miss the span {span}")
                for w in widths:
                    kf, vf = round_inputs(keys[:m], w)
                    compare(sort_round_kv(kf, vf, w, tile=TILE, leaf=LEAF), sort_round_kv_ref(kf, vf, w, tile=TILE),
                            f"{key_dtype} {kind} m {m} width {w}")
                for w in (1, 2, 4, 8):
                    for t in (t for t in (2, 4, 8, 16) if t <= 2 * w):
                        kf, vf = round_inputs(keys[:m], w, tile=t)
                        compare(sort_round_kv(kf, vf, w, tile=t, leaf=LEAF), sort_round_kv_ref(kf, vf, w, tile=t),
                                f"{key_dtype} {kind} m {m} width {w} tile {t}")
        # times on the sampler's own keys: logits in total order
        key_bytes = torch.tensor([], dtype=key_dtype).element_size()
        for w in WIDTHS:
            kf, vf = round_inputs(families["logits"], w)
            pairs = kf[:M].view(-1, 2 * w)
            rounds[(str(key_dtype), w)] = {
                "kernel_ms": time_ms(lambda: sort_round_kv(kf, vf, w, tile=TILE, leaf=LEAF)),
                "plain_ms": time_ms(lambda: sort_round_kv_ref(kf, vf, w, tile=TILE)),
                "library_ms": time_ms(lambda: torch.sort(pairs, dim=1, stable=True)),
                "bound": round_bound(M, key_bytes),
            }

    # every wide round of topk_batched at batch 64: (64, 32768) int16 rows of
    # the four logit families in total order, each key's index as its value
    rows = torch.cat([total_order_keys(flip_desc(adversarial_floats(("logits", "all_equal", "dups", "specials")[r % 4], M,
                                                                    torch.bfloat16, gen))) for r in range(64)])
    batch_rounds = []
    for w in WIDTHS:
        kf, vf = round_inputs(rows, w)
        compare(sort_round_kv(kf, vf, w, tile=TILE, leaf=LEAF), sort_round_kv_ref(kf, vf, w, tile=TILE),
                f"(64, {M}) int16 rows width {w}")
        batch_rounds.append(time_ms(lambda: sort_round_kv(kf, vf, w, tile=TILE, leaf=LEAF)))

    # whole sorts through the public surface: kernel path against the core path
    for bsz in (1, 64):
        rows = [adversarial_floats(("logits", "all_equal", "dups", "specials")[r % 4], 32000, torch.bfloat16, gen) for r in range(bsz)]
        x = torch.stack(rows)
        for k in (40, 32000):
            compare(ops.topk_batched(x, k), core_topk(x, k), f"topk_batched ({bsz}, 32000) k={k}")
    torch.cuda.synchronize()

    # S1 with values at the sampler's shape: the int16 total-order keys of one
    # row of bfloat16 logits and their indices, chunk T (its one launch per token)
    keys = total_order_keys(flip_desc(adversarial_floats("logits", M, torch.bfloat16, gen)))
    idx = torch.arange(M, dtype=torch.int32, device="cuda")
    tiles_err = max(bit_err(g, w, f"sort_tiles_kv sampler row {part}") for g, w, part in
                    zip(sort_tiles_kv(keys, idx, TILE), sort_tiles_kv_ref(keys, idx, TILE), ("keys", "values")))
    bound = tiles_bound(M, 2, values=True)
    tiles_kv = {"max_abs_err": tiles_err, "ms": time_ms(lambda: sort_tiles_kv(keys, idx, TILE)),
                "plain_ms": time_ms(lambda: sort_tiles_kv_ref(keys, idx, TILE)),
                "library_ms": time_ms(lambda: torch.gather(idx.view(-1, TILE), 1,
                                                           torch.sort(keys.view(-1, TILE), dim=1, stable=True).indices)),
                "bound_ms": bound["ms"], "bound_by": bound["by"]}
    print(f"S1 kv (1, {M}) int16 keys, int32 values, chunk {TILE}: kernel_ms {tiles_kv['ms']:.5f}  plain_ms "
          f"{tiles_kv['plain_ms']:.5f}  library_ms {tiles_kv['library_ms']:.5f}  bound_ms {tiles_kv['bound_ms']:.6f} "
          f"({tiles_kv['bound_by']})")

    print("K4 per round (m=32768+512, T=512, S=32; CUDA events):")
    for (kd, w), r in rounds.items():
        print(f"  {kd:12s} width {w:5d}: kernel_ms {r['kernel_ms']:.5f}  plain_ms {r['plain_ms']:.5f}  "
              f"library_ms {r['library_ms']:.5f}  bound_ms {r['bound']['ms']:.6f} ({r['bound']['by']})")
    print(f"K4 (64, {M}) int16 rows, int32 values, {len(WIDTHS)} wide rounds: kernel_ms {sum(batch_rounds):.5f} "
          f"(per round {', '.join(f'{t:.5f}' for t in batch_rounds)}), bound_ms "
          f"{len(WIDTHS) * round_bound(64 * M, 2)['ms']:.6f}")
    main_path = [r for (kd, _), r in rounds.items() if kd == str(torch.int16)]
    print(f"K4: {cases} comparisons against the plain version, tolerance 0 (bit-identical), max abs err {max_err}")
    return {
        "max_abs_err": max_err,
        "ms": sum(r["kernel_ms"] for r in main_path),
        "plain_ms": sum(r["plain_ms"] for r in main_path),
        "library_ms": sum(r["library_ms"] for r in main_path),
        "bound_ms": sum(r["bound"]["ms"] for r in main_path),
        "bound_by": main_path[0]["bound"]["by"],
        "tiles_kv": tiles_kv,
    }


def bit_err(got, want, what: str) -> int:
    """Max abs difference of the bit patterns of two results; raises unless 0."""
    import torch

    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: dtype/shape {got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}")
    if got.dtype.is_floating_point:
        ints = {2: torch.int16, 4: torch.int32}[got.element_size()]
        got, want = got.view(ints), want.view(ints)
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    check(err == 0, f"{what}: kernel differs from its plain version (max abs err of the bits {err})")
    return err


def sorted_side(kind: str, n: int, dtype, gen, device: str, rows=None):
    """One sorted input of a merge, ``(n,)``, or ``(rows, n)`` sorted rows.
    ``random``: spread-out keys; ``dups``: 7 distinct keys; ``all_equal``:
    one key; ``sentinel``: the dtype's lowest key first and keys equal to
    the sentinel (``+inf``, ``iinfo.max``) at the end; ``signed_zeros``
    (floats): -0.0 and +0.0 at random in a long run of zeros, and +-inf at
    the ends."""
    import torch

    shape = (n,) if rows is None else (rows, n)
    floating = dtype.is_floating_point
    hi = math.inf if floating else torch.iinfo(dtype).max
    lo = -math.inf if floating else torch.iinfo(dtype).min
    if kind == "random" and floating:
        x = torch.randn(shape, generator=gen, device=device) * 1000
    elif kind == "random":
        x = torch.randint(lo // 2, hi // 2, shape, generator=gen, device=device, dtype=torch.int64)
    elif kind in ("dups", "signed_zeros"):
        x = torch.randint(-3, 4, shape, generator=gen, device=device)
    elif kind == "all_equal":
        x = torch.full(shape, 7, device=device)
    elif kind == "sentinel":
        x = torch.randint(-1000, 1000, shape, generator=gen, device=device)
    else:
        raise ValueError(kind)
    x = torch.sort(x.to(dtype)).values
    if kind == "signed_zeros":  # sorted under `<`, where -0.0 == +0.0
        signs = torch.rand(shape, generator=gen, device=device) < 0.5
        x = torch.where((x == 0) & signs, torch.tensor(-0.0, dtype=dtype, device=device), x)
    if kind in ("sentinel", "signed_zeros"):
        x[..., : n // 20] = lo
        x[..., n - (2 * n // 5 if kind == "sentinel" else n // 20):] = hi
    return x.contiguous()


def merge_bound(n: int, bytes_per_element: int) -> dict:
    """Least time of a merge of n elements in all: each input byte read once
    and each output byte written once, against a few comparisons each."""
    t_bytes = 2 * n * bytes_per_element / HBM_BYTES_PER_S * 1e3
    t_ops = n * (math.log2(LEAF) + 2) / SCALAR_OPS_PER_S * 1e3
    return {"ms": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations"}


TILE_KINDS = ("random", "all_equal", "sorted", "reverse", "few", "iinfo_max")
TILE_CHUNKS = (128, 256, 512)


def tile_keys(kind: str, n: int, dtype, gen, device: str):
    """Keys of one tile-sort case, ``(n,)``: ``random`` over the whole
    range; ``all_equal``; ``sorted`` and ``reverse`` (every chunk sorted
    one way or the other); ``few``: 3 distinct keys; ``iinfo_max``: half
    the keys equal to the dtype's largest, the sentinel's value."""
    import torch

    info = torch.iinfo(dtype)
    small = torch.randint(-1000, 1000, (n,), generator=gen, device=device)
    if kind == "random":
        x = torch.randint(info.min, info.max + 1, (n,), generator=gen, device=device, dtype=torch.int64)
    elif kind == "all_equal":
        x = torch.full((n,), 7, device=device)
    elif kind in ("sorted", "reverse"):
        x = torch.sort(small, descending=kind == "reverse").values
    elif kind == "few":
        x = torch.randint(-1, 2, (n,), generator=gen, device=device)
    elif kind == "iinfo_max":
        x = torch.where(torch.rand(n, generator=gen, device=device) < 0.5, info.max, small)
    else:
        raise ValueError(kind)
    return x.to(dtype).contiguous()


def tiles_bound(n: int, key_bytes: int, values: bool) -> dict:
    """Least time of one tile sort of n keys: each key (and value) read once
    and written once, against about log2(C) comparisons per element."""
    t_bytes = 2 * n * (key_bytes + (4 if values else 0)) / HBM_BYTES_PER_S * 1e3
    t_ops = n * math.log2(TILE) / SCALAR_OPS_PER_S * 1e3
    return {"ms": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations"}


def wide_rounds(n: int, tile: int) -> int:
    """K3/K4 launches of one sort of rows of n: widths tile ... m / 2."""
    m = 1 << max(0, (n - 1).bit_length())
    return max(0, m.bit_length() - tile.bit_length())


def phase_merge_sort(device: str = "cuda", log2n: int = 24, batch=(64, 65536), tile: int = TILE,
                     leaf: int = LEAF, seed: int = 1) -> dict:
    """K1, K2, K3 and the tile sort S1 on the merge-and-sort path at
    ``2 x 2^log2n`` elements.

    Every merge (K1 and K2 also at the edges of their block span), every
    round and every tile sort (keys alone and with values, over
    ``TILE_KINDS`` and ``TILE_CHUNKS``) is held against the kernel's plain
    version bit for bit; K1 and K3 also run on unsorted inputs, which must
    not fault; a float32 ``ops.sort`` and an int32 ``ops.sort_kv`` (S1 with
    values and K4's wide rounds) are held against a stable ``torch.sort``.
    The whole path is driven once through ``kernels.ops`` with the launch
    counts set to 0 just before it, and on the card each kernel is timed
    beside its plain version, its bound and one PyTorch call, and
    ``ops.sort`` (int32), the float32 ``ops.sort`` and ``ops.sort_kv`` are
    each split into their tile sort, their wide rounds and the rest.
    With ``device="cpu"`` (the tests, at a small size) the wrappers run
    their plain versions, nothing is launched or timed, and every check
    still runs.
    """
    import torch

    from repro_torch.core.merge_path import max_sentinel, total_order_keys
    from repro_torch.kernels import merge_path as km
    from repro_torch.kernels import ops, reset_launches

    on_card = device == "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n1 = 1 << log2n
    errs = {"merge": 0, "merge_kv": 0, "sort_round": 0, "sort_tiles": 0, "sort_tiles_kv": 0}
    cases = dict.fromkeys(errs, 0)
    k4_cases = 0  # K4's comparisons here (phase 3 holds it on the sampler's shapes)

    def launched(fn, call, n_launches):
        """Run ``call``; check that it launched ``fn`` n_launches times (none off the card)."""
        before = fn.launches
        out = call()
        want = n_launches if on_card else 0
        check(fn.launches - before == want, f"{fn.__name__}: {fn.launches - before} launches, want {want}")
        return out

    def merge_case(a, b, what):
        """K1 through ``ops.merge`` (one launch past the tile) against its plain version."""
        got = launched(km.merge, lambda: ops.merge(a, b, tile=tile, leaf=leaf), int(a.shape[0] + b.shape[0] > tile))
        errs["merge"] = max(errs["merge"], bit_err(got, km.merge_ref(a, b), what))
        cases["merge"] += 1

    def kv_case(ak, bk, what, offs=(0, 0)):
        """K2 through ``ops.merge_kv`` on arange values, so that every value
        names its source slot (float keys take float32 values of the same
        bits: floats past 2^24 would not be distinct); the values are views
        that start ``offs`` elements into their buffer, as the keys may."""
        na, nb = ak.shape[0], bk.shape[0]
        vals = torch.arange(offs[0] + na + offs[1] + nb, dtype=torch.int32, device=device)
        src = vals.view(torch.float32) if ak.dtype.is_floating_point else vals
        av, bv = src[offs[0]:offs[0] + na], src[offs[0] + na + offs[1]:]
        ko, vo = launched(km.merge_kv, lambda: ops.merge_kv(ak, av, bk, bv, tile=tile, leaf=leaf), int(na + nb > tile))
        wk, wv = km.merge_kv_ref(ak, av, bk, bv)
        errs["merge_kv"] = max(errs["merge_kv"], bit_err(ko, wk, what + " keys"), bit_err(vo, wv, what + " values"))
        # sorted, stable and a permutation, whatever the plain version says
        vo = vo.view(torch.int32)
        check(bool((ko[1:] >= ko[:-1]).all()), f"{what}: keys not sorted")
        check(bool((vo[1:] > vo[:-1])[ko[1:] == ko[:-1]].all()), f"{what}: equal keys out of source order")
        check(torch.equal(torch.sort(vo).values, torch.cat([av, bv]).view(torch.int32)),
              f"{what}: values are not a permutation of the inputs")
        cases["merge_kv"] += 1

    # K1: every family of every key dtype, then the edge shapes
    merge_cases = []
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int16):
        kinds = ["random", "dups", "all_equal", "sentinel"] + (["signed_zeros"] if dtype.is_floating_point else [])
        merge_cases += [(dtype, kind, n1, n1) for kind in kinds]
    merge_cases += [
        (torch.float32, "random", n1 + n1 // 2 - 1, n1),  # unequal lengths
        (torch.float32, "signed_zeros", 0, n1),  # one empty side
        (torch.int32, "sentinel", n1, 0),
        (torch.float32, "signed_zeros", tile // 4, tile // 2),  # n <= tile: the core path, no launch
    ]
    for dtype, kind, na, nb in merge_cases:
        a, b = sorted_side(kind, na, dtype, gen, device), sorted_side(kind, nb, dtype, gen, device)
        merge_case(a, b, f"merge {dtype} {kind} ({na}, {nb})")

    # K2: int32 and float32 keys over the families, then the edge shapes
    kv_cases = [(torch.int32, kind, n1, n1) for kind in ("random", "dups", "all_equal", "sentinel")]
    kv_cases += [(torch.float32, "signed_zeros", n1, n1), (torch.int32, "random", n1 + n1 // 2 - 1, n1),
                 (torch.int32, "dups", 0, n1), (torch.int32, "random", tile // 4, tile // 2)]
    for dtype, kind, na, nb in kv_cases:
        ak, bk = sorted_side(kind, na, dtype, gen, device), sorted_side(kind, nb, dtype, gen, device)
        kv_case(ak, bk, f"merge_kv {dtype} {kind} ({na}, {nb})")

    # K1 and K2 at the edges of the span merge (a block writes MERGE_SPAN or
    # MERGE_KV_SPAN outputs and reads exactly its two windows): inputs that
    # start off a 16-byte boundary, so that each window's cover is trimmed at
    # both ends; lopsided lengths; disjoint ranges, so that some blocks have
    # an empty window on one side; totals around one span and one between
    # the tile and the span (a single block)
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int16):
        kind = "signed_zeros" if dtype.is_floating_point else "sentinel"
        a, b = sorted_side("dups", n1 + 1, dtype, gen, device)[1:], sorted_side(kind, n1 + 3, dtype, gen, device)[3:]
        merge_case(a, b, f"merge {dtype} views at offsets (1, 3)")
        kv_case(a, b, f"merge_kv {dtype} views at offsets (1, 3)", offs=(1, 3))

    def edges(span):
        return {"lopsided (1, n)": (1, n1), "lopsided (n, 1)": (n1, 1),
                "total span - 1": (span // 2, span // 2 - 1), "total span": (span // 2, span // 2),
                "total span + 1": (span // 2 + 1, span // 2),
                "total between tile and span": ((tile + span) // 6, (tile + span) // 3)}

    for what, (na, nb) in edges(km.MERGE_SPAN).items():
        a, b = sorted_side("dups", na, torch.float32, gen, device), sorted_side("dups", nb, torch.float32, gen, device)
        merge_case(a, b, f"merge {what} ({na}, {nb})")
    for what, (na, nb) in edges(km.MERGE_KV_SPAN).items():
        ak, bk = sorted_side("random", na, torch.int32, gen, device), sorted_side("random", nb, torch.int32, gen, device)
        kv_case(ak, bk, f"merge_kv {what} ({na}, {nb})")
    low_high = sorted_side("random", 2 * n1, torch.int32, gen, device)
    for what, (a, b) in (("A below B", (low_high[:n1], low_high[n1:])), ("A above B", (low_high[n1:], low_high[:n1]))):
        merge_case(a, b, f"merge disjoint, {what}")
        kv_case(a, b, f"merge_kv disjoint, {what}")
    # unsorted inputs break the contract and their merge is unspecified, but
    # K1 must stay inside its buffers: the card runs on
    noise = torch.randint(-1000, 1000, (2 * n1,), generator=gen, device=device, dtype=torch.int32)
    got = launched(km.merge, lambda: km.merge(noise[:n1], noise[n1:], tile=tile, leaf=leaf), 1)
    int(got.long().sum())  # waits for the kernel: a fault raises here
    check(got.shape == (2 * n1,), "merge of unsorted inputs: shape")

    # K3: every wide round of a 2^log2n sort, then whole sorts
    def round_keys(keys, width):
        runs = torch.sort(keys.view(-1, width), dim=1, stable=True).values.reshape(-1)
        return torch.cat([runs, torch.full((tile,), max_sentinel(keys.dtype), dtype=keys.dtype, device=device)])

    def shuffled(kind, dtype):
        return sorted_side(kind, n1, dtype, gen, device)[torch.randperm(n1, generator=gen, device=device)]

    def round_case(xf, w, t, what):
        got = launched(km.sort_round, lambda: km.sort_round(xf, w, tile=t, leaf=leaf), 1)
        errs["sort_round"] = max(errs["sort_round"], bit_err(got, km.sort_round_ref(xf, w, tile=t), what))
        cases["sort_round"] += 1

    # every width the path runs, and the narrowest a round takes (tile / 2)
    widths = [tile << i for i in range(wide_rounds(n1, tile))]
    for dtype, kind in ((torch.int32, "random"), (torch.int32, "sentinel"), (torch.int16, "dups"),
                        (torch.int16, "sentinel")):
        keys = shuffled(kind, dtype)
        for w in [tile // 2] + widths:
            round_case(round_keys(keys, w), w, tile, f"sort_round {dtype} {kind} width {w}")
        got = launched(km.sort_round, lambda: ops.sort(keys, tile=tile, leaf=leaf), len(widths))
        bit_err(got, torch.sort(keys, stable=True).values, f"ops.sort {dtype} {kind} 2^{log2n}")
    # pairs narrower than a thread's 16 outputs (tiles below 16), and keys
    # that start off a 16-byte boundary
    for t in (2, 4, 8):
        keys = shuffled("dups", torch.int16)[: n1 // 16]
        for w in (t // 2, t):
            xf = torch.cat([round_keys(keys, w)[: n1 // 16], torch.full((t,), max_sentinel(torch.int16), dtype=torch.int16, device=device)])
            round_case(xf, w, t, f"sort_round tile {t} width {w}")
    # rounds small enough that the kernel gives a thread fewer outputs (it
    # keeps at least 128 blocks a round), every width from tile / 2
    keys = shuffled("dups", torch.int16)
    for m in sorted({max(4 * tile, n1 >> s) for s in (9, 8, 7)}):
        for w in (tile << i >> 1 for i in range((m // tile).bit_length())):
            round_case(round_keys(keys[:m], w), w, tile, f"sort_round m {m} width {w}")
    keys = shuffled("sentinel", torch.int32)
    for w in (tile // 2, n1 // 4):
        xf = torch.cat([keys[:1], round_keys(keys, w)])[1:]  # one element past an aligned start
        round_case(xf, w, tile, f"sort_round off a 16-byte boundary width {w}")
        # K4 the same way: keys and values each one element past an aligned start
        kf, vf = round_inputs(keys, w, tile=tile)
        kf, vf = torch.cat([kf[:1], kf])[1:], torch.cat([vf[:1], vf])[1:]
        got = launched(km.sort_round_kv, lambda: km.sort_round_kv(kf, vf, w, tile=tile, leaf=leaf), 1)
        for g, want, part in zip(got, km.sort_round_kv_ref(kf, vf, w, tile=tile), ("keys", "values")):
            bit_err(g, want, f"sort_round_kv off a 16-byte boundary width {w} {part}")
        k4_cases += 1
    # unsorted runs break the round's contract and their merge is unspecified,
    # but K3 must stay inside its buffers: runs wider than its span of 4096,
    # so that a block's two searches fall inside one pair (16384 on the card,
    # the same rule at the phase's own size here)
    w = min(16384, n1 // 2)
    xf = torch.cat([torch.randint(-1000, 1000, (n1,), generator=gen, device=device, dtype=torch.int32),
                    torch.full((tile,), max_sentinel(torch.int32), dtype=torch.int32, device=device)])
    got = launched(km.sort_round, lambda: km.sort_round(xf, w, tile=tile, leaf=leaf), 1)
    int(got.long().sum())  # waits for the kernel: a fault raises here
    check(got.shape == xf.shape, "sort_round of unsorted runs: shape")
    vf = torch.arange(n1 + tile, dtype=torch.int32, device=device)  # K4 on the same runs, with values
    gk, gv = launched(km.sort_round_kv, lambda: km.sort_round_kv(xf, vf, w, tile=tile, leaf=leaf), 1)
    int(gk.long().sum()) + int(gv.long().sum())  # waits for the kernel: a fault raises here
    check(gk.shape == xf.shape and gv.shape == vf.shape, "sort_round_kv of unsorted runs: shape")
    rows = torch.randint(-(2**31), 2**31 - 1, batch, generator=gen, device=device, dtype=torch.int64).to(torch.int32)
    got = launched(km.sort_round, lambda: ops.sort_batched(rows, tile=tile, leaf=leaf), wide_rounds(batch[1], tile))
    bit_err(got, torch.sort(rows, dim=1, stable=True).values, f"ops.sort_batched {tuple(batch)}")

    # K4 at scale: a float32 ops.sort (S1 with values on the total-order keys,
    # K4's wide rounds, a gather) and an int32 ops.sort_kv with int32 values,
    # each against a stable torch.sort
    fkeys = torch.randn(n1, generator=gen, device=device) * 1000
    kv_keys = shuffled("dups", torch.int32)
    kv_vals = torch.randint(-(2**31), 2**31 - 1, (n1,), generator=gen, device=device, dtype=torch.int64).to(torch.int32)
    got = launched(km.sort_round_kv, lambda: launched(km.sort_tiles_kv, lambda: ops.sort(fkeys, tile=tile, leaf=leaf), 1),
                   len(widths))
    bit_err(got, torch.sort(fkeys, stable=True).values, f"ops.sort float32 2^{log2n}")
    got = launched(km.sort_round_kv, lambda: launched(km.sort_tiles_kv, lambda: ops.sort_kv(kv_keys, kv_vals, tile=tile, leaf=leaf), 1),
                   len(widths))
    want_k, perm = torch.sort(kv_keys, stable=True)
    for g, w, part in zip(got, (want_k, kv_vals[perm]), ("keys", "values")):
        bit_err(g, w, f"ops.sort_kv int32 2^{log2n} {part}")

    # S1: every family, both key dtypes, keys alone and with values, chunks
    # 128 ... 512 at one chunk, 2^16 and 2^log2n keys; against the plain
    # version and a stable torch.sort of the chunks
    for dtype in (torch.int16, torch.int32):
        for c in TILE_CHUNKS:
            for n in sorted({c, 1 << min(16, log2n), n1}):
                for kind in TILE_KINDS:
                    x = tile_keys(kind, n, dtype, gen, device)
                    v = torch.arange(n, dtype=torch.int32, device=device)
                    what = f"sort_tiles {dtype} {kind} chunk {c} n {n}"
                    got = launched(km.sort_tiles, lambda: km.sort_tiles(x, c), 1)
                    errs["sort_tiles"] = max(errs["sort_tiles"], bit_err(got, km.sort_tiles_ref(x, c), what))
                    ks, perm = torch.sort(x.view(-1, c), dim=1, stable=True)
                    bit_err(got, ks.reshape(-1), what + " vs torch.sort")
                    gk, gv = launched(km.sort_tiles_kv, lambda: km.sort_tiles_kv(x, v, c), 1)
                    for g, w, part in zip((gk, gv), km.sort_tiles_kv_ref(x, v, c), ("keys", "values")):
                        errs["sort_tiles_kv"] = max(errs["sort_tiles_kv"], bit_err(g, w, f"{what} kv {part}"))
                    bit_err(gv, torch.gather(v.view(-1, c), 1, perm).reshape(-1), what + " kv values vs torch.sort")
                    cases["sort_tiles"] += 1
                    cases["sort_tiles_kv"] += 1
    x = tile_keys("few", n1 + 1, torch.int16, gen, device)[1:]  # off a 16-byte boundary
    v = torch.arange(n1 + 1, dtype=torch.int32, device=device)[1:]
    for c in (c for c in (2, 8, 16, 32, 4096) if c <= n1):  # runs inside one thread, one warp, one block
        what = f"sort_tiles int16 off a 16-byte boundary chunk {c}"
        errs["sort_tiles"] = max(errs["sort_tiles"], bit_err(launched(km.sort_tiles, lambda: km.sort_tiles(x, c), 1),
                                                             km.sort_tiles_ref(x, c), what))
        got = launched(km.sort_tiles_kv, lambda: km.sort_tiles_kv(x, v, c), 1)
        for g, w, part in zip(got, km.sort_tiles_kv_ref(x, v, c), ("keys", "values")):
            errs["sort_tiles_kv"] = max(errs["sort_tiles_kv"], bit_err(g, w, f"{what} kv {part}"))
        cases["sort_tiles"] += 1
        cases["sort_tiles_kv"] += 1

    # the result must not depend on (T, S), which K1 and K2 ignore and the
    # rounds take: other tiles and leaves, odd lengths
    for t, s in ((32, 1), (128, 8), (384, 24), (1000, 32), (4096, 64)):
        for dtype in (torch.int16, torch.bfloat16, torch.float32):
            kind = "signed_zeros" if dtype.is_floating_point else "sentinel"
            a, b = sorted_side("dups", n1 // 4 + 123, dtype, gen, device), sorted_side(kind, n1 // 8 + 7, dtype, gen, device)
            got = launched(km.merge, lambda: km.merge(a, b, tile=t, leaf=s), 1)
            errs["merge"] = max(errs["merge"], bit_err(got, km.merge_ref(a, b), f"merge {dtype} tile {t} leaf {s}"))
            cases["merge"] += 1
        ak, bk = sorted_side("dups", n1 // 8 + 5, torch.int32, gen, device), sorted_side("dups", n1 // 4, torch.int32, gen, device)
        vals = torch.arange(ak.shape[0] + bk.shape[0], dtype=torch.int32, device=device).view(torch.float32)
        av, bv = vals[: ak.shape[0]], vals[ak.shape[0]:]
        got = launched(km.merge_kv, lambda: km.merge_kv(ak, av, bk, bv, tile=t, leaf=s), 1)
        for g, w, part in zip(got, km.merge_kv_ref(ak, av, bk, bv), ("keys", "values")):
            errs["merge_kv"] = max(errs["merge_kv"], bit_err(g, w, f"merge_kv tile {t} leaf {s} {part}"))
        cases["merge_kv"] += 1
        if t & (t - 1):
            continue  # the flat rounds take power-of-two tiles only
        keys = shuffled("dups", torch.int32)
        for w in sorted({max(1, t // 2), n1 // 4}):
            if t <= 2 * w <= n1:
                xf = torch.cat([round_keys(keys, w)[:n1], torch.full((t,), max_sentinel(torch.int32), dtype=torch.int32, device=device)])
                round_case(xf, w, t, f"sort_round tile {t} leaf {s} width {w}")

    # the path, driven once through the public surface with every count at 0
    a, b = (sorted_side("random", n1, torch.float32, gen, device) for _ in range(2))
    ak, bk = (sorted_side("random", n1, torch.int32, gen, device) for _ in range(2))
    av = torch.arange(n1, dtype=torch.int32, device=device)
    bv = torch.arange(n1, 2 * n1, dtype=torch.int32, device=device)
    keys = shuffled("random", torch.int32)
    reset_launches()  # every kernel's count, K1-K9
    merged = ops.merge(a, b, tile=tile, leaf=leaf)
    mk, mv = ops.merge_kv(ak, av, bk, bv, tile=tile, leaf=leaf)
    sorted_keys = ops.sort(keys, tile=tile, leaf=leaf)
    sorted_rows = ops.sort_batched(rows, tile=tile, leaf=leaf)
    launches = {fn.__name__: fn.launches for fn in km.WRAPPERS}
    want = dict.fromkeys(launches, 0)
    want.update(merge=1, merge_kv=1, sort_round=len(widths) + wide_rounds(batch[1], tile), sort_tiles=2)
    check(launches == (want if on_card else dict.fromkeys(want, 0)), f"path launched {launches}, want {want}")
    bit_err(merged, km.merge_ref(a, b), "path: ops.merge")
    for g, w, part in zip((mk, mv), km.merge_kv_ref(ak, av, bk, bv), ("keys", "values")):
        bit_err(g, w, f"path: ops.merge_kv {part}")
    bit_err(sorted_keys, torch.sort(keys, stable=True).values, "path: ops.sort")
    bit_err(sorted_rows, torch.sort(rows, dim=1, stable=True).values, "path: ops.sort_batched")
    print(f"merge/sort: {cases['merge']} K1 merges, {cases['merge_kv']} K2 merges, {cases['sort_round']} K3 rounds, "
          f"{k4_cases} K4 rounds and {cases['sort_tiles']} S1 tile sorts with and without values against their plain "
          f"versions at 2^{log2n} per side, tolerance 0 (bit-identical), max abs err {max(errs.values())}; the path "
          f"launched {launches}")

    out = {name: {"launches": launches[name], "max_abs_err": errs[name], "ms": None, "plain_ms": None,
                  "library_ms": None, "bound_ms": None, "bound_by": None} for name in errs}
    if not on_card:
        return out

    # times at the path's own shapes (CUDA events, after a warm-up call)
    cat = torch.cat([a, b])
    bound = merge_bound(2 * n1, 4)
    out["merge"].update(ms=time_ms(lambda: km.merge(a, b, tile=tile, leaf=leaf)),
                        plain_ms=time_ms(lambda: km.merge_ref(a, b)),
                        library_ms=time_ms(lambda: torch.sort(cat, stable=True)),
                        bound_ms=bound["ms"], bound_by=bound["by"])
    cat_k, cat_v = torch.cat([ak, bk]), torch.cat([av, bv])
    bound = merge_bound(2 * n1, 8)
    out["merge_kv"].update(ms=time_ms(lambda: km.merge_kv(ak, av, bk, bv, tile=tile, leaf=leaf)),
                           plain_ms=time_ms(lambda: km.merge_kv_ref(ak, av, bk, bv)),
                           library_ms=time_ms(lambda: cat_v[torch.sort(cat_k, stable=True).indices]),
                           bound_ms=bound["ms"], bound_by=bound["by"])
    for name in ("merge", "merge_kv"):
        r = out[name]
        print(f"  {name:8s} 2 x 2^{log2n}: kernel_ms {r['ms']:.5f}  plain_ms {r['plain_ms']:.5f}  "
              f"library_ms {r['library_ms']:.5f}  bound_ms {r['bound_ms']:.6f} ({r['bound_by']})")
    # K1 for each key dtype, and K2 on float32 keys, beside their byte bounds
    by_dtype = []
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int16):
        x, y = (sorted_side("random", n1, dtype, gen, device) for _ in range(2))
        size = x.element_size()
        by_dtype.append(f"K1 {str(dtype)[6:]} {time_ms(lambda: km.merge(x, y, tile=tile, leaf=leaf)):.5f} "
                        f"(bound {merge_bound(2 * n1, size)['ms']:.6f})")
    fk, gk = (sorted_side("random", n1, torch.float32, gen, device) for _ in range(2))
    by_dtype.append(f"K2 float32 keys, int32 values {time_ms(lambda: km.merge_kv(fk, av, gk, bv, tile=tile, leaf=leaf)):.5f} "
                    f"(bound {merge_bound(2 * n1, 8)['ms']:.6f})")
    print(f"  K1/K2 2 x 2^{log2n} by key dtype, ms: " + ", ".join(by_dtype))
    rounds = []
    for w in widths:
        xf = round_keys(keys, w)
        pairs = xf[:n1].view(-1, 2 * w)
        rounds.append({"width": w, "ms": time_ms(lambda: km.sort_round(xf, w, tile=tile, leaf=leaf)),
                       "plain_ms": time_ms(lambda: km.sort_round_ref(xf, w, tile=tile)),
                       "library_ms": time_ms(lambda: torch.sort(pairs, dim=1, stable=True)),
                       "bound": round_bound(n1, 4, values=False)})
        r = rounds[-1]
        print(f"  K3 int32 width {w:8d}: kernel_ms {r['ms']:.5f}  plain_ms {r['plain_ms']:.5f}  "
              f"library_ms {r['library_ms']:.5f}  bound_ms {r['bound']['ms']:.6f} ({r['bound']['by']})")
    out["sort_round"].update(
        ms=sum(r["ms"] for r in rounds), plain_ms=sum(r["plain_ms"] for r in rounds),
        library_ms=sum(r["library_ms"] for r in rounds), bound_ms=sum(r["bound"]["ms"] for r in rounds),
        bound_by=rounds[0]["bound"]["by"])
    # S1 at the path's chunk, on the keys ops.sort hands it
    chunk = min(n1, tile)
    bound = tiles_bound(n1, 4, values=False)
    out["sort_tiles"].update(ms=time_ms(lambda: km.sort_tiles(keys, chunk)),
                             plain_ms=time_ms(lambda: km.sort_tiles_ref(keys, chunk), iters=5),
                             library_ms=time_ms(lambda: torch.sort(keys.view(-1, chunk), dim=1, stable=True)),
                             bound_ms=bound["ms"], bound_by=bound["by"])
    r = out["sort_tiles"]
    print(f"  S1 int32 2^{log2n} chunk {chunk}: kernel_ms {r['ms']:.5f}  plain_ms {r['plain_ms']:.5f}  "
          f"library_ms {r['library_ms']:.5f}  bound_ms {r['bound_ms']:.6f} ({r['bound_by']})")
    # the public calls whole, host dispatch included; ops.sort beside one stable torch.sort
    whole = {
        "ops.merge": time_ms(lambda: ops.merge(a, b, tile=tile, leaf=leaf)),
        "ops.merge_kv": time_ms(lambda: ops.merge_kv(ak, av, bk, bv, tile=tile, leaf=leaf)),
        f"ops.sort 2^{log2n}": time_ms(lambda: ops.sort(keys, tile=tile, leaf=leaf), iters=5),
        f"torch.sort 2^{log2n} (stable)": time_ms(lambda: torch.sort(keys, stable=True), iters=5),
        f"ops.sort_batched {tuple(batch)}": time_ms(lambda: ops.sort_batched(rows, tile=tile, leaf=leaf), iters=5),
    }
    print("  whole calls (CUDA events): " + ", ".join(f"{k} {v:.5f} ms" for k, v in whole.items()))
    sort_ms = whole[f"ops.sort 2^{log2n}"]
    print(f"  ops.sort 2^{log2n} split: tile sort {r['ms']:.5f} ms, {len(rounds)} wide rounds "
          f"{out['sort_round']['ms']:.5f} ms, the rest (padding, tail, slicing, dispatch) "
          f"{sort_ms - r['ms'] - out['sort_round']['ms']:.5f} ms of {sort_ms:.5f} ms")
    # K4 at scale: the float32 ops.sort and the int32 ops.sort_kv of 2^log2n,
    # each split into S1 with values, K4's wide rounds (on the keys and values
    # each round is handed) and the rest, beside a stable torch.sort
    fidx = torch.arange(n1, dtype=torch.int32, device=device)
    rest = {}
    for what, call, library, k, v in (
        (f"ops.sort float32 2^{log2n}", lambda: ops.sort(fkeys, tile=tile, leaf=leaf),
         lambda: torch.sort(fkeys, stable=True), total_order_keys(fkeys), fidx),
        (f"ops.sort_kv int32 2^{log2n}", lambda: ops.sort_kv(kv_keys, kv_vals, tile=tile, leaf=leaf),
         lambda: kv_vals[torch.sort(kv_keys, stable=True).indices], kv_keys, kv_vals),
    ):
        whole_ms = time_ms(call, iters=5)
        tiles_ms = time_ms(lambda: km.sort_tiles_kv(k, v, chunk))
        k4 = []
        for w in widths:
            kf, vf = round_inputs(k, w, v)
            k4.append(time_ms(lambda: km.sort_round_kv(kf, vf, w, tile=tile, leaf=leaf)))
        k4_bound = len(widths) * round_bound(n1, 4)["ms"]
        rest[what] = whole_ms - tiles_ms - sum(k4)
        print(f"  {what} split: S1 kv {tiles_ms:.5f} ms, {len(k4)} K4 wide rounds {sum(k4):.5f} ms (bound "
              f"{k4_bound:.6f}; per round {', '.join(f'{t:.5f}' for t in k4)}), the rest "
              f"{rest[what]:.5f} ms of {whole_ms:.5f} ms; stable torch.sort "
              f"{time_ms(library, iters=5):.5f} ms")
    # the rest of the float32 ops.sort, pass by pass as kernels/ops.py runs
    # them around S1 and K4 (_argsort_batched, _sort_rounds_kv, sort_batched),
    # on operands of the same shapes; the gather takes the sort's own order
    x = fkeys[None, :]
    tk = total_order_keys(fkeys)
    perm = torch.sort(fkeys, stable=True).indices.to(torch.int32)[None, :]
    perm_long = perm.long()
    passes = {
        "total_order_keys": lambda: total_order_keys(x),
        "index payload": lambda: torch.arange(n1, dtype=torch.int32, device=device).expand(1, n1).reshape(-1),
        "tail cat of the keys": lambda: torch.cat([tk, torch.full((tile,), max_sentinel(tk.dtype), dtype=tk.dtype,
                                                                  device=device)]),
        "tail cat of the values": lambda: torch.cat([fidx, torch.zeros((tile,), dtype=torch.int32, device=device)]),
        "final slices": lambda: (tk[:n1].reshape(1, n1)[:, :n1], fidx[:n1].reshape(1, n1)[:, :n1]),
        "perm.long()": lambda: perm.long(),
        "gather": lambda: torch.gather(x, 1, perm_long),
    }
    split = {name: time_ms(fn) for name, fn in passes.items()}
    what = f"ops.sort float32 2^{log2n}"
    print(f"  {what} the rest, pass by pass (CUDA events): " + ", ".join(f"{k} {v:.5f}" for k, v in split.items())
          + f" ms; sum {sum(split.values()):.5f} of the rest {rest[what]:.5f} ms")
    return out


def rows_bound(read: int, write: int, merged: int, bytes_per_element: int) -> dict:
    """Least time of a batched merge: ``read`` input and ``write`` output
    elements moved once, against a few comparisons per merged element."""
    t_bytes = (read + write) * bytes_per_element / HBM_BYTES_PER_S * 1e3
    t_ops = merged * (math.log2(LEAF) + 2) / SCALAR_OPS_PER_S * 1e3
    return {"ms": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations"}


def ragged_lens(bsz: int, na: int, nb: int, gen, device: str):
    """``(a_lens, b_lens)``, int32, uniform in ``[0, na]`` / ``[0, nb]`` from
    the seed, the first rows the edge cases: 0/0, 0/full, full/0,
    full/full, then lengths above the row and below 0 that must clamp."""
    import torch

    al = torch.randint(0, na + 1, (bsz,), generator=gen, device=device, dtype=torch.int64)
    bl = torch.randint(0, nb + 1, (bsz,), generator=gen, device=device, dtype=torch.int64)
    edges = [(0, 0), (0, nb), (na, 0), (na, nb), (na + 7, 3 * nb + 1), (-5, nb // 2)]
    for r, (x, y) in enumerate(edges[:bsz]):
        al[r], bl[r] = x, y
    return al.to(torch.int32), bl.to(torch.int32)


def junk_tails(x, lens, gen):
    """``x`` with every slot at or past its row's length overwritten by
    unsorted junk (NaN among it for floats): a kernel that read a tail
    would show it."""
    import torch

    col = torch.arange(x.shape[1], device=x.device)[None, :]
    junk = torch.randint(-10**6, 10**6, x.shape, generator=gen, device=x.device).to(x.dtype)
    if x.dtype.is_floating_point:
        junk[:, ::7] = math.nan
    return torch.where(col < lens.clamp(min=0)[:, None], x, junk).contiguous()


def masked(x, lens):
    """``x`` with the slots past each (clamped) length set to the sentinel."""
    import torch

    from repro_torch.core.merge_path import max_sentinel

    col = torch.arange(x.shape[1], device=x.device)[None, :]
    return torch.where(col < lens.clamp(min=0)[:, None], x, torch.full((), max_sentinel(x.dtype), dtype=x.dtype, device=x.device))


def sorted_merge_rows(ak, bk, al=None, bl=None, av=None, bv=None):
    """The row merge by a stable row-wise ``torch.sort`` of ``a‖b``
    (integer keys): pads, when lengths are given, sort after every valid
    key (they are keyed past the int32 range) and come back as sentinel
    keys and zero values."""
    import torch

    from repro_torch.core.merge_path import max_sentinel

    keys = torch.cat([ak, bk], 1).long()
    vals = None if av is None else torch.cat([av, bv], 1)
    if al is not None:
        col_a = torch.arange(ak.shape[1], device=ak.device)[None, :]
        col_b = torch.arange(bk.shape[1], device=ak.device)[None, :]
        valid = torch.cat([col_a < al.clamp(min=0)[:, None], col_b < bl.clamp(min=0)[:, None]], 1)
        keys = torch.where(valid, keys, 1 << 40)
    ks, perm = torch.sort(keys, dim=1, stable=True)
    pad = ks == 1 << 40
    ks = torch.where(pad, max_sentinel(ak.dtype), ks).to(ak.dtype)
    if vals is None:
        return ks
    return ks, torch.where(pad, 0, torch.gather(vals, 1, perm))


def phase_batched(device: str = "cuda", log2n: int = 18, bsz: int = 64, log2_run: int = 21, vocab: int = 32000,
                  tile: int = TILE, leaf: int = LEAF, seed: int = 2) -> dict:
    """K5, K6, K7 and K8 on the batched, ragged and k-way merge path.

    Wide rows ``(bsz, 2^log2n) + (bsz, 2^log2n)``; ragged lengths from the
    seed with edge rows; a shape whose rows do not fill their last tile;
    rows that fit one tile (the core path); a (T, S) sweep; the benchmark's
    own small-row shapes; K5-K8 at the edges of their row spans
    (``MERGE_ROWS_SPAN``, ``MERGE_ROWS_KV_SPAN``: totals around each, rows
    that start off a 16-byte boundary, views, 2-byte keys with 4-byte
    values, lopsided and disjoint rows, ragged totals on a seam, unsorted
    rows) and ``ops.merge_k`` at k = 3 and 6 over odd run widths;
    ``ops.merge_k`` on k = 8 runs of ``2^log2_run``,
    on the sample sort's combine (an ``(8, 2^(log2_run + 1))`` stack with
    lengths around ``2^(log2_run - 3)``) and on k = 5; the ragged top-k at
    ``(4, vocab)`` and the samplers' masked vocab.  Every kernel call is
    held against its plain version bit for bit; integer merges also
    against a stable row-wise ``torch.sort``.  The path is driven once
    through ``kernels.ops`` with every count at 0 just before it.  With
    ``device="cpu"`` (the tests, at a small size) the wrappers run their
    plain versions, nothing is launched or timed, and every check runs.
    """
    import torch

    from repro_torch import core
    from repro_torch.core.merge_path import max_sentinel
    from repro_torch.kernels import merge_path as km
    from repro_torch.kernels import ops, reset_launches
    from repro_torch.serving import topk_sample, topp_sample

    on_card = device == "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n1 = 1 << log2n
    names = ("merge_batched", "merge_kv_batched", "merge_batched_ragged", "merge_kv_batched_ragged")
    errs = dict.fromkeys(names, 0)
    cases = dict.fromkeys(names, 0)
    fns = {name: getattr(km, name) for name in names}
    refs = {name: getattr(km, name + "_ref") for name in names}

    def run(name, args, what, kw=None):
        """One direct wrapper call (one launch on the card) against its plain version."""
        fn = fns[name]
        before = fn.launches
        got = fn(*args, **(kw or {"tile": tile, "leaf": leaf}))
        check(fn.launches - before == int(on_card), f"{what}: {fn.launches - before} launches")
        want = refs[name](*args)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for part, g, w in zip(("keys", "values"), got, want):
            errs[name] = max(errs[name], bit_err(g, w, f"{name} {what} {part}"))
        cases[name] += 1
        return got

    def arange_values(bsz_, na, nb, floating):
        vals = torch.arange(bsz_ * (na + nb), dtype=torch.int32, device=device).view(bsz_, na + nb)
        vals = vals.view(torch.float32) if floating else vals
        return vals[:, :na].contiguous(), vals[:, na:].contiguous()

    def kv_vs_torch_sort(what, got_kv, got_rkv, a, b, aj, bj, al, bl, av, bv):
        """K6's and K8's results on integer keys against a stable row-wise ``torch.sort``."""
        for g, w, part in zip((*got_kv, *got_rkv), (*sorted_merge_rows(a, b, None, None, av, bv),
                                                    *sorted_merge_rows(aj, bj, al, bl, av, bv)),
                              ("kv keys", "kv values", "ragged kv keys", "ragged kv values")):
            bit_err(g, w, f"{what} {part} vs torch.sort")

    def merge_cases(na, nb, families, rows=bsz, kw=None):
        """K5 and K7 over ``families`` of (dtype, kind); K6 and K8 over the
        int32 and float32 ones, with values that name their source slot."""
        for dtype, kind in families:
            a = sorted_side(kind, na, dtype, gen, device, rows)
            b = sorted_side(kind, nb, dtype, gen, device, rows)
            al, bl = ragged_lens(rows, na, nb, gen, device)
            aj, bj = junk_tails(a, al, gen), junk_tails(b, bl, gen)
            what = f"{dtype} {kind} ({rows}, {na}+{nb})"
            got = run("merge_batched", (a, b), what, kw)[0]
            got_r = run("merge_batched_ragged", (aj, bj, al, bl), what, kw)[0]
            if not dtype.is_floating_point:
                bit_err(got, sorted_merge_rows(a, b), f"merge_batched {what} vs torch.sort")
                bit_err(got_r, sorted_merge_rows(aj, bj, al, bl), f"merge_batched_ragged {what} vs torch.sort")
            if dtype not in (torch.int32, torch.float32):
                continue
            av, bv = arange_values(rows, na, nb, dtype.is_floating_point)
            got_kv = run("merge_kv_batched", (a, av, b, bv), what, kw)
            got_rkv = run("merge_kv_batched_ragged", (aj, av, bj, bv, al, bl), what, kw)
            if not dtype.is_floating_point:
                kv_vs_torch_sort(what, got_kv, got_rkv, a, b, aj, bj, al, bl, av, bv)

    # wide rows: every key dtype, adversarial families; then a short last tile
    merge_cases(n1, n1, [(torch.float32, "random"), (torch.float32, "signed_zeros"), (torch.float32, "sentinel"),
                         (torch.bfloat16, "dups"), (torch.bfloat16, "signed_zeros"),
                         (torch.int32, "random"), (torch.int32, "sentinel"), (torch.int32, "all_equal"),
                         (torch.int16, "dups"), (torch.int16, "sentinel")])
    merge_cases(n1 - 1, n1 + 3, [(torch.float32, "sentinel"), (torch.int32, "dups")])
    # the result must not depend on (T, S)
    for t, s_ in ((32, 1), (128, 8), (384, 24), (1000, 32), (4096, 64)):
        merge_cases(n1 // 8 + 123, n1 // 16 + 7, [(torch.int32, "dups"), (torch.bfloat16, "signed_zeros")],
                    rows=8, kw={"tile": t, "leaf": s_})
    # the benchmark's small rows: K5 at (64, 512 + 512), K7 at (64, 4096 + 4096)
    small_a, small_b = (sorted_side("random", 512, torch.float32, gen, device, 64) for _ in range(2))
    run("merge_batched", (small_a, small_b), "(64, 512+512)")
    rag_a, rag_b = (sorted_side("random", 4096, torch.float32, gen, device, 64) for _ in range(2))
    rag_al, rag_bl = (torch.randint(0, 4097, (64,), generator=gen, device=device).to(torch.int32) for _ in range(2))
    run("merge_batched_ragged", (rag_a, rag_b, rag_al, rag_bl), "(64, 4096+4096)")

    # K5-K8 at the edges of the row span merge (a block writes
    # MERGE_ROWS_SPAN outputs of one row, K6 and K8 MERGE_ROWS_KV_SPAN, and
    # reads exactly its two windows): totals around one span and one between
    # the tile and the span; row widths that are no multiple of 16 bytes, so
    # that output rows start off a 16-byte boundary (2-byte keys and their
    # 4-byte values at different offsets); views that start off one;
    # lopsided and disjoint rows; ragged rows of 0/0, 0/full, full/0 and
    # totals that end on a seam
    def slot_values(rows, na, nb, offs, floating):
        """Value views with the keys' row strides and offsets, each value
        naming its source slot (float keys: float32 values of the same bits)."""
        wa, wb = offs[0] + na, offs[1] + nb
        vals = torch.arange(rows * (wa + wb), dtype=torch.int32, device=device).view(rows, wa + wb)
        vals = vals.view(torch.float32) if floating else vals
        return vals[:, :wa].contiguous()[:, offs[0]:], vals[:, wa:].contiguous()[:, offs[1]:]

    def edge_case(what, na, nb, dtypes=(torch.int32, torch.int16), kind="dups", offs=(0, 0), rows=4, lens=None):
        """K5-K8 on rows ``a[:, offs[0]:]`` and ``b[:, offs[1]:]`` of
        contiguous buffers, K6 and K8 with values that name their slot;
        integers also against a stable row-wise ``torch.sort``.  ``lens``
        replaces the first rows' ragged lengths."""
        for dtype in dtypes:
            fa = sorted_side(kind, offs[0] + na, dtype, gen, device, rows)
            fb = sorted_side(kind, offs[1] + nb, dtype, gen, device, rows)
            al, bl = ragged_lens(rows, na, nb, gen, device)
            for r, (x, y) in enumerate(lens or ()):
                al[r], bl[r] = x, y
            a, b = fa[:, offs[0]:], fb[:, offs[1]:]
            aj = torch.cat([fa[:, :offs[0]], junk_tails(a, al, gen)], 1)[:, offs[0]:]
            bj = torch.cat([fb[:, :offs[1]], junk_tails(b, bl, gen)], 1)[:, offs[1]:]
            av, bv = slot_values(rows, na, nb, offs, dtype.is_floating_point)
            label = f"{what} {dtype} ({rows}, {na}+{nb}) at offsets {offs}"
            got = run("merge_batched", (a, b), label)[0]
            got_r = run("merge_batched_ragged", (aj, bj, al, bl), label)[0]
            got_kv = run("merge_kv_batched", (a, av, b, bv), label)
            got_rkv = run("merge_kv_batched_ragged", (aj, av, bj, bv, al, bl), label)
            if not dtype.is_floating_point:
                bit_err(got, sorted_merge_rows(a, b), f"merge_batched {label} vs torch.sort")
                bit_err(got_r, sorted_merge_rows(aj, bj, al, bl), f"merge_batched_ragged {label} vs torch.sort")
                kv_vs_torch_sort(label, got_kv, got_rkv, a, b, aj, bj, al, bl, av, bv)

    for span in sorted({km.MERGE_ROWS_SPAN, km.MERGE_ROWS_KV_SPAN}):
        edge_case(f"span {span}: total span - 1", span // 2, span // 2 - 1)
        edge_case(f"span {span}: total span", span // 2, span // 2, dtypes=(torch.int32, torch.float32))
        edge_case(f"span {span}: total span + 1", span // 2 + 1, span // 2)
        edge_case(f"span {span}: total between tile and span", (tile + span) // 6, (tile + span) // 3,
                  dtypes=(torch.int16, torch.bfloat16))
        edge_case(f"span {span}: odd width", 3 * span // 2 + 1, span + 2, dtypes=(torch.int32, torch.int16, torch.float32))
        edge_case(f"span {span}: views", 2 * span + 5, span - 3, offs=(1, 3), dtypes=(torch.int32, torch.int16, torch.float32))
        edge_case(f"span {span}: ragged seams", 2 * span + 3, 2 * span + 1,
                  lens=[(0, 0), (0, 2 * span + 1), (2 * span + 3, 0), (span - 5, 5), (span + 7, span - 7)], rows=6)
    edge_case("width 2 mod 8", n1 // 4 + 1, n1 // 4 + 1, dtypes=(torch.int16, torch.bfloat16))
    edge_case("views, wide", n1, n1, offs=(1, 3), kind="random", dtypes=(torch.float32, torch.int16))
    edge_case("lopsided (1, n)", 1, n1, kind="random")
    edge_case("lopsided (n, 1)", n1, 1, kind="random")
    low_high = sorted_side("random", 2 * n1, torch.int32, gen, device, 4)
    slots = torch.arange(4 * 2 * n1, dtype=torch.int32, device=device).view(4, 2 * n1)  # the keys' row strides
    av, bv = slots[:, :n1], slots[:, n1:]
    for what, (a, b) in (("A below B", (low_high[:, :n1], low_high[:, n1:])), ("A above B", (low_high[:, n1:], low_high[:, :n1]))):
        al, bl = ragged_lens(4, n1, n1, gen, device)
        got = run("merge_batched", (a, b), f"disjoint, {what}")[0]
        got_r = run("merge_batched_ragged", (a, b, al, bl), f"disjoint, {what}")[0]
        got_kv = run("merge_kv_batched", (a, av, b, bv), f"disjoint, {what}")
        got_rkv = run("merge_kv_batched_ragged", (a, av, b, bv, al, bl), f"disjoint, {what}")
        bit_err(got, sorted_merge_rows(a, b), f"merge_batched disjoint, {what} vs torch.sort")
        bit_err(got_r, sorted_merge_rows(a, b, al, bl), f"merge_batched_ragged disjoint, {what} vs torch.sort")
        kv_vs_torch_sort(f"disjoint, {what}", got_kv, got_rkv, a, b, a, b, al, bl, av, bv)
    # unsorted rows, likewise: K5-K8 stay inside their buffers
    noise = torch.randint(-1000, 1000, (4, 2 * n1), generator=gen, device=device, dtype=torch.int32)
    full = torch.full((4,), n1, dtype=torch.int32, device=device)
    for name, args in (("merge_batched", (noise[:, :n1], noise[:, n1:])),
                       ("merge_batched_ragged", (noise[:, :n1], noise[:, n1:], full, full)),
                       ("merge_kv_batched", (noise[:, :n1], av, noise[:, n1:], bv)),
                       ("merge_kv_batched_ragged", (noise[:, :n1], av, noise[:, n1:], bv, full, full))):
        before = fns[name].launches
        got = fns[name](*args, tile=tile, leaf=leaf)
        for g in got if isinstance(got, tuple) else (got,):
            int(g.long().sum())  # waits for the kernel: a fault raises here
            check(g.shape == (4, 2 * n1), f"{name} of unsorted rows: shape")
        check(fns[name].launches - before == int(on_card), f"{name} of unsorted rows: launches")
    # merge_k over odd run widths: k = 3 (2 rounds) and k = 6 (3 rounds)
    for k, width in ((3, 3 * span // 2 + 1), (6, span + 3)):
        lens = torch.randint(0, width + 1, (k,), generator=gen, device=device).to(torch.int32)
        lens[0], lens[-1] = width, 0
        runs = junk_tails(sorted_side("dups", width, torch.int32, gen, device, k), lens, gen)
        before = km.merge_batched_ragged.launches
        got = ops.merge_k(runs, lens, tile=tile, leaf=leaf)
        rounds = (k - 1).bit_length()
        check(km.merge_batched_ragged.launches - before == rounds * int(on_card),
              f"merge_k k={k}: {km.merge_batched_ragged.launches - before} K7 launches, want {rounds}")
        bit_err(got, core.merge_k(runs, lens), f"merge_k k={k} width {width} against the core tournament")
        valid = torch.cat([runs[i, : int(lens[i])] for i in range(k)])
        bit_err(got[: valid.shape[0]], torch.sort(valid, stable=True).values, f"merge_k k={k} width {width} vs torch.sort")
        check(bool((got[valid.shape[0]:] == max_sentinel(runs.dtype)).all()), f"merge_k k={k}: tail not sentinel")

    # the k-way merges: k = 8 full runs; the sample sort's combine; k = 5
    nr = 1 << log2_run
    full_runs = sorted_side("random", nr, torch.int32, gen, device, 8)
    cap = 2 * nr
    share = nr // 8
    comb_lens = torch.randint(share - share // 4, share + share // 4 + 1, (8,), generator=gen, device=device).to(torch.int32)
    comb_runs = masked(sorted_side("dups", cap, torch.int32, gen, device, 8), comb_lens)
    five_runs = sorted_side("sentinel", nr // 4, torch.int32, gen, device, 5)
    five_lens = torch.randint(0, nr // 4 + 1, (5,), generator=gen, device=device).to(torch.int32)
    five_runs = junk_tails(five_runs, five_lens, gen)
    kway = [("k=8 full", full_runs, None), ("combine", comb_runs, comb_lens), ("k=5", five_runs, five_lens)]

    # the ragged top-k and the samplers' masked vocab
    logits = torch.randn((4, vocab), generator=gen, device=device) * 3
    vocab_lens = torch.tensor([vocab, vocab - 1, 40, 7], dtype=torch.int32, device=device)

    # the path, driven once through kernels.ops with every count at 0
    wa, wb = (sorted_side("random", n1, torch.float32, gen, device, bsz) for _ in range(2))
    wak, wbk = (sorted_side("random", n1, torch.int32, gen, device, bsz) for _ in range(2))
    wav, wbv = arange_values(bsz, n1, n1, False)
    wal, wbl = ragged_lens(bsz, n1, n1, gen, device)
    waj, wbj = junk_tails(wa, wal, gen), junk_tails(wb, wbl, gen)
    wakj, wbkj = junk_tails(wak, wal, gen), junk_tails(wbk, wbl, gen)
    core_a, core_b = sorted_side("dups", tile // 4, torch.float32, gen, device, bsz), sorted_side("dups", tile // 2, torch.float32, gen, device, bsz)
    core_al, core_bl = ragged_lens(bsz, tile // 4, tile // 2, gen, device)
    reset_launches()  # every kernel's count, K1-K9
    path = {
        "merge_batched": ops.merge_batched(wa, wb, tile=tile, leaf=leaf),
        "merge_kv_batched": ops.merge_kv_batched(wak, wav, wbk, wbv, tile=tile, leaf=leaf),
        "merge_batched_ragged": ops.merge_batched_ragged(waj, wbj, wal, wbl, tile=tile, leaf=leaf),
        "merge_kv_batched_ragged": ops.merge_kv_batched_ragged(wakj, wav, wbkj, wbv, wal, wbl, tile=tile, leaf=leaf),
        "core merge_batched": ops.merge_batched(core_a, core_b, tile=tile, leaf=leaf),
        "core merge_batched_ragged": ops.merge_batched_ragged(core_a, core_b, core_al, core_bl, tile=tile, leaf=leaf),
        "topk_batched_ragged": ops.topk_batched_ragged(logits, 40, vocab_lens, tile=tile, leaf=leaf),
    }
    for what, runs, lens in kway:
        path[f"merge_k {what}"] = ops.merge_k(runs, lens, tile=tile, leaf=leaf)
    launches = {fn.__name__: fn.launches for fn in km.WRAPPERS}
    rounds = sum(max(0, (r.shape[0] - 1).bit_length()) for _, r, _ in kway)
    want = dict.fromkeys(launches, 0)
    want.update(merge_batched=1, merge_kv_batched=1, merge_batched_ragged=1 + rounds, merge_kv_batched_ragged=1,
                sort_round_kv=wide_rounds(vocab, tile), sort_tiles_kv=1)
    check(launches == (want if on_card else dict.fromkeys(want, 0)), f"batched path launched {launches}, want {want}")

    # what the path returned, against the plain versions and torch.sort
    errs["merge_batched"] = max(errs["merge_batched"], bit_err(path["merge_batched"], km.merge_batched_ref(wa, wb), "path: merge_batched"))
    for g, w, part in zip(path["merge_kv_batched"], km.merge_kv_batched_ref(wak, wav, wbk, wbv), ("keys", "values")):
        errs["merge_kv_batched"] = max(errs["merge_kv_batched"], bit_err(g, w, f"path: merge_kv_batched {part}"))
    errs["merge_batched_ragged"] = max(errs["merge_batched_ragged"], bit_err(
        path["merge_batched_ragged"], km.merge_batched_ragged_ref(waj, wbj, wal, wbl), "path: merge_batched_ragged"))
    for g, w, part in zip(path["merge_kv_batched_ragged"], km.merge_kv_batched_ragged_ref(wakj, wav, wbkj, wbv, wal, wbl),
                          ("keys", "values")):
        errs["merge_kv_batched_ragged"] = max(errs["merge_kv_batched_ragged"], bit_err(g, w, f"path: merge_kv_batched_ragged {part}"))
    for g, w, part in zip(path["merge_kv_batched"], sorted_merge_rows(wak, wbk, None, None, wav, wbv), ("keys", "values")):
        bit_err(g, w, f"path: merge_kv_batched {part} vs torch.sort")
    for g, w, part in zip(path["merge_kv_batched_ragged"], sorted_merge_rows(wakj, wbkj, wal, wbl, wav, wbv), ("keys", "values")):
        bit_err(g, w, f"path: merge_kv_batched_ragged {part} vs torch.sort")
    bit_err(path["core merge_batched"], core.merge_batched(core_a, core_b), "path: core-path merge_batched")
    bit_err(path["core merge_batched_ragged"], core.merge_batched_ragged(core_a, core_b, core_al, core_bl),
            "path: core-path merge_batched_ragged")
    for what, runs, lens in kway:
        got = path[f"merge_k {what}"]
        bit_err(got, core.merge_k(runs, lens), f"path: merge_k {what} against the core tournament")
        lens_ = torch.full((runs.shape[0],), runs.shape[1], device=device) if lens is None else lens.clamp(0, runs.shape[1])
        valid = torch.cat([runs[i, : int(lens_[i])] for i in range(runs.shape[0])])
        total = valid.shape[0]
        check(got.shape == (runs.numel(),), f"merge_k {what}: shape {tuple(got.shape)}")
        bit_err(got[:total], torch.sort(valid, stable=True).values, f"path: merge_k {what} prefix vs torch.sort")
        check(bool((got[total:] == max_sentinel(runs.dtype)).all()), f"merge_k {what}: tail not sentinel")
    for g, w, part in zip(path["topk_batched_ragged"], core.topk_batched_ragged(logits, 40, vocab_lens), ("values", "indices")):
        bit_err(g, w, f"path: topk_batched_ragged {part} against the core")
    idx = path["topk_batched_ragged"][1]
    check(bool((idx[2:, :] < vocab_lens[2:, None]).all()) and bool((idx[3, 7:] == -1).all()), "ragged top-k: a masked id")

    # the samplers' masked vocab on the kernel backend: no id reaches vocab_lens[r]
    sgen = torch.Generator(device=device)
    sgen.manual_seed(seed)
    many = logits.repeat(64, 1)
    many_lens = vocab_lens.repeat(64)
    for sampler in (lambda: topk_sample(many, sgen, k=40, temperature=0.8, vocab_lens=many_lens, backend="kernel", tile=tile, leaf=leaf),
                    lambda: topp_sample(many, sgen, p=0.9, k_max=128, vocab_lens=many_lens, backend="kernel", tile=tile, leaf=leaf)):
        ids = sampler()
        check(bool(((ids >= 0) & (ids < many_lens)).all()), f"sampler drew an id past vocab_lens: {ids[:8].tolist()}")

    print(f"batched: {cases['merge_batched']} K5, {cases['merge_kv_batched']} K6, {cases['merge_batched_ragged']} K7 and "
          f"{cases['merge_kv_batched_ragged']} K8 calls against their plain versions (rows of 2^{log2n} per side and "
          f"the edge shapes), tolerance 0 (bit-identical), max abs err {max(errs.values())}; the path launched {launches}")

    out = {name: {"launches": launches[name], "max_abs_err": errs[name], "ms": None, "plain_ms": None,
                  "library_ms": None, "bound_ms": None, "bound_by": None} for name in names}
    if not on_card:
        return out

    # times at the wide rows (CUDA events, after a warm-up call)
    n_all = bsz * 2 * n1
    valid = int(wal.clamp(0, n1).sum() + wbl.clamp(0, n1).sum())
    cat_f = torch.cat([wa, wb], 1)
    cat_k, cat_v = torch.cat([wak, wbk], 1), torch.cat([wav, wbv], 1)
    cat_fm = torch.cat([masked(waj, wal), masked(wbj, wbl)], 1)
    cat_km = torch.cat([masked(wakj, wal), masked(wbkj, wbl)], 1)
    timed = {
        "merge_batched": (lambda: km.merge_batched(wa, wb, tile=tile, leaf=leaf),
                          lambda: km.merge_batched_ref(wa, wb),
                          lambda: torch.sort(cat_f, dim=1, stable=True),
                          lambda: ops.merge_batched(wa, wb, tile=tile, leaf=leaf),
                          rows_bound(n_all, n_all, n_all, 4)),
        "merge_kv_batched": (lambda: km.merge_kv_batched(wak, wav, wbk, wbv, tile=tile, leaf=leaf),
                             lambda: km.merge_kv_batched_ref(wak, wav, wbk, wbv),
                             lambda: torch.gather(cat_v, 1, torch.sort(cat_k, dim=1, stable=True).indices),
                             lambda: ops.merge_kv_batched(wak, wav, wbk, wbv, tile=tile, leaf=leaf),
                             rows_bound(n_all, n_all, n_all, 8)),
        "merge_batched_ragged": (lambda: km.merge_batched_ragged(waj, wbj, wal, wbl, tile=tile, leaf=leaf),
                                 lambda: km.merge_batched_ragged_ref(waj, wbj, wal, wbl),
                                 lambda: torch.sort(cat_fm, dim=1, stable=True),
                                 lambda: ops.merge_batched_ragged(waj, wbj, wal, wbl, tile=tile, leaf=leaf),
                                 rows_bound(valid, n_all, valid, 4)),
        "merge_kv_batched_ragged": (lambda: km.merge_kv_batched_ragged(wakj, wav, wbkj, wbv, wal, wbl, tile=tile, leaf=leaf),
                                    lambda: km.merge_kv_batched_ragged_ref(wakj, wav, wbkj, wbv, wal, wbl),
                                    lambda: torch.gather(cat_v, 1, torch.sort(cat_km, dim=1, stable=True).indices),
                                    lambda: ops.merge_kv_batched_ragged(wakj, wav, wbkj, wbv, wal, wbl, tile=tile, leaf=leaf),
                                    rows_bound(valid, n_all, valid, 8)),
    }
    for name, (kern, plain, library, whole, bound) in timed.items():
        r = out[name]
        r.update(ms=time_ms(kern), plain_ms=time_ms(plain), library_ms=time_ms(library), bound_ms=bound["ms"],
                 bound_by=bound["by"])
        whole_ms = time_ms(whole)
        print(f"  {name:24s} ({bsz}, 2^{log2n}+2^{log2n}): kernel_ms {r['ms']:.5f}  plain_ms {r['plain_ms']:.5f}  "
              f"library_ms {r['library_ms']:.5f}  ops_ms {whole_ms:.5f}  bound_ms {r['bound_ms']:.6f} ({r['bound_by']})")
    # per-launch latency at the benchmark's small rows
    small_cat = torch.cat([small_a, small_b], 1)
    rag_cat = torch.cat([masked(rag_a, rag_al), masked(rag_b, rag_bl)], 1)
    rag_valid = int(rag_al.sum() + rag_bl.sum())
    for what, kern, plain, library, bound in (
        ("K5 (64, 512+512) float32", lambda: km.merge_batched(small_a, small_b, tile=tile, leaf=leaf),
         lambda: km.merge_batched_ref(small_a, small_b), lambda: torch.sort(small_cat, dim=1, stable=True),
         rows_bound(65536, 65536, 65536, 4)),
        ("K7 (64, 4096+4096) float32", lambda: km.merge_batched_ragged(rag_a, rag_b, rag_al, rag_bl, tile=tile, leaf=leaf),
         lambda: km.merge_batched_ragged_ref(rag_a, rag_b, rag_al, rag_bl), lambda: torch.sort(rag_cat, dim=1, stable=True),
         rows_bound(rag_valid, 64 * 8192, rag_valid, 4)),
    ):
        print(f"  {what}: kernel_ms {time_ms(kern):.5f}  plain_ms {time_ms(plain):.5f}  "
              f"library_ms {time_ms(library):.5f}  bound_ms {bound['ms']:.6f} ({bound['by']})")
    # the k-way merges whole, against the core tournament and one sort of the valid keys
    for what, runs, lens in kway:
        lens_ = torch.full((runs.shape[0],), runs.shape[1], device=device) if lens is None else lens
        valid_keys = torch.cat([runs[i, : int(lens_[i])] for i in range(runs.shape[0])])
        print(f"  ops.merge_k {what} {tuple(runs.shape)}: ops_ms {time_ms(lambda: ops.merge_k(runs, lens, tile=tile, leaf=leaf), iters=5):.5f}  "
              f"core_ms {time_ms(lambda: core.merge_k(runs, lens), iters=5):.5f}  "
              f"library_ms {time_ms(lambda: torch.sort(valid_keys, stable=True), iters=5):.5f} "
              f"({valid_keys.shape[0]} valid keys, {max(0, (runs.shape[0] - 1).bit_length())} K7 launches)")
    print(f"  ops.topk_batched_ragged (4, {vocab}) k=40: ops_ms "
          f"{time_ms(lambda: ops.topk_batched_ragged(logits, 40, vocab_lens, tile=tile, leaf=leaf)):.5f}  core_ms "
          f"{time_ms(lambda: core.topk_batched_ragged(logits, 40, vocab_lens)):.5f}")
    return out


def phase_serving() -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.merge_path import sort_round_kv, sort_tiles_kv
    from repro_torch.models import forward_decode, init_caches, init_params
    from repro_torch.serving import Request, ServingEngine, topk_sample

    cfg = get_config("tinyllama-1.1b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"serving: {cfg.name} full width ({cfg.num_layers} layers, d={cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}), {n_bytes / 1e9:.3f} GB of weights from seed 0 in {time.perf_counter() - t0:.2f} s")
    engine = ServingEngine(cfg, params, batch=2, max_seq=64, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    for uid in range(4):
        prompt = rng.integers(1, cfg.vocab_size, size=int(rng.integers(4, 12))).astype(np.int32)
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=8, temperature=0.8, topk=40))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = engine.run_until_done()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = sort_round_kv.launches
    tiles_launches = sort_tiles_kv.launches

    tokens = [t for r in engine.done.values() for t in r.generated]
    check(report.ok(), f"serving report not ok: {report.statuses} {report.reasons}")
    check(report.retries == 0, f"serving retried {report.retries} ticks: {report.reasons}")
    check(report.completed == 4 and len(engine.done) == 4, f"completed {report.completed} of 4")
    check(all(0 <= t < cfg.vocab_size for t in tokens), f"token out of range: {tokens}")
    check(launches == 6 * len(tokens), f"K4 launched {launches} times for {len(tokens)} sampled tokens (want 6 each)")
    check(tiles_launches == len(tokens), f"S1 launched {tiles_launches} times for {len(tokens)} sampled tokens (want 1 each)")
    print(f"serving: 4 requests, {len(tokens)} sampled tokens in {seconds:.3f} s "
          f"({seconds * 1e3 / len(tokens):.2f} ms/token, prefill included), K4 launches {launches}, "
          f"S1 launches {tiles_launches}")

    # breakdown at the same shapes: one lockstep decode step, one sampled token
    caches = init_caches(cfg, 2, 64, device="cuda")
    tok = torch.ones((2, 1), dtype=torch.int64, device="cuda")
    pos = torch.zeros(2, dtype=torch.int64, device="cuda")
    logits, _ = forward_decode(cfg, params, caches, tok, pos)
    check(tuple(logits.shape) == (2, cfg.vocab_size) and bool(torch.isfinite(logits.float()).all()), "decode logits not finite")
    step_ms = time_ms(lambda: forward_decode(cfg, params, caches, tok, pos), iters=10)
    sgen = torch.Generator(device="cuda")
    sample_ms = time_ms(lambda: topk_sample(logits[:1], sgen, k=40, temperature=0.8, backend="kernel"), iters=10)
    print(f"serving: decode step (batch 2) {step_ms:.3f} ms, one top-k sample (1, 32000) {sample_ms:.3f} ms (CUDA events)")
    del params, engine, caches
    torch.cuda.empty_cache()
    return {"launches": launches, "tiles_launches": tiles_launches, "tokens": len(tokens),
            "ms_per_token": seconds * 1e3 / len(tokens)}


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def phase_reference() -> None:
    """The reduced config on the card against the same weights on the CPU."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import topk_batched as core_topk
    from repro_torch.kernels import ops
    from repro_torch.models import forward_decode, init_caches, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("tinyllama-1.1b").reduced()  # float32, 2 layers, d=64, vocab 256
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = {"embed": {"table": cpu["embed"]["table"].cuda()}, "final_norm": cpu["final_norm"].cuda(),
           "layers": _to(cpu["layers"], "cuda")}
    caches = {dev: init_caches(cfg, 2, 16, device=dev) for dev in ("cpu", "cuda")}
    tok = torch.tensor([[3], [7]])
    for t in range(4):
        pos = torch.full((2,), t)
        lc, _ = forward_decode(cfg, cpu, caches["cpu"], tok, pos)
        lg, _ = forward_decode(cfg, gpu, caches["cuda"], tok.cuda(), pos.cuda())
        # float32 sums run in another order on the card: 1e-4 covers it
        check(torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4), f"reduced logits differ at step {t}: {float((lg.cpu() - lc).abs().max())}")
        check(torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)), f"greedy tokens differ at step {t}")
        tok = lc.argmax(-1, keepdim=True)
    vals, idx = ops.topk_batched(lg, 40, tile=128)  # vocab 256 at tile 128: one K4 round
    cv, ci = core_topk(lg.cpu(), 40)
    check(torch.equal(idx.cpu(), ci) and torch.equal(vals.cpu(), cv), "reduced top-k differs from the CPU core path")
    print("reference: reduced tinyllama on the card matches the CPU within 1e-4 over 4 decode steps; top-k identical")


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def _copy(tree, device):
    """A copy of a state on ``device``, also where it lies there already (a
    train step updates its state in place)."""
    return {k: _copy(v, device) if isinstance(v, dict) else v.to(device, copy=True) for k, v in tree.items()}


SCAN_SHAPES = ((1, 4096), (4, 1000), (3, 129), (2, 1))  # (B, S) at the layer's D and st
SCAN_EDGES = ((2, 77, 200, 16), (2, 77, 200, 8), (1, 50, 40, 16))  # (B, S, D, st): ragged D, both st
SCAN_CHUNK = 128  # falcon-mamba's ssm_chunk
TILE_K9 = 32  # K9's tile: with checkpoints, the chunk is a multiple of it
# K9 against its plain version: the kernel's exp is ex2.approx (a few float32
# ulps each) and its sums run in another order, and the error of a state is the
# sum of its steps' errors over the recurrence's memory (about 1 / |dt * a|
# steps), which on these inputs (dt = softplus(N(0, 1)), a = -exp(N(0, 1)),
# the reference's own test inputs) stays within 1e-5 of max|y|.  A bfloat16 y
# may also round to the neighbouring value: one bfloat16 ulp more.
SCAN_RTOL, SCAN_ATOL = 1e-5, 1e-6
# prefill against stepping at full width, of max|state|: the conv states are
# the same bfloat16 values (read 0), and the ssm states differ by K9's
# ex2.approx against torch.exp and their sums' order (read 4.67e-8 of max,
# PERF.md); 1e-5 is SCAN_RTOL, the kernel's own bound against its plain version
STEP_RTOL = 1e-5


def scan_bound(bsz: int, s: int, d: int, st: int, sizes) -> dict:
    """Least time of one K9 call: each input read once and each output
    written once (``sizes`` = bytes of dt, x and y, B and C, a; h_final in
    float32), against 7 float32 operations per state and step and one per
    (b, t, d) (``dt * x``) at the card's float32 rate outside the tensor
    cores.  Also the time of its exponentials alone on the special-function
    units (``SFU_EX2_PER_S``), the floor that binds K9."""
    dt_b, x_b, bc_b, a_b = sizes
    n = bsz * s * d
    nbytes = n * (dt_b + 2 * x_b) + 2 * bsz * s * st * bc_b + d * st * a_b + 4 * bsz * d * st
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n + 7 * n * st) / SCALAR_OPS_PER_S * 1e3
    return {"ms": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops, "exp_unit_ms": n * st / SFU_EX2_PER_S * 1e3}


def scan_inputs(bsz: int, s: int, d: int, st: int, act_dtype, gen, device: str):
    """``(dt float32, x, B, C, a)`` as the model hands them to K9, with
    ``x``/``B``/``C``/``a`` in ``act_dtype``."""
    import torch
    import torch.nn.functional as F

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    dt = F.softplus(normal(bsz, s, d))
    x, bm, cm = normal(bsz, s, d).to(act_dtype), normal(bsz, s, st).to(act_dtype), normal(bsz, s, st).to(act_dtype)
    return dt, x, bm, cm, (-torch.exp(normal(d, st))).to(act_dtype)


def scan_err(got, want, what: str, rtol: float = SCAN_RTOL, atol: float = SCAN_ATOL) -> float:
    """Max abs difference of two results; raises unless every element lies
    within ``rtol * max|want| + atol`` (plus one ulp of the value for bfloat16)."""
    import torch

    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: dtype/shape {got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}")
    g, w = got.double(), want.double()
    check(bool(torch.isfinite(g).all()), f"{what}: not finite")
    tol = rtol * float(w.abs().max()) + atol
    if got.dtype == torch.bfloat16:  # one ulp: 8 significant bits
        tol = tol + torch.where(w == 0, 0.0, torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8))
    err = (g - w).abs()
    check(bool((err <= tol).all()), f"{what}: differs by {float(err.max())} (max|want| {float(w.abs().max())})")
    return float(err.max())


def phase_ssm(device: str = "cuda", arch: str = "falcon-mamba-7b", reduce: bool = False, prompt: int = 32768,
              new_tokens: int = 16, step_prompt: int = 64, shapes=SCAN_SHAPES, d: int = 8192, st: int = 16,
              edges=SCAN_EDGES, seed: int = 3) -> dict:
    """K9 and falcon-mamba-7b: prefill on the fused scan kernel, then decode.

    1. K9 against its plain version at the layer's shapes ``(B, S)`` in
       ``shapes`` at ``(d, st)``, and at the ``edges`` (a D that is no
       multiple of the block's 32 channels, both state widths the kernel
       takes): the main path's dtypes (dt float32, x/B/C/a bfloat16) and
       all-float32, with and without chunk checkpoints; y, h_final and
       hstart within the stated tolerance.
    2. The main path, driven once with every count at 0: ``arch`` at full
       width (random weights from seed 0, ``ssm_backend="fused"``),
       ``make_prefill_step`` on a ``(1, prompt)`` prompt, then
       ``new_tokens`` tokens sampled with top-k 40 on K4, the first from
       the prefill's logits and each next one after a ``make_decode_step``.
       K9 must run once per layer, K4 its wide rounds per sampled token.
       Then K9 on layer 0's own inputs against its plain version, twice
       bit-identical, with and without checkpoints (y and h_final
       bit-identical; the checkpoints of chunk 32 those of chunk 128 where
       the starts coincide); a bfloat16 x whose rows break the kernel's
       16-byte rule raises and launches nothing; the times.
    3. Prefill against stepping: layer 0's states after ``make_prefill_step``
       of the first ``step_prompt`` tokens against ``step_prompt`` decode
       steps, at full width; then the reduced config (float32) on this
       device against the same weights on the CPU (prefill, then 4 decode
       steps).
    With ``device="cpu"`` and ``reduce=True`` (the tests, at a small size)
    the wrappers run their plain versions, nothing is launched or timed,
    and every check still runs.
    """
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import WRAPPERS, reset_launches
    from repro_torch.kernels import ssm_scan as ks
    from repro_torch.kernels.tune import pick
    from repro_torch.models import init_caches, init_params
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.transformer import _dtype
    from repro_torch.serving import topk_sample
    from repro_torch.train import make_decode_step, make_prefill_step
    from repro_torch.train.steps import _cast

    on_card = device == "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    max_err, cases = 0.0, 0

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def compare(args, what, checkpoints, chunk=SCAN_CHUNK):
        nonlocal max_err, cases
        before = ks.ssm_scan.launches
        got = ks.ssm_scan(*args, chunk=chunk, checkpoints=checkpoints)
        check(ks.ssm_scan.launches - before == int(on_card), f"ssm_scan {what}: {ks.ssm_scan.launches - before} launches")
        want = ks.ssm_scan_ref(*args, chunk=chunk, checkpoints=checkpoints)
        for part, g, w in zip(("y", "h_final", "hstart"), got, want):
            max_err = max(max_err, scan_err(g, w, f"ssm_scan {what} {part}"))
        cases += 1
        return got

    # 1. K9 against its plain version
    for bsz, s, d_, st_ in [(b, s_, d, st) for b, s_ in shapes] + list(edges):
        for act in (torch.bfloat16, torch.float32):
            args = scan_inputs(bsz, s, d_, st_, act, gen, device)
            for ckpt in (False, True):
                compare(args, f"({bsz}, {s}, {d_}, {st_}) x {str(act)[6:]} checkpoints={ckpt}", ckpt)
    print(f"ssm: {cases} K9 calls against the plain version (y, h_final, hstart) within {SCAN_RTOL:g} * max|want| "
          f"+ {SCAN_ATOL:g} (bfloat16 y: + 1 ulp), max abs err {max_err:.3g}")

    # 2. the main path at full width, driven once with every count at 0
    base = get_config(arch)
    cfg = dataclasses.replace(base.reduced() if reduce else base, ssm_backend="fused")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"ssm: {cfg.name} ({cfg.num_layers} layers, d={cfg.d_model}, d_inner={cfg.d_inner}, state {cfg.ssm_state}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}, fused scan), {n_bytes / 1e9:.3f} GB of weights from seed 0 "
          f"in {time.perf_counter() - t0:.2f} s")
    params = _cast(params, _dtype(cfg))  # once, as the engine does: the steps' own cast then copies nothing
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    tokens = torch.randint(1, cfg.vocab_size, (1, prompt), generator=gen, device=device)
    sgen = torch.Generator(device=device)
    sgen.manual_seed(seed)
    layer0 = []
    real_scan = ssm_mod.ssm_scan

    def keep_layer0(*args, **kw):  # the model's own K9 inputs of layer 0, for the checks below
        if not layer0:
            layer0.append((args, kw))
        return real_scan(*args, **kw)

    ssm_mod.ssm_scan = keep_layer0
    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        sync()
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": tokens})
        sync()
        prefill_s = time.perf_counter() - t0
        prefill_k9 = ks.ssm_scan.launches
        state0 = caches["sub0"]["ssm"][0].clone()
        sampled = [topk_sample(logits, sgen, k=40, temperature=0.8, backend="kernel")]
        sync()
        t0 = time.perf_counter()
        for i in range(new_tokens - 1):
            pos = torch.full((1,), prompt + i, device=device)
            logits, caches = decode(params, caches, sampled[-1][:, None], pos)
            sampled.append(topk_sample(logits, sgen, k=40, temperature=0.8, backend="kernel"))
        sync()
        decode_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in WRAPPERS}
    finally:
        ssm_mod.ssm_scan = real_scan
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    k4_rounds = wide_rounds(cfg.vocab_size, pick(cfg.vocab_size)[0])
    want = dict.fromkeys(launches, 0)
    want.update(ssm_scan=cfg.num_layers, sort_round_kv=new_tokens * k4_rounds, sort_tiles_kv=new_tokens)
    check(prefill_k9 == (cfg.num_layers if on_card else 0), f"prefill launched K9 {prefill_k9} times")
    check(launches == (want if on_card else dict.fromkeys(want, 0)), f"ssm path launched {launches}, want {want}")
    ids = torch.cat(sampled)
    check(ids.shape == (new_tokens,) and bool(((ids >= 0) & (ids < cfg.vocab_size)).all()), f"sampled ids {ids.tolist()}")
    check(tuple(logits.shape) == (1, cfg.vocab_size) and bool(torch.isfinite(logits.float()).all()), "decode logits not finite")
    for name, t in caches["sub0"].items():
        check(bool(torch.isfinite(t.float()).all()), f"cache {name} not finite")
    print(f"ssm: prefill (1, {prompt}) in {prefill_s * 1e3:.1f} ms, K9 launched {prefill_k9} times; {new_tokens} tokens "
          f"sampled (top-k 40), {new_tokens - 1} decode steps in {decode_s * 1e3:.1f} ms "
          f"({decode_s * 1e3 / max(1, new_tokens - 1):.2f} ms per step with its sample); K4 launched "
          f"{launches['sort_round_kv']} times ({k4_rounds} wide rounds per token: vocab {cfg.vocab_size} pads to "
          f"{1 << (cfg.vocab_size - 1).bit_length()}); peak memory "
          f"{'not measured' if peak_gb is None else f'{peak_gb:.2f} GB'}; ids {ids.tolist()}")

    # K9 on layer 0's own inputs; its state is the one the prefill cached
    args0, kw0 = layer0[0]
    got = compare(args0, f"layer 0 of the prefill {tuple(args0[1].shape)}", False, kw0["chunk"])
    check(torch.equal(got[1], state0), "layer 0's cached state is not K9's h_final on the same inputs")
    again = ks.ssm_scan(*args0, **kw0)
    check(torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]), "two K9 launches on layer 0's inputs differ")
    ck = {n: ks.ssm_scan(*args0, chunk=n, checkpoints=True) for n in (TILE_K9, SCAN_CHUNK)}
    for n, (y_n, h_n, _) in ck.items():
        check(torch.equal(y_n, got[0]) and torch.equal(h_n, got[1]), f"K9 with checkpoints every {n} changed y or h_final")
    check(torch.equal(ck[TILE_K9][2][:, ::SCAN_CHUNK // TILE_K9], ck[SCAN_CHUNK][2]),
          f"K9's checkpoints of chunk {TILE_K9} and {SCAN_CHUNK} differ at their shared starts")
    del again, ck
    bad = scan_inputs(1, 8, 20, 16, torch.bfloat16, gen, device)  # D = 20: 40-byte rows of x
    with_rule = False
    try:
        ks.check_kernel_rules(*bad, SCAN_CHUNK, False)
    except ValueError:
        with_rule = True
    check(with_rule, "K9's rules took a bfloat16 x of 40-byte rows")
    if on_card:
        before = ks.ssm_scan.launches
        try:
            ks.ssm_scan(*bad)
            raised = False
        except ValueError:
            raised = True
        check(raised and ks.ssm_scan.launches == before, "K9 launched on a bfloat16 x of 40-byte rows")
    print(f"ssm: K9 on layer 0's inputs: two launches bit-identical; checkpoints every {TILE_K9} and {SCAN_CHUNK} "
          f"leave y and h_final bit-identical and agree at their shared starts; a bfloat16 x of D = 20 "
          f"{'raises and launches nothing' if on_card else 'breaks the rules'}")
    out = {"launches": prefill_k9, "max_abs_err": max_err, "ms": None, "plain_ms": None, "bound_ms": None,
           "bound_by": None, "library_ms": None}
    if on_card:
        bsz, s = args0[1].shape[:2]
        sizes = tuple(t.element_size() for t in (args0[0], args0[1], args0[2], args0[4]))
        bound = scan_bound(bsz, s, args0[1].shape[2], args0[2].shape[2], sizes)
        out.update(ms=time_ms(lambda: ks.ssm_scan(*args0, **kw0)),
                   plain_ms=time_ms(lambda: ks.ssm_scan_ref(*args0, **kw0), iters=1),
                   bound_ms=bound["ms"], bound_by=bound["by"])
        step_ms = time_ms(lambda: decode(params, caches, sampled[-1][:, None], pos), iters=5)
        print(f"  K9 {tuple(args0[1].shape)} st {args0[2].shape[2]} (dt {args0[0].dtype}, x {args0[1].dtype}): "
              f"kernel_ms {out['ms']:.5f}  plain_ms {out['plain_ms']:.3f}  bound_ms {bound['ms']:.6f} ({bound['by']}; "
              f"bytes {bound['bytes_ms']:.6f}, float32 ops {bound['ops_ms']:.6f}, exponentials on the SFUs "
              f"{bound['exp_unit_ms']:.6f}); kernel {out['ms'] / bound['exp_unit_ms']:.3f}x the SFU floor, "
              f"{out['ms'] / bound['ms']:.3f}x the bound; K9 in all {out['ms'] * prefill_k9:.2f} ms of the "
              f"{prefill_s * 1e3:.1f} ms prefill; one decode step alone {step_ms:.3f} ms (CUDA events)")
    del layer0, args0, got, caches

    # 3. prefill against stepping at this width, on layer 0's states
    short = tokens[:, :step_prompt]
    _, pre = prefill(params, {"tokens": short})
    stepped = init_caches(cfg, 1, step_prompt, device=device)
    for t in range(step_prompt):
        decode(params, stepped, short[:, t:t + 1], torch.full((1,), t, device=device))
    step_err = {name: scan_err(pre["sub0"][name][0].float(), stepped["sub0"][name][0].float(),
                               f"prefill against stepping, layer 0 {name}", STEP_RTOL, 0.0)
                for name in ("ssm", "conv")}
    rel = {k: v / float(stepped["sub0"][k][0].float().abs().max()) for k, v in step_err.items()}
    print(f"ssm: layer 0 after prefill of {step_prompt} tokens against {step_prompt} decode steps: max abs err "
          f"ssm {step_err['ssm']:.3g} ({rel['ssm']:.3g} of max), conv {step_err['conv']:.3g} ({rel['conv']:.3g} of max), "
          f"tolerance {STEP_RTOL:g} of max")
    del params, pre, stepped
    if on_card:
        torch.cuda.empty_cache()
    reduced_against_cpu(device, arch)
    return out


BWD_SHAPES = ((1, 4096), (2, 1000))  # (B, S) at the layer's D and st: the training run's and B > 1
# (B, S, D, st): ragged D, both state widths, S = 1, S below the 32-step tile, a short last tile
BWD_EDGES = ((2, 77, 200, 16), (2, 77, 200, 8), (1, 1, 40, 16), (1, 31, 32, 8), (3, 129, 64, 16))
FN_SHAPE = (2, 300, 512, 16)  # the Function against autograd through the plain scan
# K10 against its plain version, of max|want| per gradient: the kernel's exp is
# ex2.approx (a few float32 ulps) where the plain version's is torch.exp, the
# states and the carried gradient g sum their steps' errors over the
# recurrence's memory, and dB, dC and dA sum over D or S terms in another
# order.  On the reference's input distribution (dt = softplus(N(0, 1)),
# a = -exp(N(0, 1))) the reading stays several times below 2e-5 (PERF.md), which
# leaves room for the longer sums of other shapes.  The reference's own tests
# hold its backward to jax.grad within 2e-4 (float32).
BWD_RTOL = 2e-5
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_STEPS = 16, 4096, 3  # 16 of 64 layers: 112 GB of state for all 64
CMP_LAYERS, CMP_SEQ = 2, 1024  # fused against plain: the "scan" backend materialises (B, S, 8192, 16)
# the fused and "scan" backends at full width in bfloat16, of max|want| per leaf
# of the gradient (and of the loss and grad norm): the fused scan rounds y to
# bfloat16 (x's dtype) where the "scan" backend keeps it float32, and the
# bfloat16 network carries that rounding (2^-9 relative) through every later
# product
CMP_RTOL = 3e-2
# the reduced config (float32) on the card against the CPU, one train step:
# float32 sums in another order, ex2.approx against torch.exp
TRAIN_REF_TOL = 1e-4


def bwd_bound(bsz: int, s: int, d: int, st: int, sizes, work_floats: int) -> dict:
    """Least time of one K10 call: each of the function's inputs read once
    and each of its outputs written once (``sizes`` = bytes of dt, x, dy,
    B and C, a; the checkpoints every 32 steps, dh_final and the five
    gradients float32), against 20 float32 operations per state and step
    (5 of the recompute, 15 of the reverse pass) at the card's float32
    rate outside the tensor cores.  ``partial_bytes`` are K10's workspace
    of ``work_floats`` float32 (its partials of dB and dC, one per block
    of 64 channels, and of dA; ``ssm_scan.bwd_work_floats``), written
    once and read once: overhead of the design, not in the bound.
    ``exp_unit_ms`` is the time of the exponentials alone on the
    special-function units: one per state and step, the least the function
    needs (the reverse pass can use the decay the recompute formed; a
    design that forms it again doubles this time)."""
    dt_b, x_b, dy_b, bc_b, a_b = sizes
    n, ns = bsz * s * d, bsz * s * st
    n_ck = bsz * -(-s // 32) * d * st
    nbytes = (n * (dt_b + x_b + dy_b) + 2 * ns * bc_b + d * st * a_b + 4 * n_ck + 4 * bsz * d * st
              + 4 * (2 * n + 2 * ns + d * st))
    partial_bytes = 2 * 4 * work_floats
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 20 * n * st / SCALAR_OPS_PER_S * 1e3
    return {"ms": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops, "bytes": nbytes, "partial_bytes": partial_bytes,
            "exp_unit_ms": n * st / SFU_EX2_PER_S * 1e3}


def _fingerprints(tree):
    """Per leaf: its float64 sum and norm, to tell whether it moved without a copy."""
    import torch

    return [torch.stack([t.sum(dtype=torch.float64), torch.linalg.vector_norm(t, dtype=torch.float64)])
            for t in _leaves(tree)]


def phase_train(device: str = "cuda", reduce: bool = False, shapes=BWD_SHAPES, d: int = 8192, st: int = 16,
                edges=BWD_EDGES, fn_shape=FN_SHAPE, layers: int = TRAIN_LAYERS, seq: int = TRAIN_SEQ,
                steps: int = TRAIN_STEPS, cmp_layers: int = CMP_LAYERS, cmp_seq: int = CMP_SEQ,
                seed: int = 5) -> dict:
    """K10 and training falcon-mamba-7b on the fused scan.

    1. K10 against its plain version on K9's own checkpoints: the layer's
       shapes ``(B, S)`` in ``shapes`` at ``(d, st)`` and the ``edges``, the
       model's dtypes (dt float32; x, B, C, a and dy bfloat16) and
       all-float32, dh_final zero and nonzero; each gradient within
       ``BWD_RTOL`` of its max; two launches bit-identical.
    2. ``SsmScanFunction`` (K9 forward, K10 backward) against autograd
       through the plain scan, on the gradients of a scalar loss of y and
       h_final, at ``fn_shape``.
    3. Fused against plain at full width: falcon-mamba-7b at its published
       widths with ``cmp_layers`` layers, one ``loss_and_grads`` and one
       ``make_train_step`` step with ``ssm_backend="fused"`` and with
       ``"scan"`` from one state and batch ``(1, cmp_seq)``: the loss, the
       grad norm and every leaf's gradient within ``CMP_RTOL``.
    4. The main path, driven once with every count at 0: falcon-mamba-7b at
       full width cut to ``layers`` layers, float32 masters from seed 0,
       ``steps`` steps of ``make_train_step`` from step 1 on ``(1, seq)``
       batches of ``SyntheticLMPipeline`` (seed 0).  The loss finite every
       step; beforehand, every leaf's gradient of the first batch finite and
       nonzero; afterwards every leaf moved; K10 launched once per layer and
       step, K9 twice (the forward, and its recompute under the per-layer
       remat).  Then K10 on layer 0's own operands against its plain
       version, its times, and a ``launch/profile.py`` trace of one more step.
    5. The reduced config (float32, fused) on this device against the CPU:
       one train step from the same state, loss and new parameters within
       ``TRAIN_REF_TOL``.
    With ``device="cpu"`` and ``reduce=True`` (the tests, at a small size)
    the wrappers run their plain versions, the full-width configs are the
    reduced one, nothing is launched, timed or traced, and every check
    still runs.
    """
    import dataclasses

    import torch

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLMPipeline
    from repro_torch.kernels import WRAPPERS, reset_launches
    from repro_torch.kernels import ssm_scan as ks
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.smoke import leaf_report
    from repro_torch.train.steps import loss_and_grads

    on_card = device == "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    max_err, max_rel, cases = 0.0, 0.0, 0
    chunk = ks.GRAD_CHUNK

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def bwd_compare(args, dy, dh, what):
        """K10 on one case against its plain version; two launches bit-identical."""
        nonlocal max_err, max_rel, cases
        before = ks.ssm_scan_bwd.launches
        got = ks.ssm_scan_bwd(*args, dy, dh, chunk=chunk)
        again = ks.ssm_scan_bwd(*args, dy, dh, chunk=chunk)
        check(ks.ssm_scan_bwd.launches - before == 2 * int(on_card), f"ssm_scan_bwd {what}: launches")
        check(all(torch.equal(g, h) for g, h in zip(got, again)), f"ssm_scan_bwd {what}: two launches differ")
        want = ks.ssm_scan_bwd_ref(*args, dy, dh, chunk=chunk)
        for part, g, w in zip(("ddt", "dx", "dB", "dC", "dA"), got, want):
            err = scan_err(g, w, f"ssm_scan_bwd {what} {part}", BWD_RTOL, 0.0)
            max_err, max_rel = max(max_err, err), max(max_rel, err / max(float(w.abs().max()), 1e-30))
        cases += 1

    # 1. K10 against its plain version, on K9's own checkpoints
    for bsz, s, d_, st_ in [(b, s_, d, st) for b, s_ in shapes] + list(edges):
        for act in (torch.bfloat16, torch.float32):
            args = scan_inputs(bsz, s, d_, st_, act, gen, device)
            y, h, hstart = ks.ssm_scan(*args, chunk=chunk, checkpoints=True)
            dy = torch.randn(y.shape, generator=gen, device=device).to(act)
            for dh_zero in (True, False):
                dh = torch.zeros_like(h) if dh_zero else torch.randn(h.shape, generator=gen, device=device)
                bwd_compare(args + (hstart,), dy, dh, f"({bsz}, {s}, {d_}, {st_}) x {str(act)[6:]} "
                            f"dh_final={'0' if dh_zero else 'N(0, 1)'}")
    print(f"train: {cases} K10 calls against the plain version (ddt, dx, dB, dC, dA) within {BWD_RTOL:g} * "
          f"max|want|, max abs err {max_err:.3g}, largest {max_rel:.3g} of max; two launches bit-identical in each")

    # 2. the Function against autograd through the plain scan
    fn_err = 0.0
    for act in (torch.bfloat16, torch.float32):
        args = scan_inputs(*fn_shape, act, gen, device)
        wy = torch.randn(fn_shape[:3], generator=gen, device=device)
        wh = torch.randn((fn_shape[0], fn_shape[2], fn_shape[3]), generator=gen, device=device)
        grads = []
        for scan in (ks.ssm_scan, ks.ssm_scan_ref):
            ops = [t.clone().requires_grad_() for t in args]
            before = ks.ssm_scan_bwd.launches
            y, h = scan(*ops, chunk=chunk)
            loss = (y.float() * wy).sum() + (h * wh).sum()
            grads.append(torch.autograd.grad(loss, ops))
            want_k10 = int(on_card and scan is ks.ssm_scan)
            check(ks.ssm_scan_bwd.launches - before == want_k10, f"the Function launched K10 "
                  f"{ks.ssm_scan_bwd.launches - before} times, want {want_k10}")
        for name, g, w in zip(("dt", "x", "B", "C", "a"), *grads):
            err = scan_err(g, w, f"SsmScanFunction {fn_shape} x {str(act)[6:]} d{name}", BWD_RTOL, 0.0)
            fn_err = max(fn_err, err / max(float(w.abs().max()), 1e-30))
    print(f"train: SsmScanFunction {fn_shape} against autograd through the plain scan, bfloat16 and float32 "
          f"operands: every gradient within {BWD_RTOL:g} of max (+ 1 ulp for bfloat16), largest {fn_err:.3g} of max")

    # 3. fused against plain at full width: one state, one batch
    base = get_config("falcon-mamba-7b")
    full = base.reduced() if reduce else base
    tcfg = TrainConfig(z_loss=1e-4, grad_clip=1.0)
    cmp = {b: dataclasses.replace(full, num_layers=cmp_layers, ssm_backend=b) for b in ("fused", "scan")}
    state = init_train_state(cmp["fused"], tcfg, seed=0, device=device)
    state["step"].fill_(1)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in SyntheticLMPipeline(full, 1, cmp_seq, PipelineConfig(seed=0)).batch_at(0).items()}
    out = {b: loss_and_grads(c, tcfg, state["params"], batch) for b, c in cmp.items()}
    (lf, _, gf), (ls, _, gs) = out["fused"], out["scan"]
    cmp_err = {"loss": abs(float(lf) - float(ls)) / abs(float(ls)),
               "grad_norm": abs(float(global_norm(gf)) - float(global_norm(gs))) / float(global_norm(gs))}
    for (name, _, _), a, b in zip(leaf_report(gf), _leaves(gf), _leaves(gs)):
        cmp_err[name] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    del out, gf, gs
    metrics = {}
    for b, c in cmp.items():
        st_b = _copy(state, device)
        metrics[b] = make_train_step(c, tcfg)(st_b, batch)[1]
        del st_b
    for key in ("loss", "grad_norm"):
        cmp_err[f"step {key}"] = abs(float(metrics["fused"][key]) - float(metrics["scan"][key])) / abs(
            float(metrics["scan"][key]))
    worst = max(cmp_err, key=cmp_err.get)
    check(cmp_err[worst] <= CMP_RTOL, f"fused against scan at full width: {worst} differs by {cmp_err[worst]:.3g} of max")
    print(f"train: fused against scan, {full.name} {cmp_layers} layers (1, {cmp_seq}): loss {float(lf):.5f} against "
          f"{float(ls):.5f}, loss, grad norm and {len(cmp_err) - 4} leaves' gradients within {CMP_RTOL:g} of max "
          f"(largest: {worst} {cmp_err[worst]:.3g})")
    del state, batch, metrics
    if on_card:
        torch.cuda.empty_cache()

    # 4. the main path: training at full width, driven once with every count at 0
    cfg = dataclasses.replace(full, num_layers=layers, ssm_backend="fused")
    t0 = time.perf_counter()
    state = init_train_state(cfg, tcfg, seed=0, device=device)
    state["step"].fill_(1)
    sync()
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(state))
    print(f"train: {cfg.name} at full width cut to {layers} of {base.num_layers} layers (d={cfg.d_model}, "
          f"d_inner={cfg.d_inner}, state {cfg.ssm_state}, vocab {cfg.vocab_size}, {cfg.dtype}, fused scan): "
          f"{n_params / 1e9:.3f} B parameters, {n_bytes / 1e9:.2f} GB of float32 masters and moments from "
          f"seed 0 in {time.perf_counter() - t0:.2f} s")
    pipe = SyntheticLMPipeline(cfg, 1, seq, PipelineConfig(seed=0))
    batches = [{k: torch.as_tensor(v, device=device) for k, v in pipe.batch_at(i).items()}
               for i in range(1, steps + 1)]
    _, _, grads = loss_and_grads(cfg, tcfg, state["params"], batches[0])
    bad = [(n, f, z) for n, f, z in leaf_report(grads) if not (f and z)]
    check(not bad, f"gradient leaves not finite or zero: {bad}")
    n_leaves = len(leaf_report(grads))
    del grads
    before = _fingerprints(state["params"])
    step_fn = make_train_step(cfg, tcfg)
    layer0 = []
    real_bwd = ks._backward

    def keep_layer0(saved, dy, dh):  # the last K10 of a backward is layer 0's: its operands, for the checks below
        layer0[:] = [tuple(t.detach() for t in saved), dy.contiguous(), dh.float().contiguous()]
        return real_bwd(saved, dy, dh)

    losses, step_ms = [], []
    ks._backward = keep_layer0
    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        sync()
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            if on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            state, m = step_fn(state, batch)
            if on_card:
                ev[1].record()
                ev[1].synchronize()
                step_ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(m["loss"]))
            check(math.isfinite(losses[-1]) and math.isfinite(float(m["grad_norm"])),
                  f"step {i + 1}: loss {losses[-1]}, grad norm {float(m['grad_norm'])}")
            if i == 0:
                ks._backward = real_bwd  # layer 0's operands of the first step are kept
        sync()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in WRAPPERS}
    finally:
        ks._backward = real_bwd
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    want = dict.fromkeys(launches, 0)
    want.update(ssm_scan=2 * layers * steps, ssm_scan_bwd=layers * steps)
    check(launches == (want if on_card else dict.fromkeys(want, 0)), f"train path launched {launches}, want {want}")
    after = _fingerprints(state["params"])
    still = [name for (name, _, _), a, b in zip(leaf_report(state["params"]), before, after) if torch.equal(a, b)]
    check(not still, f"parameters did not move: {still}")
    check(int(state["step"]) == 1 + steps, f"step counter {int(state['step'])}")
    ms = sum(step_ms[1:]) / max(1, len(step_ms) - 1) if on_card else None
    print(f"train: {steps} steps of (1, {seq}) from step 1: losses {[round(x, 5) for x in losses]}; every leaf's "
          f"gradient finite and nonzero ({n_leaves} leaves), every leaf moved; K10 launched "
          f"{launches['ssm_scan_bwd']} times ({layers} per step), K9 {launches['ssm_scan']} ({2 * layers} per step: "
          f"the forward and its recompute under the per-layer remat); {seconds:.2f} s in all"
          + (f"; step ms (CUDA events) {[round(x, 3) for x in step_ms]}, {ms:.3f} ms per step after the first, "
             f"{seq / ms * 1e3:.0f} tokens/s; peak memory {peak_gb:.2f} GB" if on_card else
             "; times and peak memory not measured (CPU)"))

    # K10 on layer 0's own operands
    (dt0, x0, b0, c0, a0, hstart0), dy0, dh0 = layer0
    args0 = (dt0, x0, b0, c0, a0, hstart0)
    check(tuple(x0.shape) == (1, seq, cfg.d_inner) and hstart0.shape[1] == -(-seq // chunk),
          f"layer 0's K10 operands {tuple(x0.shape)}, checkpoints {tuple(hstart0.shape)}")
    bwd_compare(args0, dy0, dh0, f"layer 0 of the train step {tuple(x0.shape)}")
    print(f"train: K10 on layer 0's own operands against its plain version: max abs err {max_err:.3g} over all "
          f"{cases} calls, largest {max_rel:.3g} of max")
    res = {"launches": launches["ssm_scan_bwd"], "max_abs_err": max_err, "ms": None, "plain_ms": None,
           "bound_ms": None, "bound_by": None, "library_ms": None, "step_ms": ms, "peak_gb": peak_gb}
    if on_card:
        sizes = tuple(t.element_size() for t in (dt0, x0, dy0, b0, a0))
        bound = bwd_bound(1, seq, cfg.d_inner, cfg.ssm_state, sizes,
                          ks.bwd_work_floats(1, seq, cfg.d_inner, cfg.ssm_state))
        res.update(ms=time_ms(lambda: ks.ssm_scan_bwd(*args0, dy0, dh0, chunk=chunk)),
                   plain_ms=time_ms(lambda: ks.ssm_scan_bwd_ref(*args0, dy0, dh0, chunk=chunk), iters=1),
                   bound_ms=bound["ms"], bound_by=bound["by"])
        print(f"  K10 {tuple(x0.shape)} st {cfg.ssm_state} (dt {dt0.dtype}, x {x0.dtype}, dy {dy0.dtype}): "
              f"kernel_ms {res['ms']:.5f}  plain_ms {res['plain_ms']:.3f}  bound_ms {bound['ms']:.6f} "
              f"({bound['by']}; bytes {bound['bytes_ms']:.6f}, float32 ops {bound['ops_ms']:.6f}; the function's "
              f"{bound['bytes'] / 1e6:.1f} MB, and the design's partials of dB, dC and dA another "
              f"{bound['partial_bytes'] / 1e6:.1f} MB written and read, not in the bound; one exponential per state "
              f"and step on the SFUs {bound['exp_unit_ms']:.6f}); kernel {res['ms'] / bound['ms']:.3f}x the byte "
              f"bound, {res['ms'] / bound['exp_unit_ms']:.3f}x the exponentials' floor; K10 in all "
              f"{res['ms'] * layers:.2f} ms of a {ms:.1f} ms step (CUDA events)")
        from repro_torch.launch.profile import profile_train_step, report_train

        del layer0, args0, dt0, x0, b0, c0, a0, hstart0, dy0, dh0
        prof = profile_train_step(cfg, tcfg, state, {k: v for k, v in batches[0].items()})
        report_train(prof)
        res.update(k10_share=prof["k10_share"], busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"])
    del state, batches
    if on_card:
        torch.cuda.empty_cache()

    # 5. the reduced config on this device against the CPU: one train step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rcfg = dataclasses.replace(base.reduced(), ssm_backend="fused")
    cpu = init_train_state(rcfg, tcfg, seed=0, device="cpu")
    cpu["step"].fill_(1)
    dev = _copy(cpu, device)
    rbatch = SyntheticLMPipeline(rcfg, 2, 36, PipelineConfig(seed=0)).batch_at(0)
    cpu, mc = make_train_step(rcfg, tcfg)(cpu, rbatch)
    dev, md = make_train_step(rcfg, tcfg)(dev, rbatch)
    check(abs(float(md["loss"]) - float(mc["loss"])) <= TRAIN_REF_TOL * abs(float(mc["loss"])),
          f"reduced train step loss {float(md['loss'])} against {float(mc['loss'])}")
    for (name, _, _), g, c in zip(leaf_report(cpu["params"]), _leaves(dev["params"]), _leaves(cpu["params"])):
        check(torch.allclose(g.cpu(), c, atol=TRAIN_REF_TOL, rtol=TRAIN_REF_TOL), f"reduced train step {name} differs: "
              f"{float((g.cpu() - c).abs().max())}")
    print(f"train reference: reduced falcon-mamba (fused scan) on {device} matches the CPU within "
          f"{TRAIN_REF_TOL:g}: one train step's loss and new parameters")
    return res


ATTN_ARCH, DENSE_ARCH, SERVE_ARCH = "hymba-1.5b", "tinyllama-1.1b", "gemma3-12b"
ATTN_PROMPT, ATTN_NEW, ATTN_TRAIN_SEQ, ATTN_STEPS = 16384, 16, 4096, 3  # hymba: past FULL_ATTENTION_THRESHOLD
DENSE_PROMPT = 4096  # tinyllama: the dense _sdpa path


def modal_inputs(cfg, batch: int, gen, device: str) -> dict:
    """A VLM's ``prefix_emb (batch, P, d)`` or an audio model's ``frames
    (batch, S_enc, d)``: normal draws from ``gen`` in the model's dtype, as
    the reference's input specs give them; ``{}`` for the other families."""
    import torch

    from repro_torch.models.transformer import _dtype

    if cfg.num_prefix_tokens:
        name, n = "prefix_emb", cfg.num_prefix_tokens
    elif cfg.is_encoder_decoder:
        name, n = "frames", cfg.encoder_seq
    else:
        return {}
    return {name: torch.randn((batch, n, cfg.d_model), generator=gen, device=device).to(_dtype(cfg))}


def reduced_against_cpu(device: str, arch: str, prompt: int = 37) -> None:
    """The reduced config (float32, fused scan) on ``device`` against the same
    weights on the CPU: prefill logits and every cache (an audio model's
    ``enc_kv`` too), then 4 decode steps with greedy tokens identical (TF32
    off, as :func:`phase_reference`).  A VLM's prefix or an audio model's
    frames (:func:`modal_inputs`) go with the prompt.  Float32 sums run in
    another order on the card, and K9's exp is ex2.approx: 1e-4 covers
    both."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import forward_decode, forward_prefill, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), ssm_backend="fused")
    cpu = init_params(cfg, seed=0, device="cpu")
    dev = _to(cpu, device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, prompt)))
    extra = modal_inputs(cfg, 2, torch.Generator().manual_seed(0), "cpu")
    start = cfg.num_prefix_tokens + prompt  # a VLM's positions count its prefix
    cache_len = start + 4
    lc, cc, ec = forward_prefill(cfg, cpu, {"tokens": tokens, **extra}, cache_len)
    lg, cg, eg = forward_prefill(cfg, dev, {"tokens": tokens.to(device), **_to(extra, device)}, cache_len)
    check(torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4), f"reduced {arch} prefill logits differ: "
          f"{float((lg.cpu() - lc).abs().max())}")
    for sub, names in cc.items():
        for name, t in names.items():
            check(torch.allclose(cg[sub][name].cpu(), t, atol=1e-4, rtol=1e-4), f"reduced {arch} prefill {sub}/{name} differs")
    for name, g, c in zip(("ek", "ev"), eg or (), ec or ()):
        check(torch.allclose(g.cpu(), c, atol=1e-4, rtol=1e-4), f"reduced {arch} enc_kv {name} differs")
    tok = lc.argmax(-1, keepdim=True)
    for t in range(4):
        pos = torch.full((2,), start + t)
        lc, _ = forward_decode(cfg, cpu, cc, tok, pos, enc_kv=ec)
        lg, _ = forward_decode(cfg, dev, cg, tok.to(device), pos.to(device), enc_kv=eg)
        check(torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4), f"reduced {arch} decode logits differ at step {t}: "
              f"{float((lg.cpu() - lc).abs().max())}")
        check(torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)), f"reduced {arch} greedy tokens differ at step {t}")
        tok = lc.argmax(-1, keepdim=True)
    print(f"reference: reduced {arch} ({cfg.num_layers} layers, window {cfg.sliding_window}, prompt {prompt}"
          + (f" after a prefix of {cfg.num_prefix_tokens}" if cfg.num_prefix_tokens else "")
          + (f" over {cfg.encoder_seq} frames" if cfg.is_encoder_decoder else "")
          + f", fused scan) on {device} matches the CPU within 1e-4: prefill logits and every cache"
          + (", enc_kv" if ec is not None else "") + ", then 4 decode steps; greedy tokens identical")


def _prefill_against_stepping(cfg, params, prefill, decode, tokens, device: str, extra=None, enc_kv=None) -> str:
    """Layer 0's caches after one prefill of ``tokens (1, n)`` against n
    decode steps from zero caches, within ``STEP_RTOL`` of max (phase 7's
    tolerance); a bfloat16 cache also within one bfloat16 ulp of its
    largest element.  The prefill projects n tokens at once and a decode
    step one, which the card runs as different matrix kernels whose sums
    run in another order, so a bfloat16 projection may round the other
    way (one ulp of the element), and the rotary embedding carries that
    into the element's pair (norm-preserving: within one ulp of the
    largest).  ``extra`` goes with both prefills: a VLM's prefix (the
    steps then start from a prefill of the prefix alone, and the text
    positions P ... P + n - 1 are compared) or an audio model's frames
    (the steps read ``enc_kv``).  Returns a line that reports it."""
    import torch

    from repro_torch.models import init_caches

    extra = extra or {}
    n = tokens.shape[1]
    p = extra["prefix_emb"].shape[1] if "prefix_emb" in extra else 0
    _, pre = prefill(params, {"tokens": tokens, **extra}, p + n)
    if p:
        _, stepped = prefill(params, {"tokens": tokens[:, :0], **extra}, p + n)
    else:
        stepped = init_caches(cfg, 1, n, device=device)
    for t in range(n):
        decode(params, stepped, tokens[:, t:t + 1], torch.full((1,), p + t, device=device),
               *([] if enc_kv is None else [enc_kv]))
    parts = []
    for name in pre["sub0"]:
        got, want = pre["sub0"][name][0][:, p:], stepped["sub0"][name][0][:, p:]
        top = float(want.float().abs().max())
        ulp = math.ldexp(1.0, math.frexp(top)[1] - 8) if want.dtype == torch.bfloat16 and top > 0 else 0.0
        err = scan_err(got, want, f"{cfg.name} prefill against stepping, layer 0 {name}", STEP_RTOL, ulp)
        parts.append(f"{name} {err:.3g} ({err / max(float(want.float().abs().max()), 1e-30):.3g} of max)")
    return (f"layer 0 after a prefill of {n} tokens" + (f" after a prefix of {p}" if p else "")
            + f" against {n} decode steps: max abs err " + ", ".join(parts))


def phase_attention(device: str = "cuda", reduce: bool = False, prompt: int = ATTN_PROMPT, new_tokens: int = ATTN_NEW,
                    step_prompt: int = 64, train_seq: int = ATTN_TRAIN_SEQ, steps: int = ATTN_STEPS,
                    dense_prompt: int = DENSE_PROMPT, serve_prompt: int = 6, serve_new: int = 4, seed: int = 7) -> dict:
    """Attention prefill and training: hymba-1.5b, tinyllama-1.1b and gemma3-12b.

    1. hymba-1.5b at full width (random weights from seed 0, fused scan),
       driven once with every count at 0: ``make_prefill_step`` of a ``(1,
       prompt)`` prompt with ``cache_len = prompt + new_tokens`` (past
       ``FULL_ATTENTION_THRESHOLD`` every layer runs the blockwise
       attention, and the window layers' rings wrap; K9 once per layer),
       then ``new_tokens`` tokens sampled with top-k 40 through
       ``make_decode_step`` (K4's wide rounds and S1 once per token).  K9
       on layer 0's own inputs against its plain version, with its times;
       the prefill traced by kind (``launch/profile.py``); layer 0's k, v,
       conv and ssm caches after a prefill of ``step_prompt`` tokens against
       as many decode steps.
    2. hymba trained ``steps`` steps of ``(1, train_seq)`` at all its layers
       with ``remat_policy="full"`` (K9 twice per layer and step, K10
       once), then ``steps`` more with ``"dots"``, whose counts are printed:
       finite losses, every parameter moved; K10 on layer 0's own operands
       against its plain version, with its times.
    3. tinyllama-1.1b at full width: one ``forward_prefill`` of ``(1,
       dense_prompt)`` (the dense ``_sdpa`` path), layer 0's k and v against
       stepping, ``steps`` train steps of ``(1, dense_prompt)``.
    4. Reduced hymba and tinyllama (float32) on this device against the CPU.
    5. gemma3-12b at full width: ``ServingEngine`` at batch 1 serves 2
       requests of ``serve_prompt`` tokens and ``serve_new`` new ones; K4
       runs its 9 wide rounds per sampled token (vocab 262144), S1 once.
    With ``device="cpu"`` and ``reduce=True`` (the tests, at a small size)
    the configs are the reduced ones, the wrappers run their plain
    versions, nothing is launched, timed or traced, and every check still
    runs.  Returns K9's and K10's numbers at hymba's shapes.
    """
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLMPipeline
    from repro_torch.kernels import WRAPPERS, reset_launches
    from repro_torch.kernels import ssm_scan as ks
    from repro_torch.kernels.tune import pick
    from repro_torch.models import forward_prefill, init_params
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.attention import FULL_ATTENTION_THRESHOLD
    from repro_torch.models.transformer import _dtype, _group_windows
    from repro_torch.serving import Request, ServingEngine, topk_sample
    from repro_torch.train import init_train_state, make_decode_step, make_prefill_step, make_train_step
    from repro_torch.train.steps import _cast

    on_card = device == "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def config(arch):
        base = get_config(arch)
        return dataclasses.replace(base.reduced() if reduce else base, ssm_backend="fused")

    def counts():
        return {fn.__name__: fn.launches for fn in WRAPPERS}

    def want(**kw):
        out = dict.fromkeys((fn.__name__ for fn in WRAPPERS), 0)
        if on_card:
            out.update(kw)
        return out

    def peak_gb():
        return f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB" if on_card else "not measured"

    def free():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    # 1. hymba serving: prefill past the threshold, then sampled tokens
    cfg = config(ATTN_ARCH)
    t0 = time.perf_counter()
    params = _cast(init_params(cfg, seed=0, device=device), _dtype(cfg))  # once, as the engine does
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    windows = _group_windows(cfg)
    print(f"attention: {cfg.name} ({cfg.num_layers} layers in groups of {cfg.layer_group}, windows {windows}, "
          f"d={cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} kv, d_inner={cfg.d_inner}, state "
          f"{cfg.ssm_state}, vocab {cfg.vocab_size}, {cfg.dtype}, fused scan), {n_bytes / 1e9:.3f} GB of weights "
          f"from seed 0 in {time.perf_counter() - t0:.2f} s")
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    tokens = torch.randint(1, cfg.vocab_size, (1, prompt), generator=gen, device=device)
    cache_len = prompt + new_tokens
    sgen = torch.Generator(device=device)
    sgen.manual_seed(seed)
    layer0 = []
    real_scan = ssm_mod.ssm_scan

    def keep_layer0(*args, **kw):  # the model's own K9 inputs of layer 0
        if not layer0:
            layer0.append((args, kw))
        return real_scan(*args, **kw)

    ssm_mod.ssm_scan = keep_layer0
    try:
        free()
        reset_launches()
        sync()
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": tokens}, cache_len)
        sync()
        prefill_s = time.perf_counter() - t0
        prefill_k9 = ks.ssm_scan.launches
        state0 = caches["sub0"]["ssm"][0].clone()
        sampled = [topk_sample(logits, sgen, k=40, temperature=0.8, backend="kernel")]
        sync()
        t0 = time.perf_counter()
        for i in range(new_tokens - 1):
            pos = torch.full((1,), prompt + i, device=device)
            logits, caches = decode(params, caches, sampled[-1][:, None], pos)
            sampled.append(topk_sample(logits, sgen, k=40, temperature=0.8, backend="kernel"))
        sync()
        decode_s = time.perf_counter() - t0
        launches = counts()
    finally:
        ssm_mod.ssm_scan = real_scan
    k4_rounds = wide_rounds(cfg.vocab_size, pick(cfg.vocab_size)[0])
    check(prefill_k9 == (cfg.num_layers if on_card else 0), f"hymba prefill launched K9 {prefill_k9} times")
    expect = want(ssm_scan=cfg.num_layers, sort_round_kv=new_tokens * k4_rounds, sort_tiles_kv=new_tokens)
    check(launches == expect, f"hymba serving path launched {launches}, want {expect}")
    ids = torch.cat(sampled)
    check(ids.shape == (new_tokens,) and bool(((ids >= 0) & (ids < cfg.vocab_size)).all()), f"sampled ids {ids.tolist()}")
    check(bool(torch.isfinite(logits.float()).all()), "hymba decode logits not finite")
    for i, w in enumerate(windows):
        sub = caches[f"sub{i}"]
        check(sub["k"].shape[2] == (min(w, cache_len) if w else cache_len), f"sub{i} k cache {tuple(sub['k'].shape)}")
        for name, t in sub.items():
            check(bool(torch.isfinite(t.float()).all()), f"hymba cache sub{i}/{name} not finite")
    blockwise = prompt > FULL_ATTENTION_THRESHOLD
    print(f"attention: hymba prefill (1, {prompt}), cache_len {cache_len} ({'blockwise' if blockwise else 'dense'} "
          f"attention, chunk {cfg.attn_chunk}; window layers wrap a ring of {min(w for w in windows if w)}) in "
          f"{prefill_s * 1e3:.1f} ms, K9 launched {prefill_k9} times; {new_tokens} tokens sampled (top-k 40), "
          f"{new_tokens - 1} decode steps in {decode_s * 1e3:.1f} ms ({decode_s * 1e3 / max(1, new_tokens - 1):.2f} ms "
          f"per step with its sample); K4 launched {launches['sort_round_kv']} times ({k4_rounds} wide rounds per "
          f"token), S1 {launches['sort_tiles_kv']}; peak memory {peak_gb()}; ids {ids.tolist()}")

    # K9 on layer 0's own inputs, at hymba's width
    args0, kw0 = layer0[0]
    got = ks.ssm_scan(*args0, **kw0)
    ref = ks.ssm_scan_ref(*args0, **kw0)
    k9_err = max(scan_err(g, w, f"K9 on hymba's layer 0 {part}") for part, g, w in zip(("y", "h_final"), got, ref))
    check(torch.equal(got[1], state0), "hymba's layer 0 cached state is not K9's h_final on the same inputs")
    k9 = {"launches": prefill_k9, "max_abs_err": k9_err, "ms": None, "plain_ms": None, "bound_ms": None,
          "bound_by": None, "sfu_ms": None, "shape": tuple(args0[1].shape) + (args0[2].shape[2],)}
    del got, ref
    if on_card:
        bsz, s = args0[1].shape[:2]
        sizes = tuple(t.element_size() for t in (args0[0], args0[1], args0[2], args0[4]))
        bound = scan_bound(bsz, s, args0[1].shape[2], args0[2].shape[2], sizes)
        k9.update(ms=time_ms(lambda: ks.ssm_scan(*args0, **kw0)),
                  plain_ms=time_ms(lambda: ks.ssm_scan_ref(*args0, **kw0), iters=1),
                  bound_ms=bound["ms"], bound_by=bound["by"], sfu_ms=bound["exp_unit_ms"])
        print(f"  K9 {k9['shape']} (dt {args0[0].dtype}, x {args0[1].dtype}): kernel_ms {k9['ms']:.5f}  plain_ms "
              f"{k9['plain_ms']:.3f}  bound_ms {bound['ms']:.6f} ({bound['by']}; bytes {bound['bytes_ms']:.6f}, float32 "
              f"ops {bound['ops_ms']:.6f}), SFU floor {bound['exp_unit_ms']:.6f}; kernel {k9['ms'] / bound['ms']:.3f}x "
              f"the bound, {k9['ms'] / bound['exp_unit_ms']:.3f}x the SFU floor; K9 in all {k9['ms'] * prefill_k9:.2f} ms "
              f"of the {prefill_s * 1e3:.1f} ms prefill (CUDA events)")
        from repro_torch.launch.profile import profile_prefill, report_prefill

        report_prefill(f"hymba prefill (1, {prompt}) traced",
                       profile_prefill(prefill, params, {"tokens": tokens}, cache_len))
    print(f"attention: K9 on hymba's layer 0 inputs {k9['shape']} against its plain version: max abs err {k9_err:.3g}")
    del layer0, args0, kw0, caches, logits
    print("attention: hymba " + _prefill_against_stepping(cfg, params, prefill, decode, tokens[:, :step_prompt], device))
    del params
    free()

    # 2. hymba training at all its layers, both remat policies
    tcfg = TrainConfig(z_loss=1e-4, grad_clip=1.0)
    t0 = time.perf_counter()
    state = init_train_state(cfg, tcfg, seed=0, device=device)
    state["step"].fill_(1)
    sync()
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    print(f"attention: training {cfg.name} at all {cfg.num_layers} layers: {n_params / 1e9:.3f} B parameters, "
          f"{sum(t.numel() * t.element_size() for t in _leaves(state)) / 1e9:.2f} GB of float32 masters and moments "
          f"in {time.perf_counter() - t0:.2f} s")
    pipe = SyntheticLMPipeline(cfg, 1, train_seq, PipelineConfig(seed=0))
    batches = [{k: torch.as_tensor(v, device=device) for k, v in pipe.batch_at(i).items()} for i in range(1, steps + 1)]
    before = _fingerprints(state["params"])
    layer0 = []
    real_bwd = ks._backward

    def keep_bwd(saved, dy, dh):  # the last K10 of the first backward is layer 0's
        layer0[:] = [tuple(t.detach() for t in saved), dy.contiguous(), dh.float().contiguous()]
        return real_bwd(saved, dy, dh)

    train = {}
    for policy in ("full", "dots"):
        step_fn = make_train_step(dataclasses.replace(cfg, remat_policy=policy), tcfg)
        losses, step_ms = [], []
        ks._backward = keep_bwd if policy == "full" else real_bwd
        try:
            free()
            reset_launches()
            sync()
            for i, batch in enumerate(batches):
                if on_card:
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    ev[0].record()
                state, m = step_fn(state, batch)
                if on_card:
                    ev[1].record()
                    ev[1].synchronize()
                    step_ms.append(ev[0].elapsed_time(ev[1]))
                losses.append(float(m["loss"]))
                check(math.isfinite(losses[-1]) and math.isfinite(float(m["grad_norm"])),
                      f"hymba {policy} step {i + 1}: loss {losses[-1]}, grad norm {float(m['grad_norm'])}")
                ks._backward = real_bwd  # layer 0's operands of the first step are kept
            sync()
            launches = counts()
        finally:
            ks._backward = real_bwd
        if policy == "full":
            expect = want(ssm_scan=2 * cfg.num_layers * steps, ssm_scan_bwd=cfg.num_layers * steps)
            check(launches == expect, f"hymba training ({policy}) launched {launches}, want {expect}")
        ms = sum(step_ms[1:]) / max(1, len(step_ms) - 1) if on_card else None
        train[policy] = {"ms": ms, "launches": launches, "peak": peak_gb()}
        print(f"attention: hymba {steps} train steps of (1, {train_seq}), remat_policy={policy!r}: losses "
              f"{[round(x, 5) for x in losses]}; K9 launched {launches['ssm_scan']} times, K10 "
              f"{launches['ssm_scan_bwd']}, the others {sum(launches.values()) - launches['ssm_scan'] - launches['ssm_scan_bwd']}"
              + (f"; step ms (CUDA events) {[round(x, 3) for x in step_ms]}, {ms:.3f} ms per step after the first, "
                 f"{train_seq / ms * 1e3:.0f} tokens/s; peak memory {peak_gb()}" if on_card else
                 "; times and peak memory not measured (CPU)"))
    after = _fingerprints(state["params"])
    from repro_torch.train.smoke import leaf_report

    still = [name for (name, _, _), a, b in zip(leaf_report(state["params"]), before, after) if torch.equal(a, b)]
    check(not still, f"hymba parameters did not move: {still}")
    del state, batches

    # K10 on layer 0's own operands, at hymba's width
    (dt0, x0, b0, c0, a0, hstart0), dy0, dh0 = layer0
    args0 = (dt0, x0, b0, c0, a0, hstart0)
    chunk = ks.GRAD_CHUNK
    check(tuple(x0.shape) == (1, train_seq, cfg.d_inner), f"hymba's layer 0 K10 operands {tuple(x0.shape)}")
    got = ks.ssm_scan_bwd(*args0, dy0, dh0, chunk=chunk)
    ref = ks.ssm_scan_bwd_ref(*args0, dy0, dh0, chunk=chunk)
    k10_err = max(scan_err(g, w, f"K10 on hymba's layer 0 {part}", BWD_RTOL, 0.0)
                  for part, g, w in zip(("ddt", "dx", "dB", "dC", "dA"), got, ref))
    del got, ref
    k10 = {"launches": train["full"]["launches"]["ssm_scan_bwd"], "max_abs_err": k10_err, "ms": None, "plain_ms": None,
           "bound_ms": None, "bound_by": None, "sfu_ms": None, "shape": tuple(x0.shape) + (cfg.ssm_state,),
           "step_ms": {k: v["ms"] for k, v in train.items()}}
    if on_card:
        sizes = tuple(t.element_size() for t in (dt0, x0, dy0, b0, a0))
        bound = bwd_bound(1, train_seq, cfg.d_inner, cfg.ssm_state, sizes,
                          ks.bwd_work_floats(1, train_seq, cfg.d_inner, cfg.ssm_state))
        k10.update(ms=time_ms(lambda: ks.ssm_scan_bwd(*args0, dy0, dh0, chunk=chunk)),
                   plain_ms=time_ms(lambda: ks.ssm_scan_bwd_ref(*args0, dy0, dh0, chunk=chunk), iters=1),
                   bound_ms=bound["ms"], bound_by=bound["by"], sfu_ms=bound["exp_unit_ms"])
        print(f"  K10 {k10['shape']} (dt {dt0.dtype}, x {x0.dtype}, dy {dy0.dtype}): kernel_ms {k10['ms']:.5f}  "
              f"plain_ms {k10['plain_ms']:.3f}  bound_ms {bound['ms']:.6f} ({bound['by']}; bytes {bound['bytes_ms']:.6f}, "
              f"float32 ops {bound['ops_ms']:.6f}; partials {bound['partial_bytes'] / 1e6:.1f} MB not in the bound), "
              f"SFU floor {bound['exp_unit_ms']:.6f}; kernel {k10['ms'] / bound['ms']:.3f}x the bound, "
              f"{k10['ms'] / bound['exp_unit_ms']:.3f}x the SFU floor; K10 in all {k10['ms'] * cfg.num_layers:.2f} ms of "
              f"a {train['full']['ms']:.1f} ms step (CUDA events)")
    print(f"attention: K10 on hymba's layer 0 operands {k10['shape']} against its plain version: max abs err "
          f"{k10_err:.3g} (tolerance {BWD_RTOL:g} of max per gradient)")
    del layer0, args0, dt0, x0, b0, c0, a0, hstart0, dy0, dh0
    free()

    # 3. tinyllama: dense prefill, prefill against stepping, training
    dcfg = config(DENSE_ARCH)
    params = _cast(init_params(dcfg, seed=0, device=device), _dtype(dcfg))
    dtokens = torch.randint(1, dcfg.vocab_size, (1, dense_prompt), generator=gen, device=device)
    reset_launches()
    sync()
    t0 = time.perf_counter()
    logits, caches, _ = forward_prefill(dcfg, params, {"tokens": dtokens})
    sync()
    dense_s = time.perf_counter() - t0
    check(counts() == want(), f"tinyllama prefill launched {counts()}")
    check(tuple(logits.shape) == (1, dcfg.vocab_size) and bool(torch.isfinite(logits.float()).all()),
          "tinyllama prefill logits not finite")
    check(caches["sub0"]["k"].shape[2] == dense_prompt, f"tinyllama k cache {tuple(caches['sub0']['k'].shape)}")
    dense_ms = time_ms(lambda: forward_prefill(dcfg, params, {"tokens": dtokens}), iters=3) if on_card else None
    print(f"attention: {dcfg.name} ({dcfg.num_layers} layers, d={dcfg.d_model}, {dcfg.dtype}) forward_prefill (1, "
          f"{dense_prompt}) on the dense path ({dense_prompt} <= {FULL_ATTENTION_THRESHOLD} keys) in "
          f"{dense_s * 1e3:.1f} ms (first call), "
          + (f"{dense_ms:.3f} ms (CUDA events, 3 calls)" if on_card else "not timed (CPU)") + "; no kernel launched")
    del logits, caches
    dprefill, ddecode = make_prefill_step(dcfg), make_decode_step(dcfg)
    print(f"attention: {dcfg.name} " + _prefill_against_stepping(dcfg, params, dprefill, ddecode,
                                                                    dtokens[:, :step_prompt], device))
    del params
    free()
    state = init_train_state(dcfg, tcfg, seed=0, device=device)
    state["step"].fill_(1)
    dpipe = SyntheticLMPipeline(dcfg, 1, dense_prompt, PipelineConfig(seed=0))
    step_fn = make_train_step(dcfg, tcfg)
    losses, step_ms = [], []
    reset_launches()
    for i in range(1, steps + 1):
        batch = {k: torch.as_tensor(v, device=device) for k, v in dpipe.batch_at(i).items()}
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        state, m = step_fn(state, batch)
        if on_card:
            ev[1].record()
            ev[1].synchronize()
            step_ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(m["loss"]))
        check(math.isfinite(losses[-1]), f"tinyllama step {i}: loss {losses[-1]}")
    check(counts() == want(), f"tinyllama training launched {counts()}")
    dense_step = sum(step_ms[1:]) / max(1, len(step_ms) - 1) if on_card else None
    print(f"attention: {dcfg.name} {steps} train steps of (1, {dense_prompt}): losses {[round(x, 5) for x in losses]}"
          + (f"; step ms (CUDA events) {[round(x, 3) for x in step_ms]}, {dense_step:.3f} ms per step after the "
             f"first, {dense_prompt / dense_step * 1e3:.0f} tokens/s; peak memory {peak_gb()}" if on_card else
             "; times and peak memory not measured (CPU)"))
    del state
    free()

    # 4. the reduced configs on this device against the CPU
    for arch in (ATTN_ARCH, DENSE_ARCH):
        reduced_against_cpu(device, arch)

    # 5. gemma3-12b serving: 9 wide rounds of K4 per sampled token
    gcfg = config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = init_params(gcfg, seed=0, device=device)
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"attention: {gcfg.name} ({gcfg.num_layers} layers in groups of {gcfg.layer_group}, d={gcfg.d_model}, "
          f"vocab {gcfg.vocab_size}, {gcfg.dtype}), {gcfg.n_params() / 1e9:.2f} B parameters, {n_bytes / 1e9:.3f} GB "
          f"of weights from seed 0 in {time.perf_counter() - t0:.2f} s")
    engine = ServingEngine(gcfg, params, batch=1, max_seq=serve_prompt + serve_new + 2, seed=0, device=device)
    del params
    rng = np.random.default_rng(seed)
    for uid in range(2):
        engine.submit(Request(uid=uid, prompt=rng.integers(1, gcfg.vocab_size, size=serve_prompt).astype(np.int32),
                              max_new_tokens=serve_new, temperature=0.8, topk=40))
    reset_launches()
    sync()
    t0 = time.perf_counter()
    report = engine.run_until_done()
    sync()
    seconds = time.perf_counter() - t0
    launches = counts()
    ids = [t for r in engine.done.values() for t in r.generated]
    g_rounds = wide_rounds(gcfg.vocab_size, pick(gcfg.vocab_size)[0])
    check(report.ok() and report.completed == 2 and len(ids) == 2 * serve_new, f"gemma3 serving: {report.statuses}")
    check(all(0 <= t < gcfg.vocab_size for t in ids), f"gemma3 token out of range: {ids}")
    expect = want(sort_round_kv=g_rounds * len(ids), sort_tiles_kv=len(ids))
    check(launches == expect, f"gemma3 serving launched {launches}, want {expect}")
    print(f"attention: {gcfg.name} served 2 requests of {serve_prompt} prompt tokens at batch 1, {len(ids)} sampled "
          f"tokens in {seconds:.3f} s ({seconds * 1e3 / len(ids):.2f} ms/token, prefill by stepping included); K4 "
          f"launched {launches['sort_round_kv']} times ({g_rounds} wide rounds per token: vocab {gcfg.vocab_size}), "
          f"S1 {launches['sort_tiles_kv']}; ids {ids}")
    del engine
    free()
    return {"k9": k9, "k10": k10, "prefill_s": prefill_s, "dense_step_ms": dense_step,
            "gemma_k4": launches["sort_round_kv"]}


MOE_ARCH, PHI_ARCH = "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"
MOE_PROMPT, MOE_NEW, MOE_STEP_PROMPT = 4096, 16, 32
MOE_TRAIN_LAYERS, MOE_STEPS = 4, 3  # moonshot trained at 4 of 48 layers: about 10.6 GB of state a layer
PHI_LAYERS, PHI_NEW = 8, 8  # phi3.5-moe at 8 of 32 layers: 10.5 B parameters, 21 GB in bfloat16


def _margin(probs, k: int) -> float:
    """The least top-k margin of router probabilities ``(..., E)``: the k-th
    largest less the next one, over the tokens (inf when k = E)."""
    import torch

    if k >= probs.shape[-1]:
        return math.inf
    srt = torch.sort(probs.float(), dim=-1, descending=True).values
    return float((srt[..., k - 1] - srt[..., k]).min())


def _routing(p, x, k: int):
    """A MoE layer's routing of ``x (B, S, d)``: its flat expert ids ``(B, S *
    k)`` int32 and its least top-k margin."""
    import torch

    from repro_torch.models import moe as moe_mod

    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    _, top_e = moe_mod._router_topk(probs, k)
    return top_e.reshape(x.shape[0], -1).to(torch.int32), _margin(probs, k)


def moe_against_cpu(device: str, arch: str, prompt: int = 37) -> None:
    """The reduced MoE config (float32, ``"merge_path_pallas"``) on ``device``
    against the same weights on the CPU: every layer's routed experts
    identical (a flip fails with its top-k margin), prefill logits and caches
    within 1e-4, then 4 decode steps with greedy tokens identical (TF32 off,
    as :func:`reduced_against_cpu`)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import forward_decode, forward_prefill, init_params
    from repro_torch.models import moe as moe_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), moe_dispatch="merge_path_pallas")
    k = cfg.experts_per_token
    cpu = init_params(cfg, seed=0, device="cpu")
    dev = _to(cpu, device)
    routed = []
    margins = []
    real = moe_mod._router_topk

    def keep(probs, kk):
        out = real(probs, kk)
        routed.append((probs.detach().cpu(), out[1].cpu()))
        return out

    def both(run_cpu, run_dev, what):
        routed.clear()
        out_cpu = run_cpu()
        on_cpu = list(routed)
        routed.clear()
        out_dev = run_dev()
        check(len(on_cpu) == len(routed) == cfg.num_layers, f"reduced {arch} {what}: {len(on_cpu)} and {len(routed)} routings")
        for layer, ((probs, ec), (_, ed)) in enumerate(zip(on_cpu, routed)):
            margins.append(_margin(probs, k))
            if not torch.equal(ec, ed):
                at = tuple((ec != ed).any(-1).nonzero()[0].tolist())
                check(False, f"reduced {arch} {what}: layer {layer} routes token {at} to experts {ed[at].tolist()} on "
                             f"{device} and {ec[at].tolist()} on the CPU; top-k margin there {_margin(probs[at], k):.3g}")
        return out_cpu, out_dev

    moe_mod._router_topk = keep
    try:
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, prompt)))
        cache_len = prompt + 4
        (lc, cc, _), (lg, cg, _) = both(lambda: forward_prefill(cfg, cpu, {"tokens": tokens}, cache_len),
                                        lambda: forward_prefill(cfg, dev, {"tokens": tokens.to(device)}, cache_len),
                                        "prefill")
        check(torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4), f"reduced {arch} prefill logits differ: "
              f"{float((lg.cpu() - lc).abs().max())}")
        for sub, names in cc.items():
            for name, t in names.items():
                check(torch.allclose(cg[sub][name].cpu(), t, atol=1e-4, rtol=1e-4), f"reduced {arch} {sub}/{name} differs")
        tok = lc.argmax(-1, keepdim=True)
        for t in range(4):
            pos = torch.full((2,), prompt + t)
            (lc, _), (lg, _) = both(lambda: forward_decode(cfg, cpu, cc, tok, pos),
                                    lambda: forward_decode(cfg, dev, cg, tok.to(device), pos.to(device)), f"decode {t}")
            check(torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4), f"reduced {arch} decode logits differ at step "
                  f"{t}: {float((lg.cpu() - lc).abs().max())}")
            check(torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)), f"reduced {arch} greedy tokens differ at step {t}")
            tok = lc.argmax(-1, keepdim=True)
    finally:
        moe_mod._router_topk = real
    print(f"reference: reduced {arch} ({cfg.num_layers} layers, {cfg.num_experts} experts top-{k}, prompt {prompt}, "
          f"merge_path_pallas) on {device} matches the CPU: every layer's routed experts identical in the prefill and "
          f"4 decode steps (least top-k margin {min(margins):.3g}), logits and caches within 1e-4, greedy tokens "
          "identical")


def phase_moe(device: str = "cuda", reduce: bool = False, card: str = "cpu", prompt: int = MOE_PROMPT,
              new_tokens: int = MOE_NEW, step_prompt: int = MOE_STEP_PROMPT, train_layers: int = MOE_TRAIN_LAYERS,
              train_seq: int = MOE_PROMPT, steps: int = MOE_STEPS, grad_seq: int = MOE_PROMPT,
              phi_layers: int = PHI_LAYERS, phi_prompt: int = MOE_PROMPT, phi_new: int = PHI_NEW,
              seed: int = 11) -> dict:
    """The MoE family on the merge-path dispatch: moonshot-v1-16b-a3b and phi3.5-moe-42b-a6.6b.

    1. moonshot-v1-16b-a3b at full width and all 48 layers (random weights
       from seed 0, ``moe_dispatch="merge_path_pallas"``), driven once with
       every count at 0: ``make_prefill_step`` of a ``(1, prompt)`` prompt
       (each layer's routing sort of ``prompt * 6`` slots: one S1 launch
       and K4's wide rounds), then ``new_tokens`` tokens sampled with top-k
       40 through ``make_decode_step`` (each decode step one S1 launch a
       layer at chunk 8; each sample one S1 and K4's rounds over the
       vocab).  The launch counts are read exactly.
    2. Layer 0's own routing keys, of the prefill and of the first decode
       step: S1 and every K4 round bit for bit against their plain
       versions, ``ops.sort_kv_batched`` against
       ``core.merge_sort_kv_batched``, and the positions of the three
       dispatch modes (and of the ragged dispatch) equal; the dropped
       slots and the top-k margin printed.  On the card: CUDA-event times
       of the dispatch, S1, K4's rounds, their plain versions and a stable
       ``torch.sort`` of the same keys, and of layer 0's ``moe_apply``; two
       prefills bit-identical; the prefill traced by kind; layer 0's k and
       v caches after a prefill of ``step_prompt`` tokens against as many
       decode steps (upstream of any routing).
    3. moonshot at full width cut to ``train_layers`` layers, ``steps``
       train steps of ``(1, train_seq)`` under ``remat_policy="full"``
       (the routing sort twice per layer and step: the forward and its
       recompute).
    4. ``moe_apply``'s loss and gradients on one full-width moonshot layer
       at ``(1, grad_seq)``, ``"merge_path_pallas"`` against
       ``"merge_path"``: bit-identical, every gradient nonzero.
    5. phi3.5-moe-42b-a6.6b at full width cut to ``phi_layers`` layers:
       prefill ``(1, phi_prompt)`` and ``phi_new`` sampled tokens, counts read.
    6. The reduced moonshot and phi3.5-moe on this device against the CPU
       (:func:`moe_against_cpu`).
    With ``device="cpu"`` and ``reduce=True`` (the tests, at a small size)
    the configs are the reduced ones, the wrappers run their plain versions,
    nothing is launched, timed or traced, and every check still runs.
    Returns the ``"moe"`` objects of S1 and K4 for the ``kernels`` line.
    """
    import dataclasses

    import torch

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import merge_sort_kv_batched
    from repro_torch.core.batched import _pad_rows_pow2
    from repro_torch.core.merge_path import max_sentinel
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLMPipeline
    from repro_torch.kernels import WRAPPERS, ops, reset_launches
    from repro_torch.kernels import merge_path as km
    from repro_torch.kernels.ops import _narrow_chunk, _sort_tile
    from repro_torch.models import init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import _dtype
    from repro_torch.serving import topk_sample
    from repro_torch.train import init_train_state, make_decode_step, make_prefill_step, make_train_step
    from repro_torch.train.smoke import leaf_report
    from repro_torch.train.steps import _cast

    on_card = device == "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def config(arch, **kw):
        base = get_config(arch)
        return dataclasses.replace(base.reduced() if reduce else base, moe_dispatch="merge_path_pallas", **kw)

    def counts():
        return {fn.__name__: fn.launches for fn in WRAPPERS}

    def want(**kw):
        out = dict.fromkeys((fn.__name__ for fn in WRAPPERS), 0)
        if on_card:
            out.update(kw)
        return out

    def sort_launches(n: int):
        """(S1, K4) launches of one routing sort of rows of n slots."""
        return (1 if n > 1 else 0), wide_rounds(n, _sort_tile(n, None, None)[0])

    def peak_gb():
        return f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB" if on_card else "not measured"

    def free():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    # 1. moonshot serving at all 48 layers: prefill, then sampled tokens
    cfg = config(MOE_ARCH)
    nl, ne, k = cfg.num_layers, cfg.num_experts, cfg.experts_per_token
    t0 = time.perf_counter()
    params = _cast(init_params(cfg, seed=0, device=device), _dtype(cfg))  # once, as the engine does
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"moe: {cfg.name} ({nl} layers, d={cfg.d_model}, {cfg.num_heads} heads, {ne} experts top-{k} of d_ff "
          f"{cfg.d_ff} and a shared expert of {cfg.shared_expert_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"{cfg.moe_dispatch}), {cfg.n_params() / 1e9:.2f} B parameters, {n_bytes / 1e9:.3f} GB of weights from seed "
          f"0 in {time.perf_counter() - t0:.2f} s ({card})")
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    tokens = torch.randint(1, cfg.vocab_size, (1, prompt), generator=gen, device=device)
    cache_len = prompt + new_tokens
    sgen = torch.Generator(device=device)
    sgen.manual_seed(seed)
    layer0 = []  # layer 0's moe_apply operands: the prefill's, then the first decode step's
    calls = [0]
    real_apply = moe_mod.moe_apply

    def keep_layer0(p, x, c, *args, **kw):
        if calls[0] in (0, nl):
            layer0.append((p, x.detach().clone()))
        calls[0] += 1
        return real_apply(p, x, c, *args, **kw)

    moe_mod.moe_apply = keep_layer0
    try:
        free()
        reset_launches()
        sync()
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": tokens}, cache_len)
        sync()
        prefill_s = time.perf_counter() - t0
        prefill_launches = counts()
        first_logits = logits.clone()
        sampled = [topk_sample(logits, sgen, k=40, temperature=0.8, backend="kernel")]
        sync()
        t0 = time.perf_counter()
        for i in range(new_tokens - 1):
            pos = torch.full((1,), prompt + i, device=device)
            logits, caches = decode(params, caches, sampled[-1][:, None], pos)
            sampled.append(topk_sample(logits, sgen, k=40, temperature=0.8, backend="kernel"))
        sync()
        decode_s = time.perf_counter() - t0
        launches = counts()
    finally:
        moe_mod.moe_apply = real_apply
    s1_pre, k4_pre = sort_launches(prompt * k)
    s1_dec, k4_dec = sort_launches(k)
    v_rounds = wide_rounds(cfg.vocab_size, _sort_tile(cfg.vocab_size, None, None)[0])
    expect = want(sort_tiles_kv=nl * s1_pre, sort_round_kv=nl * k4_pre)
    check(prefill_launches == expect, f"moonshot prefill launched {prefill_launches}, want {expect}")
    expect = want(sort_tiles_kv=nl * s1_pre + (new_tokens - 1) * nl * s1_dec + new_tokens,
                  sort_round_kv=nl * k4_pre + (new_tokens - 1) * nl * k4_dec + new_tokens * v_rounds)
    check(launches == expect, f"moonshot serving path launched {launches}, want {expect}")
    ids = torch.cat(sampled)
    check(ids.shape == (new_tokens,) and bool(((ids >= 0) & (ids < cfg.vocab_size)).all()), f"sampled ids {ids.tolist()}")
    check(bool(torch.isfinite(first_logits.float()).all()) and bool(torch.isfinite(logits.float()).all()),
          "moonshot logits not finite")
    check(tuple(caches["sub0"]["k"].shape) == (nl, 1, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim),
          f"moonshot k cache {tuple(caches['sub0']['k'].shape)}")
    print(f"moe: moonshot prefill (1, {prompt}), cache_len {cache_len}, in {prefill_s * 1e3:.1f} ms (the first call): "
          f"{prompt * k} "
          f"slots a layer, capacity {moe_mod.capacity(cfg, prompt)}; S1 launched {prefill_launches['sort_tiles_kv']} "
          f"times ({s1_pre} a layer), K4 {prefill_launches['sort_round_kv']} ({k4_pre} a layer); {new_tokens} tokens "
          f"sampled (top-k 40), {new_tokens - 1} decode steps in {decode_s * 1e3:.1f} ms "
          f"({decode_s * 1e3 / max(1, new_tokens - 1):.2f} ms per step with its sample; S1 at chunk "
          f"{1 << max(0, (k - 1).bit_length())} {s1_dec} a layer, the sample's S1 "
          f"1 and K4 {v_rounds}); launches in all: S1 {launches['sort_tiles_kv']}, K4 {launches['sort_round_kv']}; "
          f"peak memory {peak_gb()}; ids {ids.tolist()} ({card})")
    del caches, logits
    sync()
    t0 = time.perf_counter()
    logits, _ = prefill(params, {"tokens": tokens}, cache_len)
    sync()
    prefill_s = time.perf_counter() - t0  # the first call's time holds the card's first use of its shapes
    check(torch.equal(logits, first_logits), "two moonshot prefills of the same prompt differ")
    print(f"moe: a second moonshot prefill in {prefill_s * 1e3:.1f} ms (host clock) gives bit-identical logits ({card})")
    del logits, first_logits

    # 2. layer 0's own routing keys: S1 and K4 against their plain versions, the sorts and the positions
    moe_obj = {}
    for what, (p0, x0) in zip(("prefill", "decode step"), layer0):
        flat_e, margin = _routing(p0, x0, k)
        b, n = flat_e.shape
        tile, leaf = _sort_tile(n, None, None)
        slots = torch.arange(n, dtype=torch.int32, device=device).expand(b, n)
        kp = _pad_rows_pow2(flat_e, max_sentinel(torch.int32))
        m = kp.shape[1]
        kflat, vflat = kp.reshape(-1), _pad_rows_pow2(slots, 0).reshape(-1)
        chunk, width = _narrow_chunk(m, tile, torch.int32)
        got, ref = km.sort_tiles_kv(kflat, vflat, chunk), km.sort_tiles_kv_ref(kflat, vflat, chunk)
        s1_err = max(bit_err(g, r, f"S1 on moonshot's layer 0 {what} keys, chunk {chunk}") for g, r in zip(got, ref))
        kf = torch.cat([ref[0], torch.full((tile,), max_sentinel(torch.int32), dtype=torch.int32, device=device)])
        vf = torch.cat([ref[1], torch.zeros((tile,), dtype=torch.int32, device=device)])
        rounds = []
        while width < m:
            got, ref = km.sort_round_kv(kf, vf, width, tile=tile, leaf=leaf), km.sort_round_kv_ref(kf, vf, width, tile=tile)
            for g, r in zip(got, ref):
                bit_err(g, r, f"K4 on moonshot's layer 0 {what} keys, width {width}")
            rounds.append((kf, vf, width))
            kf, vf = ref
            width *= 2
        ks, vs = ops.sort_kv_batched(flat_e, slots)
        kc, vc = merge_sort_kv_batched(flat_e, slots)
        check(torch.equal(ks, kc) and torch.equal(vs, vc), f"ops.sort_kv_batched differs from the core sort on {what} keys")
        check(torch.equal(ks.reshape(-1), kf[:n]) and torch.equal(vs.reshape(-1), vf[:n]),
              f"the rounds' last output differs from ops.sort_kv_batched on {what} keys")
        pos = moe_mod._positions_merge_path_batched(flat_e, ne, backend="pallas")
        check(torch.equal(pos, moe_mod._positions_merge_path_batched(flat_e, ne, backend="core")) and
              torch.equal(pos, moe_mod._positions_cumsum(flat_e, ne)),
              f"dispatch positions of the three modes differ on {what} keys")
        lens = torch.tensor([n // 2 + 1], dtype=torch.int32, device=device)
        rag = moe_mod._positions_merge_path_batched(flat_e, ne, lens, backend="pallas")
        cum = moe_mod._positions_cumsum(flat_e, ne)
        cum = torch.where(torch.arange(n, device=device)[None, :] < lens[:, None], cum, 2 ** 30)
        check(torch.equal(rag, moe_mod._positions_merge_path_batched(flat_e, ne, lens, backend="core")) and
              torch.equal(rag, cum), f"ragged dispatch positions differ on {what} keys")
        cap = moe_mod.capacity(cfg, x0.shape[1])
        print(f"moe: moonshot's layer 0 {what} routing keys ({b}, {n}), {int(torch.unique(flat_e).numel())} experts "
              f"used: S1 (chunk {chunk}) and {len(rounds)} K4 rounds bit-identical to their plain versions; "
              f"ops.sort_kv_batched equal to the core sort; positions of merge_path_pallas, merge_path and cumsum "
              f"equal (and ragged at {int(lens)} slots); {int((pos >= cap).sum())} of {n} slots dropped at capacity "
              f"{cap}; least top-k margin {margin:.3g}")
        if what != "prefill":
            continue
        s1_bound, k4_bound = tiles_bound(m, 4, values=True), [round_bound(m, 4) for _ in rounds]
        moe_obj = {
            "sort_tiles_kv": {"launches": prefill_launches["sort_tiles_kv"], "max_abs_err": s1_err, "ms": None,
                              "plain_ms": None, "bound_ms": s1_bound["ms"], "bound_by": s1_bound["by"],
                              "library_ms": None},
            "sort_round_kv": {"launches": prefill_launches["sort_round_kv"], "max_abs_err": 0, "ms": None,
                              "plain_ms": None, "bound_ms": sum(r["ms"] for r in k4_bound),
                              "bound_by": k4_bound[0]["by"] if k4_bound else None, "library_ms": None},
        }
        if not on_card:
            continue
        s1, k4 = moe_obj["sort_tiles_kv"], moe_obj["sort_round_kv"]
        # calls that launch many kernels are timed in few iterations: the host must enqueue them all
        # while time_ms's sleep kernel holds the card (about 30 us a launch, 10 ms of sleep)
        s1.update(ms=time_ms(lambda: km.sort_tiles_kv(kflat, vflat, chunk)),
                  plain_ms=time_ms(lambda: km.sort_tiles_kv_ref(kflat, vflat, chunk), iters=1),
                  library_ms=time_ms(lambda: torch.gather(vflat.view(-1, chunk), 1, torch.sort(
                      kflat.view(-1, chunk), dim=1, stable=True).indices)))
        k4.update(ms=0.0, plain_ms=0.0, library_ms=0.0)
        for kf, vf, w in rounds:
            k4["ms"] += time_ms(lambda: km.sort_round_kv(kf, vf, w, tile=tile, leaf=leaf))
            k4["plain_ms"] += time_ms(lambda: km.sort_round_kv_ref(kf, vf, w, tile=tile), iters=3)
            pairs, vals = kf[:m].view(-1, 2 * w), vf[:m].view(-1, 2 * w)
            k4["library_ms"] += time_ms(lambda: torch.gather(vals, 1, torch.sort(pairs, dim=1, stable=True).indices))
        dispatch_ms = time_ms(lambda: moe_mod._positions_merge_path_batched(flat_e, ne, backend="pallas"), iters=4)
        core_ms = time_ms(lambda: moe_mod._positions_merge_path_batched(flat_e, ne, backend="core"), iters=1)
        sort_ms = time_ms(lambda: ops.sort_kv_batched(flat_e, slots), iters=10)
        torch_ms = time_ms(lambda: torch.sort(flat_e, dim=1, stable=True))
        apply_ms = time_ms(lambda: moe_mod.moe_apply(p0, x0, cfg), iters=2)
        print(f"  S1 kv on layer 0's prefill keys ({m},) int32, chunk {chunk}: kernel_ms {s1['ms']:.5f}  plain_ms "
              f"{s1['plain_ms']:.5f}  library_ms {s1['library_ms']:.5f}  bound_ms {s1['bound_ms']:.6f} "
              f"({s1['bound_by']}) ({card})")
        print(f"  K4's {len(rounds)} rounds on them (widths {chunk} ... {m // 2}): kernel_ms {k4['ms']:.5f}  plain_ms "
              f"{k4['plain_ms']:.5f}  library_ms {k4['library_ms']:.5f}  bound_ms {k4['bound_ms']:.6f} "
              f"({k4['bound_by']}) ({card})")
        print(f"  dispatch of layer 0 (sort and positions, merge_path_pallas) {dispatch_ms:.5f} ms, of which "
              f"ops.sort_kv_batched {sort_ms:.5f} ms (S1 and K4 {s1['ms'] + k4['ms']:.5f}); merge_path's plain sort "
              f"{core_ms:.5f} ms; one stable torch.sort of the same keys {torch_ms:.5f} ms; layer 0's whole moe_apply "
              f"(1, {prompt}, {cfg.d_model}) {apply_ms:.4f} ms, the dispatch {dispatch_ms / apply_ms:.4f} of it; "
              f"S1 and K4 {(s1['ms'] + k4['ms']) * nl:.4f} ms of the {prefill_s * 1e3:.1f} ms prefill (CUDA events, "
              f"{card})")
        moe_obj.update(dispatch_ms=dispatch_ms, core_dispatch_ms=core_ms, torch_sort_ms=torch_ms, apply_ms=apply_ms)
    del layer0, p0, x0  # layer 0's parameters are views that hold the whole stack

    if on_card:
        from repro_torch.launch.profile import profile_prefill, report_prefill

        report_prefill(f"moe: moonshot prefill (1, {prompt}) traced ({card})",
                       profile_prefill(prefill, params, {"tokens": tokens}, cache_len))
    print("moe: moonshot " + _prefill_against_stepping(cfg, params, prefill, decode, tokens[:, :step_prompt], device))
    del params
    free()

    # 3. moonshot training, cut in depth
    tc = config(MOE_ARCH, num_layers=train_layers)
    tcfg = TrainConfig(z_loss=1e-4, grad_clip=1.0)
    t0 = time.perf_counter()
    state = init_train_state(tc, tcfg, seed=0, device=device)
    state["step"].fill_(1)
    sync()
    print(f"moe: training {tc.name} at {'reduced' if reduce else 'full'} width, {train_layers} of "
          f"{get_config(MOE_ARCH).num_layers} layers: "
          f"{sum(t.numel() for t in _leaves(state['params'])) / 1e9:.3f} B parameters, "
          f"{sum(t.numel() * t.element_size() for t in _leaves(state)) / 1e9:.2f} GB of float32 masters and moments in "
          f"{time.perf_counter() - t0:.2f} s ({card})")
    pipe = SyntheticLMPipeline(tc, 1, train_seq, PipelineConfig(seed=0))
    batches = [{kk: torch.as_tensor(v, device=device) for kk, v in pipe.batch_at(i).items()} for i in range(1, steps + 1)]
    before = _fingerprints(state["params"])
    step_fn = make_train_step(tc, tcfg)
    losses, step_ms = [], []
    free()
    reset_launches()
    sync()
    for i, batch in enumerate(batches):
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        state, mt = step_fn(state, batch)
        if on_card:
            ev[1].record()
            ev[1].synchronize()
            step_ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(mt["loss"]))
        check(math.isfinite(losses[-1]) and math.isfinite(float(mt["grad_norm"])),
              f"moonshot train step {i + 1}: loss {losses[-1]}, grad norm {float(mt['grad_norm'])}")
    sync()
    launches = counts()
    s1_t, k4_t = sort_launches(train_seq * k)
    expect = want(sort_tiles_kv=2 * train_layers * s1_t * steps, sort_round_kv=2 * train_layers * k4_t * steps)
    check(launches == expect, f"moonshot training launched {launches}, want {expect}")
    still = [name for (name, _, _), a, bb in zip(leaf_report(state["params"]), before, _fingerprints(state["params"]))
             if torch.equal(a, bb)]
    check(not still, f"moonshot parameters did not move: {still}")
    train_ms = sum(step_ms[1:]) / max(1, len(step_ms) - 1) if on_card else None
    print(f"moe: moonshot {steps} train steps of (1, {train_seq}) at {train_layers} layers, remat_policy="
          f"{tc.remat_policy!r}: losses {[round(x, 5) for x in losses]}; S1 launched {launches['sort_tiles_kv']} times, "
          f"K4 {launches['sort_round_kv']} ({launches['sort_tiles_kv'] // steps} and "
          f"{launches['sort_round_kv'] // steps} a step: the forward and its recompute)"
          + (f"; step ms (CUDA events) {[round(x, 3) for x in step_ms]}, {train_ms:.3f} ms per step after the first, "
             f"{train_seq / train_ms * 1e3:.0f} tokens/s; peak memory {peak_gb()} ({card})" if on_card else
             "; times and peak memory not measured (CPU)"))
    del state, batches
    free()

    # 4. the card against itself: moe_apply's gradients on the kernel route and the core route
    gcfg = config(MOE_ARCH)
    ggen = torch.Generator(device=device)
    ggen.manual_seed(seed)
    gp = _cast(moe_mod.moe_init(ggen, gcfg, _dtype(gcfg)), _dtype(gcfg))
    gx = (torch.randn((1, grad_seq, gcfg.d_model), generator=ggen, device=device)).to(_dtype(gcfg))
    names = [name for name, _, _ in leaf_report(gp)]

    def grads(dispatch):
        leaves = [t.detach().requires_grad_() for t in _leaves(gp)]
        it = iter(leaves)
        tree = {kk: ({k2: next(it) for k2 in v} if isinstance(v, dict) else next(it)) for kk, v in gp.items()}
        xx = gx.detach().requires_grad_()
        reset_launches()
        loss = (moe_mod.moe_apply(tree, xx, dataclasses.replace(gcfg, moe_dispatch=dispatch)).float() ** 2).sum()
        out = torch.autograd.grad(loss, leaves + [xx])
        sync()
        return loss.detach(), out, counts()

    lk, gk, kc = grads("merge_path_pallas")
    lo, go, oc = grads("merge_path")
    s1_g, k4_g = sort_launches(grad_seq * k)
    check(kc == want(sort_tiles_kv=s1_g, sort_round_kv=k4_g) and oc == want(),
          f"moe_apply's gradient runs launched {kc} (kernel route) and {oc} (core route)")
    check(torch.equal(lk, lo), f"moe_apply loss {float(lk)} on merge_path_pallas, {float(lo)} on merge_path")
    for name, a, bb in zip(names + ["x"], gk, go):
        check(torch.equal(a, bb), f"moe_apply gradient {name} differs between merge_path_pallas and merge_path")
        check(bool((a != 0).any()) and bool(torch.isfinite(a).all()), f"moe_apply gradient {name} zero or not finite")
    print(f"moe: moe_apply of one {'reduced' if reduce else 'full-width'} moonshot layer at (1, {grad_seq}): loss and "
          f"{len(gk)} gradients "
          f"bit-identical on merge_path_pallas (S1 {kc['sort_tiles_kv']}, K4 {kc['sort_round_kv']} launches) and "
          f"merge_path (none), every gradient nonzero ({card})")
    del gp, gx, gk, go
    free()

    # 5. phi3.5-moe at full width cut in depth: prefill and sampled tokens
    pcfg = config(PHI_ARCH, num_layers=phi_layers)
    pk = pcfg.experts_per_token
    t0 = time.perf_counter()
    params = _cast(init_params(pcfg, seed=0, device=device), _dtype(pcfg))
    sync()
    print(f"moe: {pcfg.name} at {'reduced' if reduce else 'full'} width (d={pcfg.d_model}, {pcfg.num_heads} heads / "
          f"{pcfg.num_kv_heads} kv, "
          f"{pcfg.num_experts} experts top-{pk} of d_ff {pcfg.d_ff}, vocab {pcfg.vocab_size}), {phi_layers} of "
          f"{get_config(PHI_ARCH).num_layers} layers: {pcfg.n_params() / 1e9:.2f} B parameters, "
          f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.3f} GB of weights in "
          f"{time.perf_counter() - t0:.2f} s ({card})")
    pprefill, pdecode = make_prefill_step(pcfg), make_decode_step(pcfg)
    ptokens = torch.randint(1, pcfg.vocab_size, (1, phi_prompt), generator=gen, device=device)
    reset_launches()
    sync()
    t0 = time.perf_counter()
    logits, caches = pprefill(params, {"tokens": ptokens}, phi_prompt + phi_new)
    sync()
    phi_prefill_s = time.perf_counter() - t0
    pre = counts()
    sampled = [topk_sample(logits, sgen, k=40, temperature=0.8, backend="kernel")]
    sync()
    t0 = time.perf_counter()
    for i in range(phi_new - 1):
        logits, caches = pdecode(params, caches, sampled[-1][:, None], torch.full((1,), phi_prompt + i, device=device))
        sampled.append(topk_sample(logits, sgen, k=40, temperature=0.8, backend="kernel"))
    sync()
    phi_decode_s = time.perf_counter() - t0
    launches = counts()
    s1_p, k4_p = sort_launches(phi_prompt * pk)
    s1_pd, k4_pd = sort_launches(pk)
    pv = wide_rounds(pcfg.vocab_size, _sort_tile(pcfg.vocab_size, None, None)[0])
    expect = want(sort_tiles_kv=phi_layers * s1_p, sort_round_kv=phi_layers * k4_p)
    check(pre == expect, f"phi3.5-moe prefill launched {pre}, want {expect}")
    expect = want(sort_tiles_kv=phi_layers * (s1_p + (phi_new - 1) * s1_pd) + phi_new,
                  sort_round_kv=phi_layers * (k4_p + (phi_new - 1) * k4_pd) + phi_new * pv)
    check(launches == expect, f"phi3.5-moe serving path launched {launches}, want {expect}")
    ids = torch.cat(sampled)
    check(bool(torch.isfinite(logits.float()).all()) and bool(((ids >= 0) & (ids < pcfg.vocab_size)).all()),
          f"phi3.5-moe logits not finite or ids {ids.tolist()}")
    print(f"moe: phi3.5-moe prefill (1, {phi_prompt}) in {phi_prefill_s * 1e3:.1f} ms ({phi_prompt * pk} slots a layer: "
          f"S1 {pre['sort_tiles_kv']}, K4 {pre['sort_round_kv']} launches, {k4_p} rounds a layer); {phi_new} tokens "
          f"sampled, {phi_new - 1} decode steps in {phi_decode_s * 1e3:.1f} ms "
          f"({phi_decode_s * 1e3 / max(1, phi_new - 1):.2f} ms per step with its sample); launches in all: S1 "
          f"{launches['sort_tiles_kv']}, K4 {launches['sort_round_kv']}; peak memory {peak_gb()}; ids {ids.tolist()} "
          f"({card})")
    del params, caches, logits
    free()

    # 6. the reduced configs on this device against the CPU
    for arch in (PHI_ARCH, MOE_ARCH):
        moe_against_cpu(device, arch)
    return {**moe_obj, "prefill_s": prefill_s, "decode_ms": decode_s * 1e3 / max(1, new_tokens - 1),
            "train_ms": train_ms, "phi_prefill_s": phi_prefill_s}


DIST_LOG2N = 24  # part (a): 2 x 2^24 merges, 2^24 sorts
DIST_TOPK = (8, 262144)  # part (a): gemma3-12b's vocab
DIST_GLOO_RANKS, DIST_GLOO_LOG2N = 4, 16  # part (b)
DIST_STAGE_RANKS, DIST_STAGE_LOG2N = 8, 24  # part (c): 2^21 keys a rank
DIST_K = 40


def free_port() -> int:
    """A free local TCP port for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def shard_of(x, p: int, i: int):
    """Rank ``i``'s ceil-div shard of ``x`` along its last axis."""
    n = x.shape[-1]
    m = -(-n // p)
    return x[..., min(i * m, n):min((i + 1) * m, n)].contiguous()


def call_ms(fn, iters: int = 3) -> float:
    """Host milliseconds per call, each call ended by a synchronize (for
    calls that read the host between launches, as the distributed ones do)."""
    import torch

    fn()
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def dist_case_ranks(rank: int, world: int, port: int, case_path: str, out_dir: str) -> None:
    """One gloo rank of :func:`start_dist_cases`: every case on this rank's
    shards, its output (or the error it raised) saved to
    ``out_dir/<case>.<rank>.pt``.

    A case is a dict: ``name``; ``fn``, a function of
    ``repro_torch.core.distributed``, or ``"sample"`` (the sampler's
    ``"distributed"`` route beside its ``"kernel"`` route on the whole
    logits, both generators seeded with ``kwargs["seed"]``) or ``"dsort"``
    (``repro_torch.launch.dsort.main(kwargs["argv"])``); ``p``, the ranks
    it runs on (ranks ``0 ... p - 1``, a group of their own when ``p <
    world``); ``args``, the global inputs, and ``shard``, which of them
    each rank takes its ceil-div shard of; ``kwargs``; and optionally
    ``plan``, a fault plan (``repro_torch.runtime.faults``) the call runs
    under.  A ``ValueError`` and the guard's errors
    (``GuardedDispatchError``, ``VerificationError``) are saved as the
    case's error.
    """
    import contextlib

    import torch
    import torch.distributed as dist

    from repro_torch.runtime import faults
    from repro_torch.runtime.resilience import GuardedDispatchError, VerificationError

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        cases = torch.load(case_path, weights_only=True)
        groups = {p: None if p == world else dist.new_group(list(range(p))) for p in sorted({c["p"] for c in cases})}
        for case in cases:
            p, group = case["p"], groups[case["p"]]
            if rank >= p:
                continue
            args = [shard_of(a, p, rank) if s else a for a, s in zip(case["args"], case["shard"])]
            try:
                with faults.inject(case["plan"]) if case.get("plan") else contextlib.nullcontext():
                    res = {"out": _dist_case_call(case, args, group)}
            except (ValueError, GuardedDispatchError, VerificationError) as e:
                res = {"error": f"{type(e).__name__}: {e}"}
            torch.save(res, f"{out_dir}/{case['name']}.{rank}.pt")
    finally:
        dist.destroy_process_group()


def _dist_case_call(case: dict, args: list, group):
    """One case of :func:`dist_case_ranks` on this rank's arguments."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.serving import topk_sample

    kw = case["kwargs"]
    if case["fn"] == "sample":
        gens = [torch.Generator().manual_seed(kw["seed"]) for _ in range(2)]
        return (topk_sample(args[0], gens[0], k=kw["k"], backend="distributed", group=group),
                topk_sample(case["args"][0], gens[1], k=kw["k"], backend="kernel"))
    if case["fn"] == "dsort":
        from repro_torch.launch import dsort

        return dsort.main(kw["argv"])
    return getattr(D, case["fn"])(*args, group=group, **kw)


def start_dist_cases(cases: list, world: int, tmp: str):
    """Spawn ``world`` gloo ranks on CPU tensors that run ``cases``
    (:func:`dist_case_ranks`) and return at once: ``(context, out_dir)``."""
    import os

    import torch
    import torch.multiprocessing as mp

    case_path, out_dir = os.path.join(tmp, "cases.pt"), os.path.join(tmp, "out")
    os.makedirs(out_dir, exist_ok=True)
    torch.save(cases, case_path)
    ctx = mp.start_processes(dist_case_ranks, args=(world, free_port(), case_path, out_dir), nprocs=world,
                             join=False, start_method="spawn")
    return ctx, out_dir


def dist_case_results(ctx, out_dir: str, cases: list, timeout: float = 600) -> dict:
    """Wait for the ranks of :func:`start_dist_cases` (a rank's exception is
    raised here) and return every case's per-rank results."""
    import torch

    t0 = time.perf_counter()
    while not ctx.join(timeout=5):
        check(time.perf_counter() - t0 < timeout, f"the gloo ranks ran past {timeout} s")
    return {c["name"]: [torch.load(f"{out_dir}/{c['name']}.{r}.pt", weights_only=True) for r in range(c["p"])]
            for c in cases}


def gloo_parity_cases(log2n: int, gen) -> list:
    """Part (b)'s cases: every public function of ``core.distributed`` with
    every exchange and combine, on CPU tensors, each with its single-process
    ``repro_torch.core`` answer (``want``) and how a rank's output reads
    against it (``kind``)."""
    import torch

    from repro_torch import core
    from repro_torch.core.merge_path import max_sentinel

    n = 1 << log2n
    p = DIST_GLOO_RANKS

    def srt(x):
        return torch.sort(x, dim=-1).values.contiguous()

    a, b = srt(torch.randn(n, generator=gen)), srt(torch.randn(n - 3, generator=gen))
    av, bv = torch.arange(n, dtype=torch.int32), torch.arange(n, 2 * n - 3, dtype=torch.int32)
    ra, rb = srt(torch.randint(-9, 9, (3, n // 8 + 5), generator=gen).to(torch.int16)), srt(
        torch.randint(-9, 9, (3, n // 8 - 2), generator=gen).to(torch.int16))
    ka, kb = srt(torch.randint(0, 50, (3, n // 8), generator=gen, dtype=torch.int32)), srt(
        torch.randint(0, 50, (3, n // 8 + 1), generator=gen, dtype=torch.int32))
    ka[:, -n // 64:], kb[:, -n // 32:] = max_sentinel(torch.int32), max_sentinel(torch.int32)
    kav = torch.arange(ka.numel(), dtype=torch.int32).view(ka.shape)
    kbv = -torch.arange(kb.numel(), dtype=torch.int32).view(kb.shape) - 1
    xi = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, dtype=torch.int64).to(torch.int32)
    xf = torch.randn(n, generator=gen) * 100
    logits = torch.randn(4, n, generator=gen) * 3
    cases = []

    def add(name, fn, args, shard, want, kind, **kwargs):
        cases.append({"name": name, "fn": fn, "p": p, "args": list(args), "shard": list(shard), "kwargs": kwargs,
                      "want": want, "kind": kind})

    for ex in ("window", "gather"):
        add(f"merge_{ex}", "distributed_merge", (a, b), (1, 1), core.merge(a, b), "segments", exchange=ex)
        add(f"merge_kv_{ex}", "distributed_merge_kv", (a, av, b, bv), (1, 1, 1, 1), core.merge_kv(a, av, b, bv),
            "segments", exchange=ex)
        add(f"merge_batched_int16_{ex}", "distributed_merge_batched", (ra, rb), (1, 1), core.merge_batched(ra, rb),
            "segments", exchange=ex)
        add(f"merge_kv_batched_{ex}", "distributed_merge_kv_batched", (ka, kav, kb, kbv), (1, 1, 1, 1),
            core.merge_kv_batched(ka, kav, kb, kbv), "segments", exchange=ex)
    add("merge_local", "distributed_merge_local", (a[:n - 4], b[:n - 4]), (1, 1), core.merge(a[:n - 4], b[:n - 4]),
        "segments")
    for x, dt in ((xi, "int32"), (xf, "float32")):
        for local_sort in ("core", "kernel"):
            for combine in ("onepass", "tournament"):
                add(f"sort_{dt}_{local_sort}_{combine}", "distributed_sort", (x,), (1,), core.merge_sort(x), "sort",
                    local_sort=local_sort, combine=combine)
        add(f"sort_local_{dt}", "distributed_sort_local", (x,), (1,), core.merge_sort(x), "sort")
    for ex in ("butterfly", "gather", "auto"):
        v, i = core.topk_batched(xf[None, :], DIST_K)
        add(f"topk_{ex}", "distributed_topk", (xf, DIST_K), (1, 0), (v[0], i[0]), "replicated", exchange=ex)
        add(f"topk_batched_{ex}", "distributed_topk_batched", (logits, DIST_K), (1, 0),
            core.topk_batched(logits, DIST_K), "replicated", exchange=ex)
    add("topk_local", "distributed_topk_local", (xf,), (1,), (v[0], i[0]), "replicated", k=DIST_K)
    return cases


def check_gloo_case(case: dict, outs: list) -> None:
    """Hold one part (b) case's per-rank outputs against its core answer, bit for bit."""
    import torch

    name, want, kind = case["name"], case["want"], case["kind"]
    for r, res in enumerate(outs):
        check("error" not in res, f"gloo {name} rank {r}: {res.get('error')}")
    got = [res["out"] for res in outs]
    if kind == "segments":
        if isinstance(want, tuple):
            for j, part in enumerate(("keys", "values")):
                bit_err(torch.cat([g[j] for g in got], -1), want[j], f"gloo {name} {part}")
        else:
            bit_err(torch.cat(got, -1), want, f"gloo {name}")
    elif kind == "sort":
        check(not any(bool(g[2]) for g in got), f"gloo {name}: overflow")
        bit_err(torch.cat([g[0][: int(g[1][0])] for g in got]), want, f"gloo {name} valid prefixes")
    else:
        for r, g in enumerate(got):
            for j, part in enumerate(("values", "indices")):
                bit_err(g[j], want[j], f"gloo {name} rank {r} {part}")


def phase_distributed(device: str = "cuda", card: str = "cpu", log2n: int = DIST_LOG2N, topk_shape=DIST_TOPK,
                      gloo_log2n: int = DIST_GLOO_LOG2N, stage_ranks: int = DIST_STAGE_RANKS,
                      stage_log2n: int = DIST_STAGE_LOG2N, seed: int = 13) -> dict:
    """Distributed Merge Path (``repro_torch.core.distributed``) in three parts.

    (a) One rank in this process (NCCL on the card, gloo on the CPU, world
        size 1): ``distributed_merge`` of 2 x 2^log2n float32 keys under
        ``"window"`` and ``"gather"``, bit-identical to each other and to
        ``ops.merge``; ``distributed_merge_kv`` with int32 values against
        ``ops.merge_kv``; ``distributed_sort`` of 2^log2n int32 and float32
        keys with ``local_sort="kernel"`` and both combines, the valid
        prefix bit-identical to ``ops.sort`` and a stable ``torch.sort``,
        with S1 and K3 (int32) or K4 (float32) launches read exactly (at
        P = 1 the tournament's one run launches no K7);
        ``distributed_topk_batched`` of ``topk_shape`` logits under
        ``"auto"`` (``"gather"`` at P = 1) bit-identical to the
        ``"kernel"`` sampler's candidates, and the same token from the same
        seed; the host ms of each call.
    (b) Gloo at P = 4 on CPU tensors (four spawned ranks, 2^gloo_log2n
        keys): every public function with every exchange and combine
        bit-identical to single-process ``repro_torch.core``.  CPU tensors
        launch no kernel.
    (c) The sample sort's per-rank stages at P = ``stage_ranks`` on this
        device, 2^stage_log2n keys in all, int32 and float32: each rank's
        ``sort_prepare`` (S1 and K3 or K4), the splitter gather and the
        bucket exchange emulated by stacking and transposing on this
        device ("emulated exchange (one card)": not a collective), each
        rank's ``sort_combine`` under ``"tournament"`` (K7 on the card) and
        ``"onepass"``; the valid prefixes in rank order bit-identical to a
        stable ``torch.sort`` of the whole, K7 against its plain version on
        rank 0's received runs, S1 and K3/K4 on rank 0's shard; the ms of
        each stage per rank beside a stable ``torch.sort`` of one shard.
    On the CPU (the tests) the plain versions stand in for the kernels and
    nothing is timed.  Returns the ``"distributed"`` objects of S1, K3, K4
    and K7 for the ``kernels`` line.
    """
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import core
    from repro_torch.core import distributed as D
    from repro_torch.core.merge_path import max_sentinel, total_order_keys
    from repro_torch.kernels import WRAPPERS, ops, reset_launches
    from repro_torch.kernels import merge_path as km
    from repro_torch.kernels.ops import _sort_tile
    from repro_torch.serving import sampler

    on_card = device == "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def counts():
        return {fn.__name__: fn.launches for fn in WRAPPERS}

    def want(**kw):
        out = dict.fromkeys((fn.__name__ for fn in WRAPPERS), 0)
        if on_card:
            out.update(kw)
        return out

    def timed(fn, iters=3):
        return call_ms(fn, iters) if on_card else None

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    # (a) one rank in this process
    dist.init_process_group("nccl" if on_card else "gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        n = 1 << log2n
        a, b = (torch.sort(torch.randn(n, generator=gen, device=device)).values for _ in range(2))
        av = torch.arange(n, dtype=torch.int32, device=device)
        bv = torch.arange(n, 2 * n, dtype=torch.int32, device=device)
        window = D.distributed_merge(a, b)
        gather = D.distributed_merge(a, b, exchange="gather")
        bit_err(window, gather, "distributed_merge window against gather")
        bit_err(window, ops.merge(a, b), "distributed_merge against ops.merge")
        for ex in ("window", "gather"):
            for got, ref, part in zip(D.distributed_merge_kv(a, av, b, bv, exchange=ex), ops.merge_kv(a, av, b, bv),
                                      ("keys", "values")):
                bit_err(got, ref, f"distributed_merge_kv {ex} {part} against ops.merge_kv")
        ms = {"distributed_merge window": timed(lambda: D.distributed_merge(a, b)),
              "distributed_merge gather": timed(lambda: D.distributed_merge(a, b, exchange="gather")),
              "ops.merge": timed(lambda: ops.merge(a, b)),
              "distributed_merge_kv window": timed(lambda: D.distributed_merge_kv(a, av, b, bv)),
              "ops.merge_kv": timed(lambda: ops.merge_kv(a, av, b, bv))}
        del window, gather
        tile = _sort_tile(n, None, None)[0]
        sort_launches = {}
        for dtype in (torch.int32, torch.float32):
            if dtype == torch.int32:
                x = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, device=device, dtype=torch.int64).to(dtype)
                tiles, rounds = "sort_tiles", "sort_round"
            else:
                x = torch.randn(n, generator=gen, device=device) * 100
                tiles, rounds = "sort_tiles_kv", "sort_round_kv"
            ref = torch.sort(x, stable=True).values
            bit_err(ops.sort(x), ref, f"ops.sort {dtype} against torch.sort")
            for combine in ("onepass", "tournament"):
                reset_launches()
                out, count, overflow = D.distributed_sort(x, local_sort="kernel", combine=combine)
                got = counts()
                expect = want(**{tiles: 1, rounds: wide_rounds(n, tile)})
                check(got == expect, f"distributed_sort {dtype} {combine} launched {got}, want {expect}")
                sort_launches[tiles], sort_launches[rounds] = got[tiles], got[rounds]
                check(int(count[0]) == n and not bool(overflow), f"distributed_sort {dtype}: count {int(count[0])}")
                bit_err(out[:n], ref, f"distributed_sort {dtype} {combine} valid prefix against torch.sort")
                check(bool((out[n:] == max_sentinel(dtype)).all()), f"distributed_sort {dtype}: tail not sentinel")
                ms[f"distributed_sort {str(dtype)[6:]} {combine}"] = timed(
                    lambda: D.distributed_sort(x, local_sort="kernel", combine=combine))
            ms[f"ops.sort {str(dtype)[6:]}"] = timed(lambda: ops.sort(x))
            ms[f"torch.sort {str(dtype)[6:]} (stable)"] = timed(lambda: torch.sort(x, stable=True))
        del x, ref, out
        logits = torch.randn(topk_shape, generator=gen, device=device) * 3
        check(D._resolve_topk_exchange("auto", 1) == "gather", "auto at P = 1 is not the gather exchange")
        reset_launches()
        dv, di = D.distributed_topk_batched(logits, DIST_K)
        check(counts() == want(), f"distributed_topk_batched launched {counts()}")
        kv_, ki = sampler._topk_candidates(logits, DIST_K, None, "kernel", None, None)
        bit_err(dv, kv_, "distributed_topk_batched values against the kernel sampler's")
        bit_err(di, ki, "distributed_topk_batched indices against the kernel sampler's")
        tokens = []
        for backend in ("distributed", "kernel"):
            g = torch.Generator(device=device)
            g.manual_seed(seed)
            tokens.append(sampler.topk_sample(logits, g, k=DIST_K, backend=backend))
        bit_err(tokens[0], tokens[1], "the distributed sampler's tokens against the kernel sampler's")
        ms[f"distributed_topk_batched {tuple(topk_shape)}"] = timed(lambda: D.distributed_topk_batched(logits, DIST_K))
        ms[f"kernel sampler's top-k {tuple(topk_shape)}"] = timed(
            lambda: sampler._topk_candidates(logits, DIST_K, None, "kernel", None, None))
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    del logits
    print(f"distributed: (a) one rank ({backend}, world size 1): 2 x 2^{log2n} merges window == gather == ops.merge "
          f"(kv too), 2^{log2n} sorts with local_sort=\"kernel\" equal to ops.sort and a stable torch.sort, launches "
          f"per call {sort_launches}, top-k {tuple(topk_shape)} equal to the kernel sampler's, tokens {tokens[0].tolist()}")
    print("distributed: (a) host ms per call: " + ", ".join(f"{k} {fmt(v)}" for k, v in ms.items()) + f" ({card})")

    # (b) gloo at P = 4 on CPU tensors
    cpu_gen = torch.Generator().manual_seed(seed)
    cases = gloo_parity_cases(gloo_log2n, cpu_gen)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx, out_dir = start_dist_cases([{k: v for k, v in c.items() if k not in ("want", "kind")} for c in cases],
                                        DIST_GLOO_RANKS, tmp)
        results = dist_case_results(ctx, out_dir, cases)
    for case in cases:
        check_gloo_case(case, results[case["name"]])
    print(f"distributed: (b) gloo, {DIST_GLOO_RANKS} spawned ranks on CPU tensors (no kernel launched), 2^{gloo_log2n} "
          f"keys: {len(cases)} calls of every public function, exchange and combine bit-identical to "
          f"single-process repro_torch.core in {time.perf_counter() - t0:.1f} s")

    # (c) the per-rank stages at P = stage_ranks on this device
    p = stage_ranks
    n = 1 << stage_log2n
    m = n // p
    cap = D.sort_capacity(m, 2.0)
    tile = _sort_tile(m, None, None)[0]
    chunk = min(m, tile)
    widths = [tile << i for i in range(wide_rounds(m, tile))]
    objs = {}
    stage_ms = {}
    for dtype in (torch.int32, torch.float32):
        name = str(dtype)[6:]
        if dtype == torch.int32:
            x = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, device=device, dtype=torch.int64).to(dtype)
            tiles, rounds = "sort_tiles", "sort_round"
        else:
            x = torch.randn(n, generator=gen, device=device) * 100
            tiles, rounds = "sort_tiles_kv", "sort_round_kv"
        shards = x.view(p, m)
        prepared = []
        for r in range(p):
            reset_launches()
            prepared.append(D.sort_prepare(shards[r], p, "kernel"))
            prep_launches = counts()
            expect = want(**{tiles: 1, rounds: len(widths)})
            check(prep_launches == expect, f"rank {r} {name} sort_prepare launched {prep_launches}, want {expect}")
        splitters = D.sort_splitters(torch.stack([s for _, s in prepared]), p)  # emulated all_gather
        buckets = [D.sort_buckets(local, splitters, cap) for local, _ in prepared]
        send_all = torch.stack([s for s, _ in buckets])  # (sender, receiver, cap)
        counts_all = torch.stack([c for _, c in buckets])  # (sender, receiver)
        check(not bool((counts_all > cap).any()), f"{name}: a bucket overflowed")
        prefixes, k7 = [], []
        recvs = [(send_all[:, j].contiguous(), counts_all[:, j].contiguous()) for j in range(p)]
        for j, (recv, lens) in enumerate(recvs):
            reset_launches()
            out = D.sort_combine(recv, lens, "tournament", "kernel")
            k7.append(counts()["merge_batched_ragged"])
            check(counts() == want(merge_batched_ragged=(p - 1).bit_length()),
                  f"rank {j} {name} tournament launched {counts()}")
            bit_err(out, D.sort_combine(recv, lens, "onepass"), f"rank {j} {name} tournament against onepass")
            prefixes.append(out[: int(lens.sum())])
        bit_err(torch.cat(prefixes), torch.sort(x, stable=True).values,
                f"{name}: the valid prefixes in rank order against a stable torch.sort")
        del send_all, prefixes
        # K7 against its plain version on rank 0's received runs, round by round
        stacked, run_lens = recvs[0]
        k7_err, k7_rounds = 0, []
        while stacked.shape[0] > 1:
            args = (stacked[0::2], stacked[1::2], run_lens[0::2].contiguous(), run_lens[1::2].contiguous())
            got = km.merge_batched_ragged(*args, tile=tile)
            k7_err = max(k7_err, bit_err(got, km.merge_batched_ragged_ref(*args), f"{name} K7 round of rank 0"))
            valid = int(run_lens.sum())
            cat = torch.cat([masked(args[0], args[2]), masked(args[1], args[3])], 1)
            k7_rounds.append({"ms": time_ms(lambda: km.merge_batched_ragged(*args, tile=tile)) if on_card else None,
                              "plain_ms": time_ms(lambda: km.merge_batched_ragged_ref(*args), iters=5) if on_card else None,
                              "library_ms": time_ms(lambda: torch.sort(cat, dim=1, stable=True), iters=5) if on_card else None,
                              "bound": rows_bound(valid, got.numel(), valid, 4)})
            stacked, run_lens = got, run_lens[0::2] + run_lens[1::2]
        # S1 and every K3/K4 round on rank 0's shard, against their plain versions
        x0 = shards[0].contiguous()
        keys0 = total_order_keys(x0)
        idx0 = torch.arange(m, dtype=torch.int32, device=device)
        if dtype == torch.int32:
            s1, s1_ref = (lambda: km.sort_tiles(keys0, chunk)), (lambda: km.sort_tiles_ref(keys0, chunk))
            s1_err = bit_err(s1(), s1_ref(), f"{name} S1 on rank 0's shard")
        else:
            s1, s1_ref = (lambda: km.sort_tiles_kv(keys0, idx0, chunk)), (lambda: km.sort_tiles_kv_ref(keys0, idx0, chunk))
            s1_err = max(bit_err(g, w, f"{name} S1 kv on rank 0's shard") for g, w in zip(s1(), s1_ref()))
        round_err, round_t = 0, []
        for w in widths:
            kf, vf = round_inputs(keys0, w, idx0, tile=tile)
            if dtype == torch.int32:
                kern, plain = (lambda: km.sort_round(kf, w, tile=tile)), (lambda: km.sort_round_ref(kf, w, tile=tile))
                round_err = max(round_err, bit_err(kern(), plain(), f"{name} K3 width {w} on rank 0's shard"))
            else:
                kern, plain = (lambda: km.sort_round_kv(kf, vf, w, tile=tile)), (lambda: km.sort_round_kv_ref(kf, vf, w, tile=tile))
                round_err = max(round_err, *(bit_err(g, q, f"{name} K4 width {w} on rank 0's shard")
                                             for g, q in zip(kern(), plain())))
            pairs = kf[:m].view(-1, 2 * w)
            round_t.append({"ms": time_ms(kern) if on_card else None, "plain_ms": time_ms(plain) if on_card else None,
                            "library_ms": time_ms(lambda: torch.sort(pairs, dim=1, stable=True)) if on_card else None,
                            "bound": round_bound(m, 4, values=dtype != torch.int32)})

        def total(parts, key):
            return None if parts[0][key] is None else sum(q[key] for q in parts)

        tb = tiles_bound(m, 4, values=dtype != torch.int32)
        objs[tiles] = {"launches": sort_launches[tiles], "launches_per_rank_p8": prep_launches[tiles],
                       "max_abs_err": s1_err, "ms": time_ms(s1) if on_card else None,
                       "plain_ms": time_ms(s1_ref, iters=5) if on_card else None,
                       "bound_ms": tb["ms"], "bound_by": tb["by"],
                       "library_ms": time_ms(lambda: torch.sort(keys0.view(-1, chunk), dim=1, stable=True)) if on_card else None}
        objs[rounds] = {"launches": sort_launches[rounds], "launches_per_rank_p8": prep_launches[rounds],
                        "max_abs_err": round_err, "ms": total(round_t, "ms"), "plain_ms": total(round_t, "plain_ms"),
                        "bound_ms": sum(q["bound"]["ms"] for q in round_t), "bound_by": round_t[0]["bound"]["by"],
                        "library_ms": total(round_t, "library_ms")}
        if dtype == torch.int32:  # K7 on the int32 keys' combine
            objs["merge_batched_ragged"] = {
                "launches": 0, "launches_per_rank_p8": k7[0], "max_abs_err": k7_err, "ms": total(k7_rounds, "ms"),
                "plain_ms": total(k7_rounds, "plain_ms"), "bound_ms": sum(q["bound"]["ms"] for q in k7_rounds),
                "bound_by": k7_rounds[0]["bound"]["by"], "library_ms": total(k7_rounds, "library_ms")}
        if on_card:
            stage_ms[name] = {
                "prepare": [time_ms(lambda: D.sort_prepare(shards[r], p, "kernel"), iters=5) for r in range(p)],
                "tournament": [time_ms(lambda: D.sort_combine(*recvs[j], "tournament", "kernel"), iters=5) for j in range(p)],
                "onepass": [time_ms(lambda: D.sort_combine(*recvs[j], "onepass"), iters=5) for j in range(p)],
                "torch.sort": time_ms(lambda: torch.sort(x0, stable=True), iters=5)}
        del recvs, stacked, x, shards
        if on_card:
            torch.cuda.empty_cache()
    print(f"distributed: (c) the sample sort's stages at P = {p} on {device}, 2^{stage_log2n} keys (2^{m.bit_length() - 1} "
          f"a rank), emulated exchange (one card; stacking and transposing on the device, not a collective): the valid "
          f"prefixes equal a stable torch.sort for int32 and float32; launches per rank: sort_prepare S1 1 and "
          f"{len(widths)} K3 or K4, the tournament combine {(p - 1).bit_length()} K7, onepass none "
          f"({'the plain versions on the CPU' if not on_card else 'read exactly'})")
    for name, st in stage_ms.items():
        print(f"distributed: (c) {name} ms per rank (CUDA events): prepare {[round(v, 5) for v in st['prepare']]}, "
              f"tournament combine {[round(v, 5) for v in st['tournament']]}, onepass combine "
              f"{[round(v, 5) for v in st['onepass']]}; a stable torch.sort of one rank's 2^{m.bit_length() - 1} "
              f"{st['torch.sort']:.5f} ({card})")
    for key, o in objs.items():
        print(f"distributed: {key}: " + json.dumps(o))
    return objs


RUNTIME_OPS = ("merge", "sort", "sort_kv", "merge_batched_ragged", "merge_k", "topk_batched_ragged")
# What each injected fault does to a call of phase 12, the outcome the CPU
# tests (tests/test_torch_faults.py) hold to the reference's: the port raises
# exactly where the reference's first attempt fails.  A sort of NaN-laced
# keys is a correct total-order sort; merge_k laces nothing and has no
# shared-memory check of its own (its rounds are guarded calls), as in the
# reference.
RUNTIME_EXPECT = {
    "launch": dict.fromkeys(RUNTIME_OPS, "GuardedDispatchError"),
    "vmem": dict(dict.fromkeys(RUNTIME_OPS, "GuardedDispatchError"), merge_k=None),
    "exchange": dict.fromkeys(RUNTIME_OPS, "VerificationError"),
    "nan": dict(dict.fromkeys(RUNTIME_OPS), merge="VerificationError", merge_batched_ragged="VerificationError"),
}
VERIFY_BYTES_PER_KEY = 4  # float32 and int32 keys: the verifier reads each output key once


def in_turns(measure, settings: dict, pairs: int, base=None) -> dict:
    """``measure()`` under each environment of ``settings`` (name ->
    variables), ``pairs`` rounds with the order alternating: the median of
    each name, and ``<name>_iqr`` the distance between its quartiles; the
    first two names' ``difference`` (second minus first) last."""
    import os
    import statistics
    from unittest import mock

    got = {name: [] for name in settings}
    names = list(settings)
    for i in range(pairs):
        for name in names if i % 2 == 0 else names[::-1]:
            with mock.patch.dict(os.environ, dict(base or {}, **settings[name])):
                got[name].append(measure())
    out = {}
    for name, values in got.items():
        q = statistics.quantiles(values, n=4) if len(values) > 1 else [values[0]] * 3
        out[name], out[f"{name}_iqr"] = statistics.median(values), q[2] - q[0]
    out["difference"] = out[names[1]] - out[names[0]]
    return out


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds per call, the calls queued back to back and one
    synchronize at the end (the card is faster than the host here)."""
    import torch

    fn()
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e6 / iters


def _same(got, want, what: str) -> None:
    for j, (g, w) in enumerate(zip(got, want) if isinstance(want, tuple) else [(got, want)]):
        bit_err(g, w, f"{what} [{j}]")


def phase_runtime(device: str = "cuda", card: str = "cpu", log2n: int = 24, rows=(64, 1 << 18), log2_run: int = 21,
                  vocab: int = 32000, routing=(1, 24576, 64), scan=(1, 32768, 8192, 16), reduce: bool = False,
                  smoke: bool = True, seed: int = 17) -> dict:
    """The guarded dispatch, the fault injector and the trace export
    (``repro_torch.runtime``, ``repro_torch.telemetry``) on the card.

    (a) Clean calls with verification forced on (``REPRO_GUARD_VERIFY=1``):
        every guarded op at phase 4/5 sizes (2 x 2^log2n merges, 2^log2n
        sorts, ``rows`` x 2 batched and ragged merges, (64, 65536) rows,
        ``ops.merge_k`` of 8 runs of 2^log2_run, the sampler's (1, vocab)
        top-k, a moonshot routing sort of ``routing`` (rows, slots,
        experts)) and ``ssm_scan`` at phase 7's layer-0 shape ``scan``: each
        bit-identical to the same call under ``REPRO_GUARD=0``, the same
        launch counts, and ``served_by {"kernel": 1}`` ("plain" on the CPU).
    (b) Each fault class on each of ``RUNTIME_OPS`` (and ``launch`` on
        ``ssm_scan_pallas``): the outcome of ``RUNTIME_EXPECT``, no launch
        where the call raised before launching, a launch otherwise, and the
        next call without a plan bit-identical to the clean one.
    (c) ROADMAP R10's NaN-laced keys with verification on and no plan:
        ``ops.merge`` and ``ops.merge_k`` raise ``VerificationError``, and so
        does ``distributed_merge`` over a one-rank group (NCCL on the card);
        ``distributed_sort`` there is one local total-order sort (no
        splitters at P = 1), so its output of NaN-laced keys is sorted and
        passes; with an ``exchange`` fault it raises, as the window
        exchange of ``distributed_merge`` does.  On the card, the host ms
        of ``distributed_merge`` and ``distributed_sort`` at 2^log2n with
        the guard (which always verifies them) and with ``REPRO_GUARD=0``.
    (d) The cost of verification: CUDA-event ms of ``ops.merge`` of 2 x
        2^log2n and ``ops.sort`` of 2^log2n verified and not (3 pairs of
        turns, medians and quartile spreads), and the verifier's own device
        ms, beside its byte bound (each output key read once at the card's
        memory rate).
    (e) The cost of the guard: host us per call of the sampler's (1, vocab)
        top-k and of the routing sort, guard on and ``REPRO_GUARD=0``,
        verification off (10 pairs of turns, medians and quartile spreads),
        and the guard's own host us around a call that does nothing.
    (f) Serving with faults: tinyllama-1.1b at full width (the reduced
        config with ``reduce``) serves 3 greedy requests under
        ``launch:serving.decode:1,2``: all complete with 2 retries; the run
        replayed in a fresh registry gives the same trace bytes, which pass
        the port's ``--check``.
    (g) ``python -m repro_torch.telemetry.smoke`` in a process of its own
        (with ``smoke``), and ``python -m repro_torch.telemetry --check`` of
        its trace.
    On the CPU (the tests) the plain versions stand in for the kernels,
    no launch is counted and nothing is timed.
    """
    import contextlib
    import os
    import tempfile
    import warnings
    from unittest import mock

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.kernels import WRAPPERS, ops, reset_launches
    from repro_torch.kernels import ssm_scan as ks
    from repro_torch.models import init_params
    from repro_torch.runtime import faults
    from repro_torch.runtime import resilience as res
    from repro_torch.runtime.resilience import GuardedDispatchError, VerificationError
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.telemetry import Telemetry, trace_json_bytes, use
    from repro_torch.telemetry import __main__ as trace_cli

    def env_vars(**values):
        return mock.patch.dict(os.environ, values)

    on_card = device == "cuda"
    label = "kernel" if on_card else "plain"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def counts():
        return {fn.__name__: fn.launches for fn in WRAPPERS}

    def srt(x):
        return torch.sort(x, dim=-1).values.contiguous()

    n = 1 << log2n
    bsz, w = rows
    a, b = srt(torch.randn(n, generator=gen, device=device)), srt(torch.randn(n, generator=gen, device=device))
    iota = torch.arange(n, dtype=torch.int32, device=device)
    xi = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, device=device, dtype=torch.int64).to(torch.int32)
    xf = torch.randn(n, generator=gen, device=device) * 100
    ra, rb = (srt(torch.randn(bsz, w, generator=gen, device=device)) for _ in range(2))
    ka, kb = (srt(torch.randint(-1000, 1000, (bsz, w), generator=gen, device=device, dtype=torch.int32)) for _ in range(2))
    kva = torch.arange(bsz * w, dtype=torch.int32, device=device).view(bsz, w)
    la, lb = ragged_lens(bsz, w, w, gen, device)
    runs = srt(torch.randn(8, 1 << log2_run, generator=gen, device=device))
    sb = torch.randint(-2**31, 2**31 - 1, (bsz, min(w, 65536)), generator=gen, device=device, dtype=torch.int64).to(torch.int32)
    logits = torch.randn(1, vocab, generator=gen, device=device) * 3
    vlen = torch.tensor([vocab - 7], dtype=torch.int32, device=device)
    r_rows, r_slots, r_experts = routing
    rkeys = torch.randint(0, r_experts, (r_rows, r_slots), generator=gen, device=device, dtype=torch.int32)
    rslots = torch.arange(r_rows * r_slots, dtype=torch.int32, device=device).view(r_rows, r_slots)
    sbsz, ss, sd, sst = scan
    scan_ops = scan_inputs(sbsz, ss, sd, sst, torch.bfloat16, gen, device)
    calls = {
        "merge": ("merge", lambda: ops.merge(a, b)),
        "merge_kv": ("merge_kv", lambda: ops.merge_kv(a, iota, b, iota)),
        "merge_batched": ("merge_batched", lambda: ops.merge_batched(ra, rb)),
        "merge_kv_batched": ("merge_kv_batched", lambda: ops.merge_kv_batched(ka, kva, kb, kva)),
        "merge_batched_ragged": ("merge_batched_ragged", lambda: ops.merge_batched_ragged(ra, rb, la, lb)),
        "merge_kv_batched_ragged": ("merge_kv_batched_ragged",
                                    lambda: ops.merge_kv_batched_ragged(ka, kva, kb, kva, la, lb)),
        "merge_k": ("merge_k", lambda: ops.merge_k(runs)),
        "sort int32": ("sort", lambda: ops.sort(xi)),
        "sort float32": ("sort", lambda: ops.sort(xf)),
        "sort_kv": ("sort_kv", lambda: ops.sort_kv(xf, iota)),
        "sort_batched": ("sort_batched", lambda: ops.sort_batched(sb)),
        "sort_kv_batched (routing)": ("sort_kv_batched", lambda: ops.sort_kv_batched(rkeys, rslots)),
        "topk_batched": ("topk_batched", lambda: ops.topk_batched(logits, DIST_K)),
        "topk_batched_ragged": ("topk_batched_ragged", lambda: ops.topk_batched_ragged(logits, DIST_K, vlen)),
        "ssm_scan": ("ssm_scan_pallas", lambda: ks.ssm_scan(*scan_ops)),
    }
    # the fault cases' calls: float keys, so a nan fault laces them
    fault_calls = {"merge": "merge", "sort": "sort float32", "sort_kv": "sort_kv",
                   "merge_batched_ragged": "merge_batched_ragged", "merge_k": "merge_k",
                   "topk_batched_ragged": "topk_batched_ragged", "ssm_scan_pallas": "ssm_scan"}

    # (a) clean calls, verified, against the same calls with the guard off
    clean, clean_launches = {}, {}
    for name, (op, fn) in calls.items():
        with env_vars(REPRO_GUARD="0"):
            reset_launches()
            clean[name] = fn()
            sync()
            clean_launches[name] = counts()
        with env_vars(REPRO_GUARD_VERIFY="1"), use(Telemetry()) as tel:
            reset_launches()
            got = fn()
            sync()
            launched = counts()
            served = tel.health[op].served_by
        _same(got, clean[name], f"runtime: verified {name} against REPRO_GUARD=0")
        check(launched == clean_launches[name], f"runtime: verified {name} launched {launched}, "
                                                f"unguarded {clean_launches[name]}")
        check(served == {label: 1}, f"runtime: {name} served_by {served}")
        if on_card:
            check(sum(launched.values()) > 0, f"runtime: {name} launched no kernel")
    del got
    print(f"runtime: (a) {len(calls)} clean calls verified (REPRO_GUARD_VERIFY=1) bit-identical to REPRO_GUARD=0, "
          f"the same launch counts, served_by {{{label!r}: 1}}: " + ", ".join(
              f"{k} {sum(v.values())}" for k, v in clean_launches.items()) + " launches")

    # (b) injected faults
    outcomes = {}
    plans = [(cls, op) for cls in RUNTIME_EXPECT for op in RUNTIME_OPS] + [("launch", "ssm_scan_pallas")]
    for cls, op in plans:
        name = fault_calls[op]
        want = RUNTIME_EXPECT[cls].get(op, "GuardedDispatchError")
        with faults.inject(f"{cls}:{op}:0"), use(Telemetry()) as tel:
            reset_launches()
            try:
                calls[name][1]()
                sync()
                raised = None
            except (GuardedDispatchError, VerificationError) as e:
                raised = type(e).__name__
            launched = sum(counts().values())
            fired = [(e.cls, e.op, e.index) for e in faults.fired_events()]
            h = tel.health[op].as_dict()
        check(raised == want, f"runtime: {cls} fault on {op} gave {raised}, want {want}")
        expect_fired = [] if (op == "merge_k" and cls in ("vmem", "nan")) else [(cls, op, 0)]
        check(fired[:1] == expect_fired, f"runtime: {cls} fault on {op} fired {fired}")
        check(h["calls"] == 1 and h["exhausted"] == int(raised is not None), f"runtime: {cls} on {op} health {h}")
        if on_card:
            before_launch = raised is not None and cls in ("launch", "vmem")
            check((launched == 0) == before_launch, f"runtime: {cls} fault on {op} launched {launched} kernels")
        reset_launches()
        _same(calls[name][1](), clean[name], f"runtime: {op} after a {cls} fault")
        outcomes[f"{cls}:{op}"] = {"raised": raised, "launches": launched}
    print(f"runtime: (b) {len(plans)} injected faults: " + ", ".join(
        f"{k} {v['raised'] or 'served'} ({v['launches']} launches)" for k, v in outcomes.items())
          + "; each next call without a plan bit-identical to the clean one")

    # (c) R10's NaN-laced keys, verification on, no plan
    r10 = {}
    na_, nb_ = faults.nan_lace(a, "r10:a"), faults.nan_lace(b, "r10:b")
    nruns = faults.nan_lace(runs, "r10:runs")
    with env_vars(REPRO_GUARD_VERIFY="1"):
        for what, fn in (("ops.merge", lambda: ops.merge(na_, nb_)), ("ops.merge_k", lambda: ops.merge_k(nruns))):
            try:
                fn()
                r10[what] = None
            except VerificationError as e:
                r10[what] = type(e).__name__
    dist.init_process_group("nccl" if on_card else "gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        backend = dist.get_backend()
        cases = (("distributed_merge", lambda: D.distributed_merge(na_, nb_), None),
                 ("distributed_sort", lambda: D.distributed_sort(faults.nan_lace(xf, "r10:x"), local_sort="kernel"), None),
                 ("distributed_merge window exchange fault", lambda: D.distributed_merge(a, b),
                  "exchange:distributed_merge:0:window"),
                 ("distributed_sort exchange fault", lambda: D.distributed_sort(xf, local_sort="kernel"),
                  "exchange:distributed_sort:0"))
        for what, fn, plan in cases:
            try:
                with faults.inject(plan) if plan else contextlib.nullcontext():
                    out = fn()
                r10[what] = None
            except VerificationError as e:
                r10[what] = type(e).__name__
        sorted_out = D.distributed_sort(faults.nan_lace(xf, "r10:x"), local_sort="kernel")
        check(bool(res.keys_ordered(sorted_out[0][: int(sorted_out[1][0])])), "runtime: distributed_sort of NaN-laced keys")
        dist_costs = {}
        if on_card:  # the distributed calls always verify: the verdict's host ms a call
            for what, fn in ((f"distributed_merge window 2 x 2^{log2n} float32", lambda: D.distributed_merge(a, b)),
                             (f"distributed_sort 2^{log2n} int32", lambda: D.distributed_sort(xi, local_sort="kernel"))):
                dist_costs[what] = in_turns(lambda: call_ms(fn, iters=3), {"unguarded_ms": {"REPRO_GUARD": "0"},
                                                                           "guarded_ms": {}}, pairs=4)
    finally:
        dist.destroy_process_group()
    want_r10 = {"ops.merge": "VerificationError", "ops.merge_k": "VerificationError",
                "distributed_merge": "VerificationError", "distributed_sort": None,
                "distributed_merge window exchange fault": "VerificationError",
                "distributed_sort exchange fault": "VerificationError"}
    check(r10 == want_r10, f"runtime: R10 {r10}, want {want_r10}")
    print(f"runtime: (c) R10's NaN-laced keys with verification on: {r10} (distributed over {backend} at world "
          f"size 1, where distributed_sort is one local total-order sort: its output of NaN-laced keys is sorted "
          f"and verified)")
    for what, c in dist_costs.items():
        print(f"runtime: (c) {what} over {backend}, host ms a call: " + ", ".join(f"{k} {v:.5f}" for k, v in c.items())
              + f" ({card})")
    del na_, nb_, nruns, sorted_out

    # (d) the cost of verification, (e) the cost of the guard
    costs = {}
    if on_card:
        for what, fn, nkeys in (("ops.merge 2 x 2^%d float32" % log2n, calls["merge"][1], 2 * n),
                                ("ops.sort 2^%d int32" % log2n, calls["sort int32"][1], n)):
            out = fn()
            costs[what] = in_turns(lambda: time_ms(fn, iters=10), {"unverified_ms": {"REPRO_GUARD_VERIFY": "0"},
                                                                   "verified_ms": {"REPRO_GUARD_VERIFY": "1"}}, pairs=3)
            costs[what].update(verifier_device_ms=time_ms(lambda: res.keys_ordered(out)),
                               bound_ms=nkeys * VERIFY_BYTES_PER_KEY / HBM_BYTES_PER_S * 1e3)
        tile, leaf = ops._sort_tile(vocab, None, None)
        for what, fn, op, args, verifier in (
                (f"sampler top-k (1, {vocab})", calls["topk_batched"][1], "topk_batched", (logits,),
                 res.topk_verifier()),
                (f"routing sort {tuple(routing[:2])}", calls["sort_kv_batched (routing)"][1], "sort_kv_batched",
                 (rkeys, rslots), res.sorted_verifier())):
            costs[what] = in_turns(lambda: host_us(fn, iters=100), {"unguarded_us": {"REPRO_GUARD": "0"},
                                                                    "guarded_us": {}}, pairs=10,
                                   base={"REPRO_GUARD_VERIFY": "0"})

            def guard_only():  # the guard around a call that does nothing: its own host cost, meta included
                return ops._guard(op, args, lambda *a: a[0], keys=(0,), meta=ops._sort_meta(args[0], tile, leaf, True),
                                  verifier=verifier)

            with env_vars(REPRO_GUARD_VERIFY="0"):
                costs[what]["guard_only_us"] = host_us(guard_only, iters=5000) - host_us(lambda: args[0], iters=5000)
    del clean, calls
    for what, c in costs.items():
        print(f"runtime: ({'d' if 'verified_ms' in c else 'e'}) {what}: "
              + ", ".join(f"{k} {v:.5f}" for k, v in c.items()) + f" ({card})")

    # (f) serving with faults
    cfg = get_config("tinyllama-1.1b")
    cfg = cfg.reduced() if reduce else cfg
    params = init_params(cfg, seed=0, device=device)
    runs_out = []
    for _ in range(2):
        with use(Telemetry()) as tel, faults.inject("launch:serving.decode:1,2"):
            eng = ServingEngine(cfg, params, batch=2, max_seq=64, device=device)
            rng = np.random.default_rng(0)
            for uid in range(3):
                eng.submit(Request(uid=uid, prompt=rng.integers(1, cfg.vocab_size, 6).astype(np.int32),
                                   max_new_tokens=4, temperature=0.0))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                rep = eng.run_until_done()
            runs_out.append((rep, trace_json_bytes(tel)))
    (rep, raw), (rep2, raw2) = runs_out
    check(rep.completed == 3 and rep.retries == 2 and rep.ok(), f"runtime: serving under faults {rep}")
    check(raw == raw2, "runtime: the replayed serving trace differs")
    trace = json.loads(raw)
    check(trace_cli.check(trace, 1.05) == [], f"runtime: serving trace check {trace_cli.check(trace, 1.05)}")
    del params, eng
    print(f"runtime: (f) {cfg.name}{' (reduced)' if reduce else ' at full width'} served 3 greedy requests under "
          f"launch:serving.decode:1,2: {rep.completed} completed, {rep.retries} retries, {rep.ticks} ticks; two runs' "
          f"traces byte-identical ({len(raw)} bytes) and pass --check")

    # (g) the trace smoke in a process of its own
    if smoke:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.smoke", "--out", path]
                                 + ([] if on_card else ["--device", "cpu"]), env=env, cwd=ROOT, capture_output=True,
                                 text=True, timeout=600)
            check(run.returncode == 0, f"runtime: trace smoke failed: {run.stderr[-2000:]}")
            checked = subprocess.run([sys.executable, "-m", "repro_torch.telemetry", "--check", path], env=env,
                                     cwd=ROOT, capture_output=True, text=True, timeout=120)
            check(checked.returncode == 0, f"runtime: --check of the smoke's trace: {checked.stdout}")
        print(f"runtime: (g) {run.stdout.strip()}; {checked.stdout.strip()} ({time.perf_counter() - t0:.1f} s)")
    if on_card:
        torch.cuda.empty_cache()
    return {"faults": outcomes, "r10": r10, "costs": dict(costs, **dist_costs),
            "serving": {"completed": rep.completed, "retries": rep.retries, "ticks": rep.ticks, "trace_bytes": len(raw)}}


VLM_ARCH, AUDIO_ARCH = "paligemma-3b", "whisper-large-v3"
VLM_TEXT, VLM_NEW, VLM_TRAIN_TEXT = 8192, 16, 1792  # 256 + 8192 = 8448 positions: past FULL_ATTENTION_THRESHOLD
AUDIO_BATCH, AUDIO_PROMPT, AUDIO_CACHE, AUDIO_NEW = 4, 4, 448, 32  # 448: the real model's decoder limit
AUDIO_TRAIN = (2, 448)  # (B, decoder tokens) over the 1500 frames of each row
MODAL_STEPS = 3


def sampler_row(logits, what: str, on_card: bool) -> dict:
    """The kernel sampler's sort of one logit row ``(1, V)``: S1 and every
    K4 round against their plain versions on the same inputs, bit for bit,
    and the last round's order against ``ops.topk_batched``'s 40
    candidates.  On the card also the CUDA-event ms of S1 and the sum over
    the K4 rounds, their plain versions' and the library's (a stable
    ``torch.sort`` of S1's chunk view with the gather of the indices, and
    of each round's pair view), beside their byte bounds."""
    import torch

    from repro_torch.core.batched import _pad_rows_pow2
    from repro_torch.core.merge_path import flip_desc, max_sentinel, total_order_keys
    from repro_torch.kernels import merge_path as km
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import _narrow_chunk, _sort_tile

    n = logits.shape[1]
    tile, leaf = _sort_tile(n, None, None)
    keys = total_order_keys(flip_desc(logits))
    kp = _pad_rows_pow2(keys, max_sentinel(keys.dtype)).reshape(-1)
    vp = _pad_rows_pow2(torch.arange(n, dtype=torch.int32, device=logits.device)[None], 0).reshape(-1)
    m = kp.shape[0]
    chunk, width = _narrow_chunk(m, tile, kp.dtype)
    ref = km.sort_tiles_kv_ref(kp, vp, chunk)
    err = max(bit_err(g, r, f"S1 on {what}'s sampled row, chunk {chunk}") for g, r in
              zip(km.sort_tiles_kv(kp, vp, chunk), ref))
    kf = torch.cat([ref[0], torch.full((tile,), max_sentinel(kp.dtype), dtype=kp.dtype, device=kp.device)])
    vf = torch.cat([ref[1], torch.zeros((tile,), dtype=torch.int32, device=kp.device)])
    rounds = []
    while width < m:
        ref = km.sort_round_kv_ref(kf, vf, width, tile=tile)
        for g, r in zip(km.sort_round_kv(kf, vf, width, tile=tile, leaf=leaf), ref):
            err = max(err, bit_err(g, r, f"K4 on {what}'s sampled row, width {width}"))
        rounds.append((kf, vf, width))
        kf, vf = ref
        width *= 2
    _, idx = ops.topk_batched(logits, 40)
    check(torch.equal(idx[0], vf[:40]), f"the rounds' order differs from ops.topk_batched on {what}'s sampled row")
    key_bytes = kp.element_size()
    s1_bound = tiles_bound(m, key_bytes, values=True)
    k4_bound = sum(round_bound(m, key_bytes)["ms"] for _ in rounds)
    out = {"n": n, "m": m, "chunk": chunk, "rounds": len(rounds), "max_abs_err": err,
           "s1": {"ms": None, "plain_ms": None, "library_ms": None, "bound_ms": s1_bound["ms"], "bound_by": s1_bound["by"]},
           "k4": {"ms": None, "plain_ms": None, "library_ms": None, "bound_ms": k4_bound,
                  "bound_by": round_bound(m, key_bytes)["by"]}}
    if on_card:
        out["s1"].update(ms=time_ms(lambda: km.sort_tiles_kv(kp, vp, chunk)),
                         plain_ms=time_ms(lambda: km.sort_tiles_kv_ref(kp, vp, chunk)),
                         library_ms=time_ms(lambda: torch.gather(vp.view(-1, chunk), 1, torch.sort(
                             kp.view(-1, chunk), dim=1, stable=True).indices)))
        out["k4"].update(
            ms=sum(time_ms(lambda: km.sort_round_kv(k, v, w, tile=tile, leaf=leaf)) for k, v, w in rounds),
            plain_ms=sum(time_ms(lambda: km.sort_round_kv_ref(k, v, w, tile=tile)) for k, v, w in rounds),
            library_ms=sum(time_ms(lambda: torch.sort(k[:m].view(-1, 2 * w), dim=1, stable=True)) for k, _, w in rounds))
    return out


def gelu_reading(mlp: dict, gen, device: str, n: int = 1 << 20, rows: int = 64) -> dict:
    """ROADMAP R11 on the card: the bfloat16 gelu (``layers._act("gelu")``)
    of ``n`` draws of 3 N(0, 1), and one MLP layer (``mlp``, the model's
    own weights, on ``rows`` normal rows), on ``device`` against the same
    inputs on the CPU.  CUDA's tanh is not the CPU's, so some elements
    round the other way: the share that differs is read, and every
    difference is held within one bfloat16 ulp of the largest element."""
    import torch

    from repro_torch.models.layers import _act, mlp_apply

    mlp = {k: v.bfloat16() for k, v in mlp.items()}  # a reduced config's float32 weights too

    def held(got, want, what):
        got, want = got.float().cpu(), want.float()
        top = float(want.abs().max())
        ulp = math.ldexp(1.0, math.frexp(top)[1] - 8)
        diff = float((got - want).abs().max())
        check(diff <= ulp, f"{what} on {device} differs from the CPU by {diff:.3g}, more than one bfloat16 ulp "
                           f"({ulp:.3g}) of its largest element {top:.3g}")
        return {"share": float((got != want).float().mean()), "max_abs_err": diff, "ulp_of_max": ulp}

    x = (torch.randn(n, generator=gen, device=device) * 3).bfloat16()
    act = held(_act("gelu", None, x), _act("gelu", None, x.cpu()), "the bfloat16 gelu")
    h = torch.randn((rows, mlp["wi"].shape[0]), generator=gen, device=device).bfloat16()
    layer = held(mlp_apply(mlp, h, "gelu"), mlp_apply({k: v.cpu() for k, v in mlp.items()}, h.cpu(), "gelu"),
                 "the bfloat16 gelu MLP layer")
    return {"act": act, "layer": layer, "n": n, "rows": rows}


def phase_vlm_audio(device: str = "cuda", reduce: bool = False, card: str = "cpu", text: int = VLM_TEXT,
                    new_tokens: int = VLM_NEW, step_prompt: int = 32, vlm_train_text: int = VLM_TRAIN_TEXT,
                    audio_batch: int = AUDIO_BATCH, audio_prompt: int = AUDIO_PROMPT, audio_cache: int = AUDIO_CACHE,
                    audio_new: int = AUDIO_NEW, audio_train=AUDIO_TRAIN, steps: int = MODAL_STEPS, gelu_n: int = 1 << 20,
                    seed: int = 13) -> dict:
    """The VLM and audio families: paligemma-3b and whisper-large-v3.

    1. paligemma-3b at full width (random weights from seed 0, bfloat16),
       driven once with every count at 0: ``make_prefill_step`` of a
       ``(1, P)`` prefix (``prefix_emb``, drawn from a seed) and ``(1,
       text)`` tokens with ``cache_len = P + text + new_tokens`` (8448
       positions at full size: past ``FULL_ATTENTION_THRESHOLD``, so every
       layer runs the blockwise attention under the prefix mask), then
       ``new_tokens`` tokens sampled with top-k 40 through
       ``make_decode_step`` at positions ``P + text + i`` (S1 once and K4's
       wide rounds per token: vocab 257216 pads to 262144, 9 rounds).  S1
       and every K4 round on the last sampled row against their plain
       versions (:func:`sampler_row`); the bfloat16 gelu against the CPU
       (:func:`gelu_reading`); the prefill traced by kind; layer 0's k and
       v at the text positions after a prefill against stepping from a
       prefill of the prefix alone.  Then ``steps`` train steps of a ``(1,
       P)`` prefix and ``(1, vlm_train_text)`` tokens, labels over the
       text: finite losses, every parameter moved, ms a step and peak
       memory.
    2. whisper-large-v3 at full width (32 encoder and 32 decoder layers):
       ``forward_prefill`` of ``(audio_batch, 1500)`` frames and
       ``(audio_batch, audio_prompt)`` tokens with ``cache_len =
       audio_cache``, its ``enc_kv`` ``(32, B, 1500, 20, 64)`` twice; then
       ``audio_new`` sampled steps through ``make_decode_step(...,
       enc_kv)`` (S1 once and 7 K4 rounds per sampled step of the batch:
       51866 pads to 65536).  ``encoder_forward`` alone bit-identical to
       the prefill's ``enc_kv``; S1 and K4 on one sampled row; layer 0's
       self-attention k and v against stepping; the prefill traced by
       kind; ``steps`` train steps of ``audio_train`` tokens over 1500
       frames a row at all 64 layers.
    3. The reduced paligemma and whisper on this device against the CPU.
    With ``device="cpu"`` and ``reduce=True`` (the tests, at a small size)
    the configs are the reduced ones, the wrappers run their plain
    versions, nothing is launched, timed or traced, and every check still
    runs.  Returns the phase's numbers.
    """
    import torch

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLMPipeline
    from repro_torch.kernels import WRAPPERS, reset_launches
    from repro_torch.kernels.tune import pick
    from repro_torch.models import encoder_forward, forward_prefill, init_params
    from repro_torch.models.attention import FULL_ATTENTION_THRESHOLD
    from repro_torch.models.transformer import _dtype
    from repro_torch.serving import topk_sample
    from repro_torch.train import init_train_state, make_decode_step, make_prefill_step, make_train_step
    from repro_torch.train.smoke import leaf_report
    from repro_torch.train.steps import _cast

    on_card = device == "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sgen = torch.Generator(device=device)
    sgen.manual_seed(seed)
    tcfg = TrainConfig(z_loss=1e-4, grad_clip=1.0)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def config(arch):
        base = get_config(arch)
        return base.reduced() if reduce else base

    def counts():
        return {fn.__name__: fn.launches for fn in WRAPPERS}

    def want(**kw):
        out = dict.fromkeys((fn.__name__ for fn in WRAPPERS), 0)
        if on_card:
            out.update(kw)
        return out

    def peak_gb():
        return f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB" if on_card else "not measured"

    def free():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def weights(cfg):
        t0 = time.perf_counter()
        params = _cast(init_params(cfg, seed=0, device=device), _dtype(cfg))  # once, as the engine does
        sync()
        n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        print(f"vlm_audio: {cfg.name} ({cfg.num_layers} layers" + (f" + {cfg.encoder_layers} encoder layers"
              if cfg.encoder_layers else "") + f", d={cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} kv of "
              f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}), {cfg.n_params() / 1e9:.3f} "
              f"B parameters, {n_bytes / 1e9:.3f} GB of weights from seed 0 in {time.perf_counter() - t0:.2f} s")
        return params

    def serve(cfg, params, batch, cache_len, start, n_new, prefill, decode):
        """Prefill ``batch`` (no launch), then sample ``n_new`` steps from
        ``start`` (S1 once and K4's wide rounds each), with every count at
        0 before: ``(launches, prefill s, decode s, ids, logits, caches,
        enc_kv, K4 rounds a step)``."""
        free()
        reset_launches()
        sync()
        t0 = time.perf_counter()
        logits, caches, enc_kv = prefill(params, batch, cache_len)
        sync()
        prefill_s = time.perf_counter() - t0
        prefill_launches = counts()
        bsz = logits.shape[0]
        sampled = [topk_sample(logits, sgen, k=40, temperature=0.8, backend="kernel")]
        sync()
        t0 = time.perf_counter()
        for i in range(n_new - 1):
            logits, caches = decode(params, caches, sampled[-1][:, None], torch.full((bsz,), start + i, device=device),
                                    enc_kv)
            sampled.append(topk_sample(logits, sgen, k=40, temperature=0.8, backend="kernel"))
        sync()
        decode_s = time.perf_counter() - t0
        launches = counts()
        ids = torch.stack(sampled)
        check(bool(((ids >= 0) & (ids < cfg.vocab_size)).all()), f"{cfg.name} sampled ids {ids.tolist()}")
        check(bool(torch.isfinite(logits.float()).all()), f"{cfg.name} decode logits not finite")
        for name, t in caches["sub0"].items():
            check(tuple(t.shape[1:3]) == (bsz, cache_len) and bool(torch.isfinite(t.float()).all()),
                  f"{cfg.name} cache {name} {tuple(t.shape)} not finite or not ({bsz}, {cache_len})")
        k4_rounds = wide_rounds(cfg.vocab_size, pick(cfg.vocab_size)[0])
        check(prefill_launches == want(), f"{cfg.name} prefill launched {prefill_launches}")
        expect = want(sort_round_kv=n_new * k4_rounds, sort_tiles_kv=n_new)
        check(launches == expect, f"{cfg.name} serving path launched {launches}, want {expect}")
        return launches, prefill_s, decode_s, ids, logits, caches, enc_kv, k4_rounds

    def train(cfg, batches, what):
        free()
        t0 = time.perf_counter()
        state = init_train_state(cfg, tcfg, seed=0, device=device)
        state["step"].fill_(1)
        sync()
        n_params = sum(t.numel() for t in _leaves(state["params"]))
        init_s = time.perf_counter() - t0
        before = _fingerprints(state["params"])
        step_fn = make_train_step(cfg, tcfg)
        losses, step_ms = [], []
        reset_launches()
        for i, batch in enumerate(batches):
            if on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            state, m = step_fn(state, batch)
            if on_card:
                ev[1].record()
                ev[1].synchronize()
                step_ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(m["loss"]))
            check(math.isfinite(losses[-1]) and math.isfinite(float(m["grad_norm"])),
                  f"{cfg.name} step {i + 1}: loss {losses[-1]}, grad norm {float(m['grad_norm'])}")
        check(counts() == want(), f"{cfg.name} training launched {counts()}")
        after = _fingerprints(state["params"])
        still = [name for (name, _, _), a, b in zip(leaf_report(state["params"]), before, after) if torch.equal(a, b)]
        check(not still, f"{cfg.name} parameters did not move: {still}")
        ms = sum(step_ms[1:]) / max(1, len(step_ms) - 1) if on_card else None
        peak = peak_gb()
        print(f"vlm_audio: {cfg.name} {len(batches)} train steps of {what} at all {cfg.num_layers}"
              + (f" + {cfg.encoder_layers}" if cfg.encoder_layers else "") + f" layers ({n_params / 1e9:.3f} B "
              f"parameters, float32 masters and moments made in {init_s:.2f} s): losses {[round(x, 5) for x in losses]}"
              + (f"; step ms (CUDA events) {[round(x, 3) for x in step_ms]}, {ms:.3f} ms per step after the first; "
                 f"peak memory {peak}" if on_card else "; times and peak memory not measured (CPU)") + "; every "
              "parameter moved; no kernel launched")
        if on_card:  # more steps traced: device busy and idle share, time by kind and by autograd node
            from repro_torch.launch.profile import profile_train_step, report_train

            print(f"vlm_audio: {cfg.name} train step of {what} traced ({card}):")
            report_train(profile_train_step(cfg, tcfg, state, batches[0]))
        del state
        free()
        return {"ms": ms, "peak": peak, "losses": losses}

    out = {"card": card}

    # 1. paligemma: a prefix of patch embeddings, prefilled past the threshold, sampled, trained
    cfg = config(VLM_ARCH)
    params = weights(cfg)
    p = cfg.num_prefix_tokens
    prefix = modal_inputs(cfg, 1, gen, device)
    tokens = torch.randint(1, cfg.vocab_size, (1, text), generator=gen, device=device)
    batch = {"tokens": tokens, **prefix}
    cache_len = p + text + new_tokens
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)

    def vlm_prefill(params, batch, cache_len):
        return prefill(params, batch, cache_len) + (None,)

    launches, prefill_s, decode_s, ids, logits, caches, _, rounds = serve(
        cfg, params, batch, cache_len, p + text, new_tokens, vlm_prefill, decode)
    blockwise = p + text > FULL_ATTENTION_THRESHOLD
    print(f"vlm_audio: paligemma prefill of a (1, {p}) prefix and (1, {text}) tokens, {p + text} positions "
          f"({'blockwise' if blockwise else 'dense'} attention under the prefix mask, chunk {cfg.attn_chunk}), "
          f"cache_len {cache_len}, in {prefill_s * 1e3:.1f} ms (the first call; no kernel launched); {new_tokens} "
          f"tokens sampled (top-k 40), {new_tokens - 1} decode steps in {decode_s * 1e3:.1f} ms "
          f"({decode_s * 1e3 / max(1, new_tokens - 1):.2f} ms per step with its sample); K4 launched "
          f"{launches['sort_round_kv']} times ({rounds} wide rounds per token), S1 {launches['sort_tiles_kv']}; peak "
          f"memory {peak_gb()}; ids {ids[:, 0].tolist()} ({card})")
    row = sampler_row(logits, "paligemma", on_card)
    gelu = gelu_reading({k: v[0] for k, v in params["layers"]["mlp"].items()}, gen, device, n=gelu_n)
    print(f"vlm_audio: R11, the bfloat16 gelu on {device} against the CPU: {gelu['act']['share']:.6f} of {gelu_n} "
          f"elements differ (max abs err {gelu['act']['max_abs_err']:.3g}, one ulp of the largest "
          f"{gelu['act']['ulp_of_max']:.3g}); paligemma's layer 0 MLP on ({gelu['rows']}, {cfg.d_model}) rows: "
          f"{gelu['layer']['share']:.6f} differ, max abs err {gelu['layer']['max_abs_err']:.3g} (one ulp of the "
          f"largest {gelu['layer']['ulp_of_max']:.3g})")
    out["paligemma"] = {"prefill_ms": prefill_s * 1e3, "decode_step_ms": decode_s * 1e3 / max(1, new_tokens - 1),
                        "positions": p + text, "blockwise": blockwise, "sampled": new_tokens,
                        "k4_launches": launches["sort_round_kv"], "s1_launches": launches["sort_tiles_kv"],
                        "k4_per_token": rounds, "row": row, "gelu": gelu}
    if on_card:
        from repro_torch.launch.profile import profile_prefill, report_prefill

        report_prefill(f"vlm_audio: paligemma prefill ({p} + {text}) traced ({card})",
                       profile_prefill(prefill, params, batch, cache_len))
    del caches, logits
    print("vlm_audio: paligemma " + _prefill_against_stepping(cfg, params, prefill, decode, tokens[:, :step_prompt],
                                                               device, extra=prefix))
    del params
    free()
    pipe = SyntheticLMPipeline(cfg, 1, vlm_train_text, PipelineConfig(seed=0))
    batches = [{**{k: torch.as_tensor(v, device=device) for k, v in pipe.batch_at(i).items()},
                **modal_inputs(cfg, 1, gen, device)} for i in range(1, steps + 1)]
    out["paligemma"]["train"] = train(cfg, batches, f"a (1, {p}) prefix and (1, {vlm_train_text}) tokens")
    del batches

    # 2. whisper: the encoder over 1500 frames, cross-attention in every decoder step, trained at all 64 layers
    acfg = config(AUDIO_ARCH)
    params = weights(acfg)
    frames = modal_inputs(acfg, audio_batch, gen, device)
    prompts = torch.randint(1, acfg.vocab_size, (audio_batch, audio_prompt), generator=gen, device=device)
    aprefill, adecode = make_prefill_step(acfg), make_decode_step(acfg)
    launches, prefill_s, decode_s, ids, logits, caches, enc_kv, rounds = serve(
        acfg, params, {"tokens": prompts, **frames}, audio_cache, audio_prompt, audio_new,
        lambda p_, b, c: forward_prefill(acfg, p_, b, c), adecode)
    kv_shape = (acfg.num_layers, audio_batch, acfg.encoder_seq, acfg.num_kv_heads, acfg.resolved_head_dim)
    check(all(tuple(t.shape) == kv_shape and bool(torch.isfinite(t.float()).all()) for t in enc_kv),
          f"whisper enc_kv {[tuple(t.shape) for t in enc_kv]}, want {kv_shape}, finite")
    alone = encoder_forward(acfg, params, frames["frames"])
    check(all(torch.equal(a, b) for a, b in zip(alone, enc_kv)), "encoder_forward differs from the prefill's enc_kv")
    kv_gb = sum(t.numel() * t.element_size() for t in enc_kv) / 1e9
    print(f"vlm_audio: whisper forward_prefill of ({audio_batch}, {acfg.encoder_seq}) frames and ({audio_batch}, "
          f"{audio_prompt}) tokens, cache_len {audio_cache}, in {prefill_s * 1e3:.1f} ms (the first call; no kernel "
          f"launched); enc_kv 2 x {kv_shape} ({kv_gb:.3f} GB), encoder_forward alone bit-identical; {audio_new} "
          f"sampled steps of the batch (top-k 40), {audio_new - 1} decode steps with cross-attention in "
          f"{decode_s * 1e3:.1f} ms ({decode_s * 1e3 / max(1, audio_new - 1):.2f} ms per step with its sample); K4 "
          f"launched {launches['sort_round_kv']} times ({rounds} wide rounds per sampled step of {audio_batch} rows), "
          f"S1 {launches['sort_tiles_kv']} (one per step); peak memory {peak_gb()}; first row's ids "
          f"{ids[:, 0].tolist()} ({card})")
    arow = sampler_row(logits[:1], "whisper", on_card)
    out["whisper"] = {"prefill_ms": prefill_s * 1e3, "decode_step_ms": decode_s * 1e3 / max(1, audio_new - 1),
                      "batch": audio_batch, "sampled_steps": audio_new, "k4_launches": launches["sort_round_kv"],
                      "s1_launches": launches["sort_tiles_kv"], "k4_per_step": rounds, "enc_kv_gb": kv_gb,
                      "row": arow}
    if on_card:
        from repro_torch.launch.profile import profile_prefill, report_prefill

        report_prefill(f"vlm_audio: whisper prefill ({audio_batch}, {acfg.encoder_seq}) frames traced ({card})",
                       profile_prefill(aprefill, params, {"tokens": prompts, **frames}, audio_cache))
    del caches, logits, enc_kv, alone
    one = {"frames": frames["frames"][:1]}
    stokens = torch.randint(1, acfg.vocab_size, (1, step_prompt), generator=gen, device=device)
    print("vlm_audio: whisper " + _prefill_against_stepping(acfg, params, aprefill, adecode, stokens, device,
                                                             extra=one, enc_kv=encoder_forward(acfg, params,
                                                                                               one["frames"])))
    del params
    free()
    bsz, seq = audio_train
    pipe = SyntheticLMPipeline(acfg, bsz, seq, PipelineConfig(seed=0))
    batches = [{**{k: torch.as_tensor(v, device=device) for k, v in pipe.batch_at(i).items()},
                **modal_inputs(acfg, bsz, gen, device)} for i in range(1, steps + 1)]
    out["whisper"]["train"] = train(acfg, batches, f"({bsz}, {acfg.encoder_seq}) frames and ({bsz}, {seq}) tokens")
    del batches

    # 3. the reduced configs on this device against the CPU
    for arch in (VLM_ARCH, AUDIO_ARCH):
        reduced_against_cpu(device, arch)
    for name in ("paligemma", "whisper"):
        r = out[name]["row"]
        print(f"vlm_audio: S1 and K4 on {name}'s sampled row ({r['n']} pads to {r['m']}; S1 at chunk {r['chunk']}, "
              f"{r['rounds']} K4 rounds) bit-identical to their plain versions"
              + ("" if not on_card else f"; S1 kernel_ms {r['s1']['ms']:.5f} plain_ms {r['s1']['plain_ms']:.5f} "
                 f"library_ms {r['s1']['library_ms']:.5f} bound_ms {r['s1']['bound_ms']:.6f}; K4 rounds kernel_ms "
                 f"{r['k4']['ms']:.5f} plain_ms {r['k4']['plain_ms']:.5f} library_ms {r['k4']['library_ms']:.5f} "
                 f"bound_ms {r['k4']['bound_ms']:.6f} (CUDA events)"))
    return out


PAR_ARCH, PAR_LAYERS = "nemotron-4-340b", 2  # full width, 2 of 96 layers: 32.7 GB of bfloat16 weights
PAR_PROMPT, PAR_NEW, PAR_STEP_PROMPT = 4096, 16, 32
COMP_ARCH, COMP_SEQ, COMP_STEPS, COMP_FRAC = "tinyllama-1.1b", 4096, 3, 0.01
CP_LEN, CP_SHARDS, CP_INVALID = 524288, 8, 5  # long_500k's cache, 8 shards, the last 1/5 of the positions invalid
CP_F32_RTOL = 1e-5  # float32 cache: the sums in another order, of max |out|
# bfloat16 cache, of max |out|: the scores, p and the weighted values round to bfloat16 (einsums in the cache's dtype, as
# the reference's body), and the output, an average over 419430 valid keys, is small (about 0.01)
CP_BF16_RTOL = 2.0 ** -5
DRY_CELL, DRY_FALLBACK, DRY_LIMIT_S = ("nemotron-4-340b", "train_4k"), ("tinyllama-1.1b", "train_4k"), 120.0
# a cell whose step stops on an operation without a sharding rule in this torch's DTensor (torch 2.11 has none for
# the vocab-parallel embedding's gradient) is reported, and this one is taken for the roofline terms
DRY_RULES_FALLBACK = ("nemotron-4-340b", "prefill_32k")


def combine_stacked(m, l, o):
    """``combine_partials``' online-softmax combine with the exchange
    emulated on one device: the max and the two sums over the stacked
    first axis (one entry per shard) in place of the all-reduces."""
    import torch

    m_glob = m.amax(0)
    scale = torch.exp(m - m_glob)
    return (o * scale[..., None]).sum(0) / torch.clamp((l * scale).sum(0)[..., None], min=1e-30)


def dense_decode_attention(q, k, v, valid):
    """Float32 attention of one query ``(B, K, G, hd)`` over a whole cache
    ``(B, S, K, hd)``: the yardstick of the context-parallel forms."""
    import torch

    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k.float()) / math.sqrt(q.shape[-1])
    p = torch.softmax(torch.where(valid[:, None, None, :], s, -1e30), dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", p, v.float())


def dry_run_record(proc, path: str, cell) -> dict:
    """Wait for :func:`dry_run_cell`'s process and return its record: ``ok``,
    or ``error`` with the operation it stopped on; anything else raises."""
    import os

    stdout, stderr = proc.communicate(timeout=900)
    record = None
    if os.path.exists(path):
        with open(path) as f:
            record = json.load(f)
    check(record is not None and (record["status"] == "ok" and proc.returncode == 0
                                  or record["status"] == "error" and proc.returncode == 1),
          f"dry run {cell} exited {proc.returncode}: " + (str(record)[:1500] if record else stdout[-1500:] + stderr[-1500:]))
    return record


def dry_run_cell(arch: str, shape: str, out_dir: str):
    """Start one dry-run cell (``python -m repro_torch.launch.dryrun``) in a
    process of its own, which touches no card: ``(process, record path,
    start time)``."""
    import os

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import cell_filename

    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--out", out_dir]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, os.path.join(out_dir, cell_filename(get_config(arch).name, shape, False)), time.perf_counter()


def phase_parallel(device: str = "cuda", reduce: bool = False, card: str = "cpu", layers: int = PAR_LAYERS,
                   prompt: int = PAR_PROMPT, new_tokens: int = PAR_NEW, step_prompt: int = PAR_STEP_PROMPT,
                   comp_seq: int = COMP_SEQ, steps: int = COMP_STEPS, cp_len: int = CP_LEN, cp_shards: int = CP_SHARDS,
                   dry=DRY_CELL, seed: int = 19) -> dict:
    """The parallel layer and the dry run.

    1. nemotron-4-340b at full width cut to ``layers`` of 96 layers (random
       weights from seed 0, bfloat16; the squared-ReLU MLP), driven once with
       every count at 0: ``make_prefill_step`` of ``(1, prompt)``, then
       ``new_tokens`` tokens sampled with top-k 40 through
       ``make_decode_step`` (vocab 256000 pads to 262144: S1 once and 9 K4
       rounds per token, read per token).  S1 and every K4 round on the last
       sampled row against their plain versions (:func:`sampler_row`);
       layer 0's k and v after a prefill of ``step_prompt`` tokens against
       stepping; the reduced nemotron on this device against the CPU.
    2. tinyllama-1.1b at full width trained ``steps`` steps of ``(1,
       comp_seq)`` with ``grad_compression="none"``, then ``"topk"`` (frac
       0.01) and ``"int8"``, each carrying its ``err`` (no kernel
       launches).  ``compress_grads`` on this device against the CPU on the
       same gradient tree and error state, bit for bit for both methods:
       every leaf, the small ones (the stacked norms, ``final_norm``) on the
       merge-path top-k, the others on the quantile threshold.
    3. Context-parallel decode attention at tinyllama's head layout (K = 4,
       G = 8, hd = 64), batch 1, over a cache of ``cp_len`` positions whose
       last fifth is invalid, bfloat16 and float32: ``local_partial_attention``
       on ``cp_shards`` shards with the combine emulated on the device
       (:func:`combine_stacked`), and ``context_parallel_decode_attention``
       over a process group of one rank (NCCL on the card, gloo on the CPU),
       both against dense float32 attention over the whole cache.
    4. One dry-run cell (``dry``, ``(arch, shape)`` on the single-pod mesh)
       in a process of its own, started first so it runs beside the rest;
       if it takes more than 120 s, tinyllama-1.1b's ``train_4k`` instead.
    With ``device="cpu"`` and ``reduce=True`` (the tests, at a small size)
    the configs are the reduced ones, the wrappers run their plain
    versions, nothing is launched or timed, and every check runs but the
    card against the CPU.
    Returns the phase's numbers.
    """
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLMPipeline
    from repro_torch.kernels import WRAPPERS, reset_launches
    from repro_torch.kernels.tune import pick
    from repro_torch.models import init_params
    from repro_torch.models.transformer import _dtype
    from repro_torch.parallel.compression import compress_grads
    from repro_torch.serving import topk_sample
    from repro_torch.serving.context_parallel import context_parallel_decode_attention, local_partial_attention
    from repro_torch.train import init_train_state, make_decode_step, make_prefill_step, make_train_step
    from repro_torch.train.steps import _cast, loss_and_grads

    on_card = device == "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sgen = torch.Generator(device=device)
    sgen.manual_seed(seed)
    out = {"card": card}
    tmp = tempfile.TemporaryDirectory()
    dry_proc = dry_run_cell(*dry, tmp.name) if dry else None

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def counts():
        return {fn.__name__: fn.launches for fn in WRAPPERS}

    def want(**kw):
        res = dict.fromkeys((fn.__name__ for fn in WRAPPERS), 0)
        if on_card:
            res.update(kw)
        return res

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    def free():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    # 1. nemotron: prefill, sampling on S1 and K4, the sampled row, prefill against stepping
    base = get_config(PAR_ARCH)
    cfg = base.reduced() if reduce else dataclasses.replace(base, num_layers=layers)
    free()
    t0 = time.perf_counter()
    params = _cast(init_params(cfg, seed=0, device=device), _dtype(cfg))
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"parallel: {cfg.name} cut to {cfg.num_layers} of {base.num_layers} layers (d={cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv of {cfg.resolved_head_dim}, d_ff {cfg.d_ff} ({cfg.act}), "
          f"vocab {cfg.vocab_size}, {cfg.dtype}): {n_bytes / 1e9:.3f} GB of weights from seed 0 in "
          f"{time.perf_counter() - t0:.2f} s")
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    tokens = torch.randint(1, cfg.vocab_size, (1, prompt), generator=gen, device=device)
    cache_len = prompt + new_tokens
    reset_launches()
    sync()
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": tokens}, cache_len)
    sync()
    prefill_s = time.perf_counter() - t0
    prefill_launches = counts()
    sampled = [topk_sample(logits, sgen, k=40, temperature=0.8, backend="kernel")]
    per_token = [counts()]
    sync()
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        logits, caches = decode(params, caches, sampled[-1][:, None], torch.full((1,), prompt + i, device=device))
        sampled.append(topk_sample(logits, sgen, k=40, temperature=0.8, backend="kernel"))
        per_token.append(counts())
    sync()
    decode_s = time.perf_counter() - t0
    launches = counts()
    ids = torch.stack(sampled)
    rounds = wide_rounds(cfg.vocab_size, pick(cfg.vocab_size)[0])
    check(bool(((ids >= 0) & (ids < cfg.vocab_size)).all()), f"{cfg.name} sampled ids {ids.tolist()}")
    check(bool(torch.isfinite(logits.float()).all()), f"{cfg.name} decode logits not finite")
    for name, t in caches["sub0"].items():
        check(tuple(t.shape[1:3]) == (1, cache_len) and bool(torch.isfinite(t.float()).all()),
              f"{cfg.name} cache {name} {tuple(t.shape)} not finite or not (1, {cache_len})")
    check(prefill_launches == want(), f"{cfg.name} prefill launched {prefill_launches}")
    steps_k4 = [b["sort_round_kv"] - a["sort_round_kv"] for a, b in zip([prefill_launches] + per_token, per_token)]
    steps_s1 = [b["sort_tiles_kv"] - a["sort_tiles_kv"] for a, b in zip([prefill_launches] + per_token, per_token)]
    check(launches == want(sort_round_kv=new_tokens * rounds, sort_tiles_kv=new_tokens),
          f"{cfg.name} serving path launched {launches}")
    if on_card:
        check(steps_k4 == [rounds] * new_tokens and steps_s1 == [1] * new_tokens,
              f"{cfg.name} K4 and S1 launches per token {steps_k4}, {steps_s1}, want {rounds} and 1 each")
    peak = peak_gb()
    print(f"parallel: {cfg.name} prefill of (1, {prompt}) (dense attention) in {prefill_s * 1e3:.1f} ms (the first "
          f"call; no kernel launched); {new_tokens} tokens sampled (top-k 40), {new_tokens - 1} decode steps in "
          f"{decode_s * 1e3:.1f} ms ({decode_s * 1e3 / max(1, new_tokens - 1):.2f} ms per step with its sample); K4 "
          f"launches per token {steps_k4}, S1 {steps_s1} ({rounds} wide rounds of {cfg.vocab_size} padded to a power "
          f"of two); peak memory " + (f"{peak:.2f} GB" if on_card else "not measured") + f"; ids {ids[:, 0].tolist()} "
          f"({card})")
    row = sampler_row(logits, "nemotron", on_card)
    out["nemotron"] = {"layers": cfg.num_layers, "weights_gb": n_bytes / 1e9, "prefill_ms": prefill_s * 1e3,
                       "decode_step_ms": decode_s * 1e3 / max(1, new_tokens - 1), "sampled": new_tokens,
                       "k4_launches": launches["sort_round_kv"], "s1_launches": launches["sort_tiles_kv"],
                       "k4_per_token": steps_k4, "s1_per_token": steps_s1, "peak_gb": peak, "row": row}
    del caches, logits
    print("parallel: nemotron " + _prefill_against_stepping(cfg, params, prefill, decode,
                                                             tokens[:, :step_prompt], device))
    del params
    free()
    reduced_against_cpu(device, PAR_ARCH)

    # 2. tinyllama trained with gradient compression; compress_grads on the card against the CPU
    ccfg = get_config(COMP_ARCH)
    ccfg = ccfg.reduced() if reduce else ccfg
    pipe = SyntheticLMPipeline(ccfg, 1, comp_seq, PipelineConfig(seed=0))
    batches = [{k: torch.as_tensor(v, device=device) for k, v in pipe.batch_at(i).items()} for i in range(steps)]
    out["compression"] = {}
    for method in ("none", "topk", "int8"):
        free()
        tcfg = TrainConfig(z_loss=1e-4, grad_clip=1.0, grad_compression=method, compression_topk=COMP_FRAC)
        state = init_train_state(ccfg, tcfg, seed=0, device=device)
        state["step"].fill_(1)
        step_fn = make_train_step(ccfg, tcfg)
        losses, step_ms = [], []
        reset_launches()
        for i, batch in enumerate(batches):
            if on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            state, m = step_fn(state, batch)
            if on_card:
                ev[1].record()
                ev[1].synchronize()
                step_ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(m["loss"]))
            check(math.isfinite(losses[-1]) and math.isfinite(float(m["grad_norm"])),
                  f"{ccfg.name} {method} step {i + 1}: loss {losses[-1]}, grad norm {float(m['grad_norm'])}")
        check(counts() == want(), f"{ccfg.name} {method} training launched {counts()}")
        rec = {"losses": losses, "step_ms": step_ms,
               "ms": sum(step_ms[1:]) / max(1, len(step_ms) - 1) if on_card else None, "peak_gb": peak_gb()}
        if method != "none":
            err = state["err"]
            nonzero = sum(int((t != 0).any()) for t in _leaves(err))
            check(set(state) == {"step", "params", "opt", "err"} and nonzero > 0,
                  f"{ccfg.name} {method}: the error state {sorted(state)} carries nothing")
            sizes = [t.numel() for t in _leaves(err)]
            rec.update(err_leaves_nonzero=nonzero, leaves=len(sizes), small_leaves=sum(n <= 65536 for n in sizes),
                       elements=sum(sizes))
            if on_card:  # the card's compress_grads against the CPU's on the same gradients and error state
                _, _, grads = loss_and_grads(ccfg, tcfg, state["params"], batches[0])
                t0 = time.perf_counter()
                got = compress_grads(grads, err, method, COMP_FRAC)
                sync()
                dev_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                ref = compress_grads(_to(grads, "cpu"), _to(err, "cpu"), method, COMP_FRAC)
                cpu_s = time.perf_counter() - t0
                leaves, differ = 0, []
                for part, (g_tree, r_tree) in zip(("compressed", "error"), zip(got, ref)):
                    for (name, g), r in zip(_named_leaves(g_tree), _leaves(r_tree)):
                        leaves += 1
                        if not torch.equal(g.cpu().view(torch.int32), r.view(torch.int32)):
                            differ.append(f"{part} {name}")
                check(not differ, f"{method} compress_grads on {device} differs from the CPU: {differ[:6]}")
                rec.update(compress_s=dev_s, compress_cpu_s=cpu_s)
                print(f"parallel: {method} compress_grads of {ccfg.name}'s gradient tree ({len(sizes)} leaves, "
                      f"{sum(sizes) / 1e9:.3f} B elements; {rec['small_leaves']} of at most 65536 on the merge-path "
                      f"top-k) with the error state of its {steps} steps on {device} bit-identical to the CPU "
                      f"({leaves} outputs); {dev_s * 1e3:.1f} ms on {device}, {cpu_s:.2f} s on the CPU (host clock)")
                del grads, got, ref
            del err
        out["compression"][method] = rec
        print(f"parallel: {ccfg.name} {steps} train steps of (1, {comp_seq}) with grad_compression={method!r}: "
              f"losses {[round(x, 5) for x in losses]}" + (f"; step ms (CUDA events) {[round(x, 3) for x in step_ms]}"
              f", {rec['ms']:.3f} after the first; peak memory {rec['peak_gb']:.2f} GB" if on_card else "")
              + "; no kernel launched")
        del state
    free()

    # 3. context-parallel decode attention over a long cache: P shards emulated, and one rank over a process group
    b, kh, g, hd = 1, ccfg.num_kv_heads, ccfg.num_heads // ccfg.num_kv_heads, ccfg.resolved_head_dim
    valid = (torch.arange(cp_len, device=device) < cp_len - cp_len // CP_INVALID)[None].expand(b, cp_len)
    out["context_parallel"] = {"positions": cp_len, "shards": cp_shards, "heads": [kh, g, hd]}
    port = free_port()
    dist.init_process_group("nccl" if on_card else "gloo", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        for dtype, rtol in ((torch.bfloat16, CP_BF16_RTOL), (torch.float32, CP_F32_RTOL)):
            q = torch.randn((b, kh, g, hd), generator=gen, device=device).to(dtype)
            k = torch.randn((b, cp_len, kh, hd), generator=gen, device=device).to(dtype)
            v = torch.randn((b, cp_len, kh, hd), generator=gen, device=device).to(dtype)
            n = cp_len // cp_shards

            def sharded():
                parts = [local_partial_attention(q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n],
                                                 valid[:, i * n:(i + 1) * n]) for i in range(cp_shards)]
                return combine_stacked(*(torch.stack(t) for t in zip(*parts)))

            dense = dense_decode_attention(q, k, v, valid)
            top = float(dense.abs().max())
            errs = {"sharded": float((sharded() - dense).abs().max()),
                    "group_of_one": float((context_parallel_decode_attention(q, k, v, valid) - dense).abs().max())}
            for form, e in errs.items():
                check(e <= rtol * top, f"context-parallel decode ({form}, {dtype}) differs from dense attention by "
                                       f"{e:.3g}, more than {rtol:.3g} of max |out| {top:.3g}")
            rec = {"max_abs_err": errs, "max_abs_out": top, "rtol_of_max": rtol}
            if on_card:  # the dense form: the same decode math over the whole cache as one shard
                rec.update(dense_ms=time_ms(lambda: combine_stacked(*(t[None] for t in local_partial_attention(
                    q, k, v, valid))), iters=5), sharded_ms=time_ms(sharded, iters=5))
            out["context_parallel"][str(dtype).split(".")[-1]] = rec
            print(f"parallel: context-parallel decode attention, (1, {cp_len}) {str(dtype).split('.')[-1]} cache "
                  f"(K={kh}, G={g}, hd={hd}; the last {cp_len // CP_INVALID} positions invalid): {cp_shards} shards "
                  f"combined on the device within {errs['sharded']:.3g}, one rank over {dist.get_backend()} within "
                  f"{errs['group_of_one']:.3g} of dense float32 attention (tolerance {rtol:.3g} of max |out| "
                  f"{top:.3g})" + (f"; dense {rec['dense_ms']:.4f} ms, sharded {rec['sharded_ms']:.4f} ms (CUDA "
                                   f"events; dense: one shard of the whole cache)" if on_card else ""))
            del q, k, v
    finally:
        dist.destroy_process_group()

    # 4. the dry-run cell, which ran beside the rest
    if dry_proc is not None:
        proc, path, t0 = dry_proc
        record = dry_run_record(proc, path, dry)
        wall = time.perf_counter() - t0
        cell = dry
        if record["status"] == "error":
            check(record.get("error", "").startswith(("RuntimeError", "NotImplementedError", "AssertionError")),
                  f"dry run {dry}: {record.get('error', '')[:1500]}")
            out["dryrun_stopped"] = {"cell": list(dry), "op": record.get("op"), "torch": torch.__version__,
                                     "error": record["error"][:300], "wall_s": wall}
            print(f"parallel: dry run {dry[0]} x {dry[1]} stopped after {wall:.1f} s on an operation this torch's "
                  f"DTensor ({torch.__version__}) has no sharding rule for: {record['error'][:200]}; "
                  f"{DRY_RULES_FALLBACK} instead")
            proc, path, t0 = dry_run_cell(*DRY_RULES_FALLBACK, tmp.name)
            record = dry_run_record(proc, path, DRY_RULES_FALLBACK)
            wall = time.perf_counter() - t0
            cell = DRY_RULES_FALLBACK
            check(record["status"] == "ok", f"dry run {cell}: {record.get('error', '')[:1500]}")
        if wall > DRY_LIMIT_S:
            print(f"parallel: dry run of {cell} took {wall:.1f} s, past {DRY_LIMIT_S:.0f} s: {DRY_FALLBACK} instead")
            proc, path, t0 = dry_run_cell(*DRY_FALLBACK, tmp.name)
            record = dry_run_record(proc, path, DRY_FALLBACK)
            wall = time.perf_counter() - t0
            cell = DRY_FALLBACK
            check(record["status"] == "ok", f"dry run {cell}: {record.get('error', '')[:1500]}")
        r = record["roofline"]
        out["dryrun"] = {"cell": list(cell), "wall_s": wall, "step_s": record["step_s"], "chips": record["chips"],
                         "memory_analysis": record["memory_analysis"],
                         "roofline": {k: r[k] for k in ("flops_per_device", "bytes_per_device", "wire_bytes_per_device",
                                                        "t_compute_s", "t_memory_s", "t_collective_s", "t_step_s",
                                                        "bottleneck", "useful_flops_fraction", "mfu_bound",
                                                        "model_flops")}}
        print(f"parallel: dry run {cell[0]} x {cell[1]} on the single-pod mesh ({record['chips']} fake ranks, meta "
              f"DTensors, no card) in {wall:.1f} s (the step {record['step_s']} s): flops/dev {r['flops_per_device']:.4g}, "
              f"bytes/dev {r['bytes_per_device']:.4g}, wire/dev {r['wire_bytes_per_device']:.4g}; t_compute "
              f"{r['t_compute_s'] * 1e3:.2f} ms, t_memory {r['t_memory_s'] * 1e3:.2f} ms, t_collective "
              f"{r['t_collective_s'] * 1e3:.2f} ms on H100 constants: {r['bottleneck']}-bound, MFU bound "
              f"{r['mfu_bound']:.4f}")
    tmp.cleanup()
    r = out["nemotron"]["row"]
    print(f"parallel: S1 and K4 on nemotron's sampled row ({r['n']} pads to {r['m']}; S1 at chunk {r['chunk']}, "
          f"{r['rounds']} K4 rounds) bit-identical to their plain versions"
          + ("" if not on_card else f"; S1 kernel_ms {r['s1']['ms']:.5f} plain_ms {r['s1']['plain_ms']:.5f} "
             f"library_ms {r['s1']['library_ms']:.5f} bound_ms {r['s1']['bound_ms']:.6f}; K4 rounds kernel_ms "
             f"{r['k4']['ms']:.5f} plain_ms {r['k4']['plain_ms']:.5f} library_ms {r['k4']['library_ms']:.5f} "
             f"bound_ms {r['k4']['bound_ms']:.6f} (CUDA events)"))
    return out


TUNE_SIZES = (1 << 12, 1 << 15, 1 << 18)  # tune.build_table's grid, the reference's
TUNE_N = 1 << 24  # the sort the phases above time
TUNE_ITERS = 10  # timed calls a candidate, after one warm-up


def _plain_of(call) -> tuple:
    """A wrapper call's plain version on the same inputs, as a tuple."""
    kernel, args, kwargs = call.launch.kernel, call.args, call.kwargs
    if kernel.startswith("sort_round"):
        out = call.ref(*args, tile=kwargs["tile"])
    elif kernel == "ssm_scan":  # _forward(dt, x, bmat, cmat, a, chunk, checkpoints)
        out = call.ref(*args[:5], chunk=args[5], checkpoints=args[6])
    elif kernel == "ssm_scan_bwd":
        out = call.ref(*args, **kwargs)
    else:
        out = call.ref(*args)
    return out if isinstance(out, tuple) else (out,)


def phase_analysis(device: str = "cuda", card: str = "cpu") -> dict:
    """Phase 15: the kernel checker and the autotuner on the card.

    (a) ``analysis.check_kernels`` on the whole lattice with every launch
    count set to 0 first: no violation, and on the card every kernel
    (K1-K10 and S1, keys alone and with values) launched at least once;
    (b) at every trace point, the wrapper calls the op really makes equal
    the checker's launch model (``kernel_launches``), and each call's
    output equals its plain version on the same inputs (the merge-path
    kernels bit for bit, K9 within ``SCAN_RTOL`` and K10 within
    ``BWD_RTOL`` of the largest element); (c) on the card, every launch of
    the lattice (and K9 and K10 at each state width and dtype they take):
    the checker's shared-memory model equal to what the source's
    ``<kernel>_smem_bytes`` says the launch requests, and static plus
    dynamic shared memory within the budget; (d) ``tune.build_table()``
    over :data:`TUNE_SIZES` and ``tune.autotune`` of :data:`TUNE_N` int32
    keys, :data:`TUNE_ITERS` timed calls each, printed with the card's
    name and power limit.  ``compute-sanitizer`` is not run (its
    memcheck does not work on the card's machine: PERF.md)."""
    import torch

    from repro_torch import kernels
    from repro_torch.analysis import checker as ck
    from repro_torch.kernels import ssm_scan as sc
    from repro_torch.kernels import tune

    on_card = device == "cuda"
    kernels.reset_launches()
    t0 = time.perf_counter()
    violations = ck.check_kernels(device=device)
    seconds = time.perf_counter() - t0
    check(not violations, "analysis: " + "; ".join(map(str, violations[:10])))
    launches = {fn.__name__: fn.launches for fn in kernels.WRAPPERS}
    if on_card:
        check(min(launches.values()) >= 1, f"analysis: a kernel was not launched by the checker: {launches}")
    else:
        check(sum(launches.values()) == 0, f"analysis: the CPU run launched kernels: {launches}")
    print(f"analysis: {len(ck.registered_contracts())} contracts, 0 violations on the full lattice in {seconds:.2f} s "
          f"on {device}; launches {launches}")

    # (b) the launch model and the plain versions, point by point
    calls_checked, max_err = 0, {"merge_path": 0, "ssm_scan": 0.0, "ssm_scan_bwd": 0.0}
    for point in ck.launch_model_calls(device=device):
        for c in point.calls:
            what = f"analysis {c.launch.kernel} {c.launch.dims} ({point.contract.name}, {point.cfg.describe()})"
            with torch.no_grad():
                plain = _plain_of(c)
            got = c.out if isinstance(c.out, tuple) else (c.out,)
            for g, w in zip((t.detach() for t in got), plain):
                if c.launch.kernel == "ssm_scan":
                    max_err["ssm_scan"] = max(max_err["ssm_scan"], scan_err(g, w, what))
                elif c.launch.kernel == "ssm_scan_bwd":
                    max_err["ssm_scan_bwd"] = max(max_err["ssm_scan_bwd"], scan_err(g, w, what, BWD_RTOL, 0.0))
                else:
                    max_err["merge_path"] = max(max_err["merge_path"], bit_err(g, w, what))
            calls_checked += 1
    print(f"analysis: {calls_checked} wrapper calls at the trace points equal to the launch model and to their plain "
          f"versions (max abs err: merge-path bits {max_err['merge_path']}, K9 {max_err['ssm_scan']:.3g}, K10 "
          f"{max_err['ssm_scan_bwd']:.3g})")

    # (c) the shared-memory model against each source's request
    smem = {"checked": 0, "max_dynamic": 0, "max_total": 0}
    if on_card:
        budget = ck.SMEM_BUDGET_BYTES["h100"]
        # and K9 and K10 at each state width they take, in both dtypes (the lattice has float32 at 8)
        extra = [ck.Launch(k, dt, (1, 64, 64, st) + ((0,) if k == "ssm_scan" else ()))
                 for k in ("ssm_scan", "ssm_scan_bwd") for dt in ("float32", "bfloat16") for st in sc.STATES]
        for launch in ck.all_launches() + extra:
            model = ck.launch_smem(launch)
            dyn, static = ck.source_smem(launch)
            check(model == dyn, f"analysis: {launch.kernel} {launch.key} {launch.dims}: the checker models {model} B "
                                f"of shared memory, the source requests {dyn} B")
            check(dyn + static <= budget, f"analysis: {launch.kernel} {launch.dims}: {static} B static + {dyn} B "
                                          f"dynamic shared memory exceed {budget} B")
            smem["checked"] += 1
            smem["max_dynamic"] = max(smem["max_dynamic"], dyn)
            smem["max_total"] = max(smem["max_total"], dyn + static)
        print(f"analysis: A005's model equal to the sources' requests at {smem['checked']} launches; largest dynamic "
              f"{smem['max_dynamic']} B, static + dynamic {smem['max_total']} B of {budget} B")

    # (d) the autotuner
    table = tune.build_table(sizes=TUNE_SIZES, iters=TUNE_ITERS, update_table=False, device=device)
    best = tune.autotune(TUNE_N, torch.int32, iters=TUNE_ITERS, update_table=False, device=device)
    kernels.reset_launches()
    print(f"tune: table measured on {card}: {dict(sorted(table.items()))}; autotune({TUNE_N}, int32) -> {best}")
    return {"contracts": len(ck.registered_contracts()), "violations": len(violations), "device": device,
            "check_s": seconds, "launches": launches, "calls_checked": calls_checked, "max_abs_err": max_err,
            "smem": smem, "table": {f"{k[0]}{k[1]}": list(v) for k, v in sorted(table.items())},
            "autotune": {"n": TUNE_N, "dtype": "int32", "best": list(best)}, "card": card}


def _named_leaves(tree, prefix: str = ""):
    for k, v in tree.items():
        yield from _named_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]


def ptxas_kernels(log: str) -> list:
    """``(kernel, its "Used" line, its spill line)`` for each kernel of a
    ``ptxas -v`` log (per kernel: its name, then spills, then registers)."""
    out, kernel, spills = [], "?", ""
    for line in log.splitlines():
        if "Function properties for" in line:
            kernel = line.split(" for ", 1)[1].strip()
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line:
            out.append((kernel, line.split(":", 1)[1].strip(), spills))
    return out


def k10_registers(log: str) -> str:
    """K10's registers a thread and spill bytes, per state width, over its
    dtype instantiations (the block kernel's mangled name carries ST first)."""
    import re

    parts = []
    for st in (16, 8):
        rows = [(u, sp) for k, u, sp in ptxas_kernels(log) if f"ssm_scan_bwd_kernelILi{st}E" in k]
        check(bool(rows) or not log, f"no K10 kernel of state {st} in the ptxas log")
        if rows:
            regs = sorted({int(re.search(r"Used (\d+) registers", u).group(1)) for u, _ in rows})
            spill = sum(int(n) for _, sp in rows for n in re.findall(r"(\d+) bytes spill", sp))
            parts.append(f"state {st}: {len(rows)} dtype instantiations, {'/'.join(map(str, regs))} registers a "
                         f"thread, {spill} bytes of spill stores and loads in all")
    return "K10 (ptxas -v): " + ("; ".join(parts) if parts else "built before this run, so no ptxas log")


def sort_registers(built: dict) -> str:
    """K3's, K4's and S1's registers a thread and spill bytes, per
    instantiation, from the ``ptxas -v`` logs of ``sort_round.cu`` (K3 and
    K4 told apart by the ``kValues`` argument of ``sort_round_seg_kernel``'s
    mangled name) and ``sort_tiles.cu``."""
    import re

    parts = []
    for source in ("sort_round", "sort_tiles"):
        rows = ptxas_kernels(built[source].ptxas)
        check(bool(rows) or not built[source].ptxas, f"no kernel in the ptxas log of {source}.cu")
        if source == "sort_round" and rows:
            found = sorted(m.groups() for k, _, _ in rows if (m := re.search(r"sort_round_seg_kernelI([si])Lb([01])E", k)))
            check(found == [("i", "0"), ("i", "1"), ("s", "0"), ("s", "1")],
                  f"sort_round.cu: K3 and K4 instantiations in the ptxas log {found}, want int16/int32 x keys/values")
        for kernel, used, spills in rows:
            m = re.search(r"sort_round_seg_kernelI([si])Lb([01])E", kernel)
            label = f"K{3 + int(m.group(2))} {'int16' if m.group(1) == 's' else 'int32'}" if m else "S1"
            regs = re.search(r"Used (\d+) registers", used).group(1)
            spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", spills))
            parts.append(f"{label} {kernel}: {regs} registers, {spill} bytes of spill stores and loads")
    return "sort kernels (ptxas -v): " + ("; ".join(parts) if parts else "built before this run, so no ptxas log")


def merge_registers(built: dict) -> str:
    """K1's, K2's and K5-K8's registers a thread and spill bytes (stores and
    loads) per key dtype, from the ``ptxas -v`` log of ``merge.cu``."""
    import re

    dtypes = {"f": "float32", "N5repro4bf16E": "bfloat16", "i": "int32", "s": "int16"}
    key = r"I(f|i|s|N5repro4bf16E)Lb([01])E"
    log = built["merge"].ptxas
    rows = []
    for kernel, used, spills in ptxas_kernels(log):
        span = re.search("merge_span_kernel" + key, kernel)  # K1, K2
        row_span = re.search("merge_rows_span_kernel" + key + "Lb([01])E", kernel)  # K5-K8
        m = span or row_span
        if not m:
            continue
        label = f"K{1 + int(m.group(2))}" if span else f"K{5 + int(m.group(2)) + 2 * int(m.group(3))}"
        regs = re.search(r"Used (\d+) registers", used).group(1)
        spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", spills))
        rows.append((label, list(dtypes).index(m.group(1)), f"{label} {dtypes[m.group(1)]} {regs} registers {spill} B spill"))
    check(len(rows) == 24 or not log, f"{len(rows)} of the 24 K1, K2 and K5-K8 kernels in the ptxas log of merge.cu")
    parts = [r[2] for r in sorted(rows)]
    return "merge kernels (ptxas -v): " + ("; ".join(parts) if parts else "built before this run, so no ptxas log")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {len(built)} sources in {time.perf_counter() - t0:.2f} s, one nvcc each, all started together")
    for name, b in built.items():
        print(f"build: {name}.cu -> {b.path.name} in {b.seconds:.2f} s")
        for kernel, used, spills in ptxas_kernels(b.ptxas):
            print(f"  ptxas {kernel}: {used}; {spills}")
    k10_regs = k10_registers(built["ssm_scan_bwd"].ptxas)
    print(sort_registers(built))
    print(merge_registers(built))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k4 = phase_k4(gen)
    merge_sort = phase_merge_sort()
    batched = phase_batched()
    serving = phase_serving()
    phase_reference()
    ssm = phase_ssm()
    train = phase_train()
    print(f"train: {k10_regs}")
    attention = phase_attention()
    moe = phase_moe(card=card)
    distributed = phase_distributed(card=card)
    runtime = phase_runtime(card=card)
    vlm_audio = phase_vlm_audio(card=card)
    parallel = phase_parallel(card=card)
    analysis = phase_analysis(card=card)

    def entry(name, source, replaces, launches, r):
        return {"name": name, "route": "cuda", "source": f"{CSRC}/{source}", "replaces": f"{REPLACES}:{replaces}",
                "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    kernels = [
        entry("sort_round_kv", "sort_round.cu", 962, serving["launches"], k4),
        entry("merge", "merge.cu", 377, merge_sort["merge"]["launches"], merge_sort["merge"]),
        entry("merge_kv", "merge.cu", 395, merge_sort["merge_kv"]["launches"], merge_sort["merge_kv"]),
        entry("sort_round", "sort_round.cu", 924, merge_sort["sort_round"]["launches"], merge_sort["sort_round"]),
    ]
    kernels += [entry(name, "merge.cu", line, batched[name]["launches"], batched[name])
                for name, line in (("merge_batched", 543), ("merge_kv_batched", 562),
                                   ("merge_batched_ragged", 721), ("merge_kv_batched_ragged", 749))]
    # S1 has no Pallas counterpart: it replaces the reference's narrow rounds in XLA
    kernels.append(dict(entry("sort_tiles", "sort_tiles.cu", 0, merge_sort["sort_tiles"]["launches"],
                              merge_sort["sort_tiles"]), replaces="src/repro/kernels/ops.py:547"))
    kernels.append(dict(entry("sort_tiles_kv", "sort_tiles.cu", 0, serving["tiles_launches"],
                              dict(k4["tiles_kv"], max_abs_err=max(merge_sort["sort_tiles_kv"]["max_abs_err"],
                                                                   k4["tiles_kv"]["max_abs_err"]))),
                        replaces="src/repro/kernels/ops.py:576"))
    hymba = {key: {k: attention[key][k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "sfu_ms")}
             for key in ("k9", "k10")}
    kernels.append(dict(entry("ssm_scan", "ssm_scan.cu", 79, ssm["launches"], ssm),
                        replaces="src/repro/kernels/ssm_scan.py:79", hymba=hymba["k9"]))
    kernels.append(dict(entry("ssm_scan_bwd", "ssm_scan_bwd.cu", 157, train["launches"], train),
                        replaces="src/repro/kernels/ssm_scan.py:157", hymba=hymba["k10"]))
    for k in kernels:  # S1 and K4 on moonshot's routing keys and on phase 13's sampled rows; S1, K3, K4 and K7 on
        # the distributed sort
        if k["name"] in ("sort_round_kv", "sort_tiles_kv"):
            k["moe"] = moe[k["name"]]
            part = "k4" if k["name"] == "sort_round_kv" else "s1"
            k["vlm_audio"] = {m: {"launches": vlm_audio[m][f"{part}_launches"],
                                  "max_abs_err": vlm_audio[m]["row"]["max_abs_err"], **vlm_audio[m]["row"][part]}
                              for m in ("paligemma", "whisper")}
            nem = parallel["nemotron"]
            k["parallel"] = {"nemotron": {"launches": nem[f"{part}_launches"], "max_abs_err": nem["row"]["max_abs_err"],
                                          **nem["row"][part]}}
        if k["name"] in distributed:
            k["distributed"] = distributed[k["name"]]
    print("times: sort_round_kv's ms, plain_ms, library_ms and bound_ms are sums over the 6 wide rounds of one "
          "sampled token, its launches those of the serving run (6 per sampled token); merge's and merge_kv's are "
          "one call at 2 x 2^24 (float32 keys; int32 keys and values), library_ms one stable torch.sort of the "
          "concatenation (merge_kv: and the gather of the values); sort_round's are sums over the 15 wide rounds "
          "of one ops.sort of 2^24 int32 keys, library_ms the stable torch.sort of each round's pair view; the "
          "launches of merge, merge_kv, sort_round and sort_tiles are those of one ops.merge, ops.merge_kv, ops.sort "
          "(2^24) and ops.sort_batched (64, 65536); sort_tiles' (S1, the narrow rounds in one launch; no Pallas "
          "kernel: it replaces the reference's XLA loop) are one call on the 2^24 int32 keys of that ops.sort at "
          "chunk 512, library_ms one stable torch.sort of the (32768, 512) chunk view; sort_tiles_kv's are one call "
          "on a sampled token's (1, 32768) int16 keys and int32 indices at chunk 512, library_ms the chunks' stable "
          "torch.sort and the gather of the values, its launches those of the serving run (one per sampled token); "
          "merge_batched's, merge_kv_batched's, merge_batched_ragged's and "
          "merge_kv_batched_ragged's are one call at (64, 2^18) + (64, 2^18) (float32 keys; int32 keys and values; "
          "the ragged ones with the lengths of the path's run), library_ms one stable row-wise torch.sort of a‖b "
          "(the ragged ones: of the rows masked past their lengths; kv: and the gather of the values), their launches "
          "those of the batched path's run (merge_batched_ragged: 1 direct call and 3 rounds of each of 3 ops.merge_k); "
          "ssm_scan's are one call on layer 0's own inputs of the falcon-mamba-7b prefill at (1, 32768, 8192, 16) "
          "(dt float32, x, B, C and a bfloat16), library_ms null (no PyTorch call computes the recurrence), its "
          "launches those of that prefill (one per layer); ssm_scan_bwd's are one call (both of its passes) on "
          "layer 0's own operands of the falcon-mamba-7b train step at (1, 4096, 8192, 16) (dt float32; x, B, C, "
          "a and dy bfloat16; checkpoints every 32 steps), bound_ms of the function's own inputs and outputs (the "
          "partials of dB, dC and dA that K10's design adds are printed apart), "
          "library_ms null (no PyTorch call computes the recurrence's gradient), its launches those of the 3 "
          "train steps at 16 layers (one per layer and step); the \"hymba\" object of ssm_scan and ssm_scan_bwd holds "
          "the same numbers on layer 0's own operands of phase 9's hymba-1.5b prefill (1, 16384, 3200, 16) and first "
          "train step (1, 4096, 3200, 16), sfu_ms the exponentials' floor, launches those of that prefill (one per "
          "layer) and of the 3 train steps under remat_policy=\"full\" (one per layer and step); the \"moe\" object of "
          "sort_round_kv and sort_tiles_kv holds their numbers on layer 0's own routing keys of phase 10's "
          "moonshot-v1-16b-a3b prefill (1, 4096): 24576 (expert id, slot) int32 pairs padded to 32768, S1 one call "
          "at chunk 512 (library_ms the chunks' stable torch.sort and the gather of the slots), K4 the sums over "
          "its 6 wide rounds (library_ms each round's stable torch.sort of its pair view and the gather), launches "
          "those of that prefill (one S1 and 6 K4 per layer, 48 layers); the \"distributed\" object of sort_tiles, "
          "sort_tiles_kv, sort_round, sort_round_kv and merge_batched_ragged holds their numbers on phase 11's sample "
          "sort: launches those of one distributed_sort of 2^24 int32 (sort_tiles, sort_round) or float32 "
          "(sort_tiles_kv, sort_round_kv) keys at world size 1 (K7: none), launches_per_rank_p8 those of one rank's "
          "sort_prepare of 2^21 keys (S1, K3 or K4) or tournament combine of its 8 received runs (K7) at the emulated "
          "P = 8; the times on rank 0's stages there: S1 one call on its 2^21 keys at chunk 512 (float32: their "
          "total-order keys and int32 indices), K3 and K4 sums over its 12 wide rounds, K7 the sum over the 3 "
          "rounds of its int32 combine, library_ms as in the entries above; the \"vlm_audio\" object of sort_round_kv "
          "and sort_tiles_kv holds their numbers on phase 13's last sampled row of paligemma-3b (1, 257216) and the "
          "first of whisper-large-v3 (1, 51866), bfloat16 logits as int16 total-order keys with int32 indices: S1 one "
          "call at its chunk, K4 the sums over its 9 or 7 wide rounds, library_ms as in the moe object, launches "
          "those of phase 13's sampling runs (one S1 and 9 or 7 K4 per sampled step); the \"parallel\" object of "
          "sort_round_kv and sort_tiles_kv holds their numbers on phase 14's last sampled row of nemotron-4-340b (1, "
          "256000) the same way, launches those of its sampling run (one S1 and 9 K4 per token)")
    print(json.dumps({"runtime": runtime}))
    print(json.dumps({"vlm_audio": vlm_audio}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"analysis": analysis}))
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
