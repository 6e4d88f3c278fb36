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
   int16 and int32 keys drawn from adversarial rows, then whole top-k
   sorts at (1, 32000) and (64, 32000); with CUDA-event times of the
   kernel, the plain version and one stable ``torch.sort`` (a yardstick the
   port never calls);
4. merge and sort at 2 x 2^24 elements (:func:`phase_merge_sort`): K1, K2
   and K3 against their plain versions, bit for bit, over adversarial input
   families; the whole path (``ops.merge``, ``ops.merge_kv``, ``ops.sort``,
   ``ops.sort_batched``) driven once with the launch counts read; CUDA-event
   times of each kernel, its plain version and one PyTorch call;
5. serving: ``ServingEngine`` on tinyllama-1.1b at full width (random
   weights from a seed), 4 requests with top-k sampling; the K4 launch
   count must be 6 per sampled token.  Then the reduced config on the card
   against the same weights on the CPU;
6. the ``kernels`` line, the card line and the result line.

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


def round_inputs(keys, width: int):
    """A flat round input: runs of ``width`` sorted stably, then the tail."""
    import torch

    from repro_torch.core.merge_path import max_sentinel

    m = keys.shape[0]
    vals = torch.arange(m, dtype=torch.int32, device="cuda")
    ks, perm = torch.sort(keys.view(-1, width), dim=1, stable=True)
    vs = torch.gather(vals.view(-1, width), 1, perm)
    kf = torch.cat([ks.reshape(-1), torch.full((TILE,), max_sentinel(keys.dtype), dtype=keys.dtype, device="cuda")])
    vf = torch.cat([vs.reshape(-1), torch.zeros((TILE,), dtype=torch.int32, device="cuda")])
    return kf, vf


def phase_k4(gen) -> dict:
    import torch

    from repro_torch.core import topk_batched as core_topk
    from repro_torch.core.merge_path import flip_desc, total_order_keys
    from repro_torch.kernels import ops
    from repro_torch.kernels.merge_path import sort_round_kv, sort_round_kv_ref

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

    # whole sorts through the public surface: kernel path against the core path
    for bsz in (1, 64):
        rows = [adversarial_floats(("logits", "all_equal", "dups", "specials")[r % 4], 32000, torch.bfloat16, gen) for r in range(bsz)]
        x = torch.stack(rows)
        for k in (40, 32000):
            compare(ops.topk_batched(x, k), core_topk(x, k), f"topk_batched ({bsz}, 32000) k={k}")
    torch.cuda.synchronize()

    print("K4 per round (m=32768+512, T=512, S=32; CUDA events):")
    for (kd, w), r in rounds.items():
        print(f"  {kd:12s} width {w:5d}: kernel_ms {r['kernel_ms']:.5f}  plain_ms {r['plain_ms']:.5f}  "
              f"library_ms {r['library_ms']:.5f}  bound_ms {r['bound']['ms']:.6f} ({r['bound']['by']})")
    main_path = [r for (kd, _), r in rounds.items() if kd == str(torch.int16)]
    print(f"K4: {cases} comparisons against the plain version, tolerance 0 (bit-identical), max abs err {max_err}")
    return {
        "max_abs_err": max_err,
        "ms": sum(r["kernel_ms"] for r in main_path),
        "plain_ms": sum(r["plain_ms"] for r in main_path),
        "library_ms": sum(r["library_ms"] for r in main_path),
        "bound_ms": sum(r["bound"]["ms"] for r in main_path),
        "bound_by": main_path[0]["bound"]["by"],
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


def sorted_side(kind: str, n: int, dtype, gen, device: str):
    """One sorted input of a merge.  ``random``: spread-out keys; ``dups``:
    7 distinct keys; ``all_equal``: one key; ``sentinel``: the dtype's
    lowest key first and keys equal to the sentinel (``+inf``,
    ``iinfo.max``) at the end; ``signed_zeros`` (floats): -0.0 and +0.0
    at random in a long run of zeros, and +-inf at the ends."""
    import torch

    floating = dtype.is_floating_point
    hi = math.inf if floating else torch.iinfo(dtype).max
    lo = -math.inf if floating else torch.iinfo(dtype).min
    if kind == "random" and floating:
        x = torch.randn(n, generator=gen, device=device) * 1000
    elif kind == "random":
        x = torch.randint(lo // 2, hi // 2, (n,), generator=gen, device=device, dtype=torch.int64)
    elif kind in ("dups", "signed_zeros"):
        x = torch.randint(-3, 4, (n,), generator=gen, device=device)
    elif kind == "all_equal":
        x = torch.full((n,), 7, device=device)
    elif kind == "sentinel":
        x = torch.randint(-1000, 1000, (n,), generator=gen, device=device)
    else:
        raise ValueError(kind)
    x = torch.sort(x.to(dtype)).values
    if kind == "signed_zeros":  # sorted under `<`, where -0.0 == +0.0
        signs = torch.rand(n, generator=gen, device=device) < 0.5
        x = torch.where((x == 0) & signs, torch.tensor(-0.0, dtype=dtype, device=device), x)
    if kind in ("sentinel", "signed_zeros"):
        x[: n // 20] = lo
        x[n - (2 * n // 5 if kind == "sentinel" else n // 20):] = hi
    return x.contiguous()


def merge_bound(n: int, bytes_per_element: int) -> dict:
    """Least time of a merge of n elements in all: each input byte read once
    and each output byte written once, against a few comparisons each."""
    t_bytes = 2 * n * bytes_per_element / HBM_BYTES_PER_S * 1e3
    t_ops = n * (math.log2(LEAF) + 2) / SCALAR_OPS_PER_S * 1e3
    return {"ms": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations"}


def wide_rounds(n: int, tile: int) -> int:
    """K3/K4 launches of one sort of rows of n: widths tile ... m / 2."""
    m = 1 << max(0, (n - 1).bit_length())
    return max(0, m.bit_length() - tile.bit_length())


def phase_merge_sort(device: str = "cuda", log2n: int = 24, batch=(64, 65536), tile: int = TILE,
                     leaf: int = LEAF, seed: int = 1) -> dict:
    """K1, K2 and K3 on the merge-and-sort path at ``2 x 2^log2n`` elements.

    Every merge and every round is held against the kernel's plain version
    bit for bit, the whole path is driven once through ``kernels.ops`` with
    the launch counts set to 0 just before it, and on the card each kernel
    is timed beside its plain version, its bound and one PyTorch call.
    With ``device="cpu"`` (the tests, at a small size) the wrappers run
    their plain versions, nothing is launched or timed, and every check
    still runs.
    """
    import torch

    from repro_torch.core.merge_path import max_sentinel
    from repro_torch.kernels import merge_path as km
    from repro_torch.kernels import ops

    on_card = device == "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n1 = 1 << log2n
    errs = {"merge": 0, "merge_kv": 0, "sort_round": 0}
    cases = dict.fromkeys(errs, 0)

    def launched(fn, call, n_launches):
        """Run ``call``; check that it launched ``fn`` n_launches times (none off the card)."""
        before = fn.launches
        out = call()
        want = n_launches if on_card else 0
        check(fn.launches - before == want, f"{fn.__name__}: {fn.launches - before} launches, want {want}")
        return out

    # K1: every family of every key dtype, then the edge shapes
    merge_cases = []
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
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
        got = launched(km.merge, lambda: ops.merge(a, b, tile=tile, leaf=leaf), int(na + nb > tile))
        what = f"merge {dtype} {kind} ({na}, {nb})"
        errs["merge"] = max(errs["merge"], bit_err(got, km.merge_ref(a, b), what))
        cases["merge"] += 1

    # K2: arange values, so that every value names its source slot (float32
    # values carry the same bits: floats past 2^24 would not be distinct)
    kv_cases = [(torch.int32, kind, n1, n1) for kind in ("random", "dups", "all_equal", "sentinel")]
    kv_cases += [(torch.float32, "signed_zeros", n1, n1), (torch.int32, "random", n1 + n1 // 2 - 1, n1),
                 (torch.int32, "dups", 0, n1), (torch.int32, "random", tile // 4, tile // 2)]
    for dtype, kind, na, nb in kv_cases:
        ak, bk = sorted_side(kind, na, dtype, gen, device), sorted_side(kind, nb, dtype, gen, device)
        vals = torch.arange(na + nb, dtype=torch.int32, device=device)
        src = vals.view(torch.float32) if dtype.is_floating_point else vals
        av, bv = src[:na], src[na:]
        ko, vo = launched(km.merge_kv, lambda: ops.merge_kv(ak, av, bk, bv, tile=tile, leaf=leaf), int(na + nb > tile))
        wk, wv = km.merge_kv_ref(ak, av, bk, bv)
        what = f"merge_kv {dtype} {kind} ({na}, {nb})"
        errs["merge_kv"] = max(errs["merge_kv"], bit_err(ko, wk, what + " keys"), bit_err(vo, wv, what + " values"))
        # sorted, stable and a permutation, whatever the plain version says
        vo = vo.view(torch.int32)
        check(bool((ko[1:] >= ko[:-1]).all()), f"{what}: keys not sorted")
        check(bool((vo[1:] > vo[:-1])[ko[1:] == ko[:-1]].all()), f"{what}: equal keys out of source order")
        check(torch.equal(torch.sort(vo).values, vals), f"{what}: values are not a permutation of the inputs")
        cases["merge_kv"] += 1

    # K3: every wide round of a 2^log2n sort, then whole sorts
    def round_keys(keys, width):
        runs = torch.sort(keys.view(-1, width), dim=1, stable=True).values.reshape(-1)
        return torch.cat([runs, torch.full((tile,), max_sentinel(keys.dtype), dtype=keys.dtype, device=device)])

    def shuffled(kind, dtype):
        return sorted_side(kind, n1, dtype, gen, device)[torch.randperm(n1, generator=gen, device=device)]

    widths = [tile << i for i in range(wide_rounds(n1, tile))]
    for dtype, kind in ((torch.int32, "random"), (torch.int32, "sentinel"), (torch.int16, "dups")):
        keys = shuffled(kind, dtype)
        for w in widths:
            xf = round_keys(keys, w)
            got = launched(km.sort_round, lambda: km.sort_round(xf, w, tile=tile, leaf=leaf), 1)
            what = f"sort_round {dtype} {kind} width {w}"
            errs["sort_round"] = max(errs["sort_round"], bit_err(got, km.sort_round_ref(xf, w, tile=tile), what))
            cases["sort_round"] += 1
        got = launched(km.sort_round, lambda: ops.sort(keys, tile=tile, leaf=leaf), len(widths))
        bit_err(got, torch.sort(keys, stable=True).values, f"ops.sort {dtype} {kind} 2^{log2n}")
    rows = torch.randint(-(2**31), 2**31 - 1, batch, generator=gen, device=device, dtype=torch.int64).to(torch.int32)
    got = launched(km.sort_round, lambda: ops.sort_batched(rows, tile=tile, leaf=leaf), wide_rounds(batch[1], tile))
    bit_err(got, torch.sort(rows, dim=1, stable=True).values, f"ops.sort_batched {tuple(batch)}")

    # the result must not depend on (T, S): other tiles and leaves, odd lengths
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
                got = launched(km.sort_round, lambda: km.sort_round(xf, w, tile=t, leaf=s), 1)
                errs["sort_round"] = max(errs["sort_round"], bit_err(got, km.sort_round_ref(xf, w, tile=t),
                                                                      f"sort_round tile {t} leaf {s} width {w}"))
                cases["sort_round"] += 1

    # the path, driven once through the public surface with every count at 0
    a, b = (sorted_side("random", n1, torch.float32, gen, device) for _ in range(2))
    ak, bk = (sorted_side("random", n1, torch.int32, gen, device) for _ in range(2))
    av = torch.arange(n1, dtype=torch.int32, device=device)
    bv = torch.arange(n1, 2 * n1, dtype=torch.int32, device=device)
    keys = shuffled("random", torch.int32)
    km.reset_launches()
    merged = ops.merge(a, b, tile=tile, leaf=leaf)
    mk, mv = ops.merge_kv(ak, av, bk, bv, tile=tile, leaf=leaf)
    sorted_keys = ops.sort(keys, tile=tile, leaf=leaf)
    sorted_rows = ops.sort_batched(rows, tile=tile, leaf=leaf)
    launches = {fn.__name__: fn.launches for fn in km.WRAPPERS}
    want = {"merge": 1, "merge_kv": 1, "sort_round": len(widths) + wide_rounds(batch[1], tile), "sort_round_kv": 0}
    check(launches == (want if on_card else dict.fromkeys(want, 0)), f"path launched {launches}, want {want}")
    bit_err(merged, km.merge_ref(a, b), "path: ops.merge")
    for g, w, part in zip((mk, mv), km.merge_kv_ref(ak, av, bk, bv), ("keys", "values")):
        bit_err(g, w, f"path: ops.merge_kv {part}")
    bit_err(sorted_keys, torch.sort(keys, stable=True).values, "path: ops.sort")
    bit_err(sorted_rows, torch.sort(rows, dim=1, stable=True).values, "path: ops.sort_batched")
    print(f"merge/sort: {cases['merge']} K1 merges, {cases['merge_kv']} K2 merges and {cases['sort_round']} K3 rounds "
          f"against their plain versions at 2^{log2n} per side, tolerance 0 (bit-identical), max abs err "
          f"{max(errs.values())}; the path launched {launches}")

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
    # the public calls whole, narrow rounds and host dispatch included
    whole = {
        "ops.merge": time_ms(lambda: ops.merge(a, b, tile=tile, leaf=leaf)),
        "ops.merge_kv": time_ms(lambda: ops.merge_kv(ak, av, bk, bv, tile=tile, leaf=leaf)),
        f"ops.sort 2^{log2n}": time_ms(lambda: ops.sort(keys, tile=tile, leaf=leaf), iters=5),
        f"ops.sort_batched {tuple(batch)}": time_ms(lambda: ops.sort_batched(rows, tile=tile, leaf=leaf), iters=5),
    }
    print("  whole calls (CUDA events): " + ", ".join(f"{k} {v:.5f} ms" for k, v in whole.items()))
    return out


def phase_serving() -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.merge_path import reset_launches, sort_round_kv
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

    tokens = [t for r in engine.done.values() for t in r.generated]
    check(report.ok(), f"serving report not ok: {report.statuses} {report.reasons}")
    check(report.retries == 0, f"serving retried {report.retries} ticks: {report.reasons}")
    check(report.completed == 4 and len(engine.done) == 4, f"completed {report.completed} of 4")
    check(all(0 <= t < cfg.vocab_size for t in tokens), f"token out of range: {tokens}")
    check(launches == 6 * len(tokens), f"K4 launched {launches} times for {len(tokens)} sampled tokens (want 6 each)")
    print(f"serving: 4 requests, {len(tokens)} sampled tokens in {seconds:.3f} s "
          f"({seconds * 1e3 / len(tokens):.2f} ms/token, prefill included), K4 launches {launches}")

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
    return {"launches": launches, "tokens": len(tokens), "ms_per_token": seconds * 1e3 / len(tokens)}


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
        kernel, spills = "?", ""
        for line in b.ptxas.splitlines():  # ptxas -v: name, then spills, then registers
            if "Function properties for" in line:
                kernel = line.split(" for ", 1)[1].strip()
            elif "spill" in line:
                spills = line.strip()
            elif "Used" in line:
                print(f"  ptxas {kernel}: {line.split(':', 1)[1].strip()}; {spills}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k4 = phase_k4(gen)
    merge_sort = phase_merge_sort()
    serving = phase_serving()
    phase_reference()

    def entry(name, source, replaces, launches, r):
        return {"name": name, "route": "cuda", "source": f"{CSRC}/{source}", "replaces": f"{REPLACES}:{replaces}",
                "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    kernels = [
        entry("sort_round_kv", "sort_round_kv.cu", 962, serving["launches"], k4),
        entry("merge", "merge.cu", 377, merge_sort["merge"]["launches"], merge_sort["merge"]),
        entry("merge_kv", "merge.cu", 395, merge_sort["merge_kv"]["launches"], merge_sort["merge_kv"]),
        entry("sort_round", "sort_round.cu", 924, merge_sort["sort_round"]["launches"], merge_sort["sort_round"]),
    ]
    print("times: sort_round_kv's ms, plain_ms, library_ms and bound_ms are sums over the 6 wide rounds of one "
          "sampled token, its launches those of the serving run (6 per sampled token); merge's and merge_kv's are "
          "one call at 2 x 2^24 (float32 keys; int32 keys and values), library_ms one stable torch.sort of the "
          "concatenation (merge_kv: and the gather of the values); sort_round's are sums over the 15 wide rounds "
          "of one ops.sort of 2^24 int32 keys, library_ms the stable torch.sort of each round's pair view; the "
          "launches of merge, merge_kv and sort_round are those of one ops.merge, ops.merge_kv, ops.sort (2^24) "
          "and ops.sort_batched (64, 65536)")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
