"""K4's plain version against the JAX Pallas round, bit for bit; K3 and K4
on unsorted runs; the round kernel's source rules.

The JAX side runs ``sort_round_kv_pallas`` in interpret mode, as the JAX
package's own tests do on the CPU.  The port's CUDA kernel is not built
here: on a CPU tensor ``sort_round_kv`` takes its plain version, which is
what these tests hold against the reference.  ``chip_smoke.py`` holds the
kernel against the same plain version on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.merge_path import sort_round_kv_pallas
from repro_torch.kernels import merge_path as km

M, TILE, LEAF = 512, 64, 8


def _round_input(dtype, width, seed):
    """Runs of ``width`` sorted keys with heavy duplicates and keys equal to
    the sentinel, int32 values, then the sentinel/zero tail."""
    rng = np.random.default_rng(seed)
    imax = np.iinfo(dtype).max
    keys = rng.integers(-4, 4, size=M).astype(dtype)
    keys[rng.random(M) < 0.2] = imax
    keys[M // 2 : M // 2 + width] = imax  # one whole run of sentinel-equal keys
    vals = rng.permutation(M).astype(np.int32)
    order = np.argsort(keys.reshape(-1, width), axis=1, kind="stable")
    keys = np.take_along_axis(keys.reshape(-1, width), order, 1).reshape(-1)
    vals = np.take_along_axis(vals.reshape(-1, width), order, 1).reshape(-1)
    kf = np.concatenate([keys, np.full(TILE, imax, dtype)])
    vf = np.concatenate([vals, np.zeros(TILE, np.int32)])
    return kf, vf


@pytest.mark.parametrize(
    "dtype,width",
    [(np.int16, 32), (np.int16, 64), (np.int16, 128), (np.int16, 256), (np.int32, 32), (np.int32, 256)],
)
def test_sort_round_kv_matches_pallas(dtype, width):
    kf, vf = _round_input(dtype, width, seed=width)
    wk, wv = sort_round_kv_pallas(jnp.asarray(kf), jnp.asarray(vf), width, tile=TILE, leaf=LEAF, interpret=True)
    before = km.sort_round_kv.launches
    gk, gv = km.sort_round_kv(torch.from_numpy(kf), torch.from_numpy(vf), width, tile=TILE, leaf=LEAF)
    assert km.sort_round_kv.launches == before  # the CPU path launches nothing
    assert gk.dtype == torch.from_numpy(kf).dtype and gv.dtype == torch.int32
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_sort_round_chain_sorts_stably():
    """Rounds from width 1 up sort the buffer: a stable argsort of the keys."""
    kf, vf = _round_input(np.int32, 1, seed=7)
    want = np.argsort(kf[:M], kind="stable")
    k, v = torch.from_numpy(kf), torch.from_numpy(vf)
    width = TILE // 2
    k32, v32 = k[:M].view(-1, width), v[:M].view(-1, width)  # narrow rounds are the core's job
    s, perm = torch.sort(k32, dim=1, stable=True)
    k = torch.cat([s.reshape(-1), k[M:]])
    v = torch.cat([torch.gather(v32, 1, perm).reshape(-1), v[M:]])
    while width < M:
        k, v = km.sort_round_kv(k, v, width, tile=TILE, leaf=LEAF)
        width *= 2
    np.testing.assert_array_equal(v[:M].numpy(), vf[want])
    np.testing.assert_array_equal(k[M:].numpy(), np.full(TILE, np.iinfo(np.int32).max))
    np.testing.assert_array_equal(v[M:].numpy(), np.zeros(TILE, np.int32))


@pytest.mark.parametrize(
    "key_dtype,value_dtype,n,width,tile,error",
    [
        (torch.int64, torch.int32, M + TILE, 64, TILE, TypeError),
        (torch.int32, torch.int64, M + TILE, 64, TILE, TypeError),
        (torch.int32, torch.int32, M + TILE, 48, TILE, ValueError),  # width not a power of two
        (torch.int32, torch.int32, M + TILE + 48, 64, 48, ValueError),  # tile not a power of two
        (torch.int32, torch.int32, M + TILE, 16, TILE, ValueError),  # tile does not divide 2 * width
        (torch.int32, torch.int32, M + TILE + 1, 64, TILE, ValueError),  # data not whole pairs
    ],
)
def test_sort_round_kv_rejects_bad_operands(key_dtype, value_dtype, n, width, tile, error):
    kf, vf = torch.zeros(n, dtype=key_dtype), torch.zeros(n, dtype=value_dtype)
    with pytest.raises(error):
        km.sort_round_kv(kf, vf, width, tile=tile)


def test_sort_round_kv_rejects_strided_operands():
    kf = torch.zeros(2 * (M + TILE), dtype=torch.int32)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        km.sort_round_kv(kf, torch.zeros(M + TILE, dtype=torch.int32), 64, tile=TILE)


def test_sort_round_kv_has_no_fallback_off_the_cpu():
    """A tensor that is neither on the CPU nor on a card is refused, not
    sent to the plain version."""
    kf = torch.zeros(M + TILE, dtype=torch.int16, device="meta")
    vf = torch.zeros(M + TILE, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        km.sort_round_kv(kf, vf, 64, tile=TILE)


def test_sort_round_of_unsorted_runs_keeps_its_layout():
    """Unsorted runs break K3's contract and their merge is unspecified, but
    the round keeps its layout: ``m + T`` keys, the tail rewritten with
    sentinels.  On the card ``chip_smoke.py`` runs the kernel on such runs
    at a width past its span, where it must not fault."""
    rng = np.random.default_rng(3)
    width = 4 * TILE
    xf = torch.from_numpy(np.concatenate([rng.integers(-1000, 1000, 4 * width), np.full(TILE, 2**31 - 1)]).astype(np.int32))
    before = km.sort_round.launches
    got = km.sort_round(xf, width, tile=TILE, leaf=LEAF)
    assert km.sort_round.launches == before
    assert got.shape == xf.shape and got.dtype == xf.dtype
    np.testing.assert_array_equal(got[4 * width:].numpy(), np.full(TILE, 2**31 - 1, np.int32))
    np.testing.assert_array_equal(got[: 4 * width].numpy(), np.sort(xf[: 4 * width].numpy().reshape(-1, 2 * width), axis=1).reshape(-1))


def test_sort_round_kv_of_unsorted_runs_keeps_its_layout():
    """Unsorted runs break K4's contract too and their merge is unspecified,
    but the round keeps its layout: ``m + T`` keys and values, the tail
    rewritten with sentinel keys and zero values whatever it held.  On the
    card ``chip_smoke.py`` runs the kernel on such runs past its span."""
    rng = np.random.default_rng(4)
    width, imax = 4 * TILE, np.iinfo(np.int32).max
    keys = rng.integers(-1000, 1000, 4 * width).astype(np.int32)
    keys[rng.random(4 * width) < 0.1] = imax
    vals = rng.permutation(4 * width).astype(np.int32)
    kf = torch.from_numpy(np.concatenate([keys, np.full(TILE, 5, np.int32)]))
    vf = torch.from_numpy(np.concatenate([vals, np.full(TILE, -1, np.int32)]))
    before = km.sort_round_kv.launches
    gk, gv = km.sort_round_kv(kf, vf, width, tile=TILE, leaf=LEAF)
    assert km.sort_round_kv.launches == before
    assert gk.shape == kf.shape and gv.shape == vf.shape and gk.dtype == kf.dtype and gv.dtype == vf.dtype
    np.testing.assert_array_equal(gk[4 * width:].numpy(), np.full(TILE, imax, np.int32))
    np.testing.assert_array_equal(gv[4 * width:].numpy(), np.zeros(TILE, np.int32))
    order = np.argsort(keys.reshape(-1, 2 * width), axis=1, kind="stable")
    np.testing.assert_array_equal(gk[: 4 * width].numpy(), np.take_along_axis(keys.reshape(-1, 2 * width), order, 1).reshape(-1))
    np.testing.assert_array_equal(gv[: 4 * width].numpy(), np.take_along_axis(vals.reshape(-1, 2 * width), order, 1).reshape(-1))


def test_sort_round_kernel_clamps_its_window():
    """Where a block lies inside one pair, K3 and K4 (one kernel template)
    stage windows of ``wa`` and ``span - wa`` keys, and K4 its values at the
    same offsets, from its two searches; on unsorted runs the searches need
    not be monotone, so ``wa`` is clamped to ``[0, span]`` before either
    window is staged, for the keys and the values alike, as ``merge_block``
    clamps K1's."""
    src = (Path(km.__file__).parent / "csrc" / "sort_round.cu").read_text()
    # one staging helper: each window of the keys, and the same of the values
    helper = src[src.index("const auto stage = [&](int64_t ga, int ca, int64_t gb, int cb) {"):src.index("const int j0")]
    assert "const WindowPair<K> wk(kf, ga, ca, gb, cb);" in helper
    assert "const WindowPair<uint32_t> wv(vf, ga, ca, gb, cb);" in helper
    assert helper.count("load_windows(") == 2 and helper.count("store_windows(") == 3
    start = src.index("if (two_w > span)")
    inside = src[start:src.index("} else {", start)]
    clamp = re.search(r"const int wa = static_cast<int>\(wa64 < 0 \? 0 : \(wa64 < span \? wa64 : span\)\);", inside)
    calls = [m.start() for m in re.finditer(r"\bstage\(", inside)]
    assert clamp and len(calls) == 1 and clamp.end() <= calls[0]
    assert "stage(base + win[0], wa, base + width + (dg - win[0]), span - wa);" in inside
    assert "_window" not in inside  # nothing is staged around the helper


def test_round_kv_span_matches_the_kernel():
    """``SORT_ROUND_KV_SPAN`` is K4's most outputs per block in
    ``sort_round.cu``: threads times outputs a thread with values."""
    src = (Path(km.__file__).parent / "csrc" / "sort_round.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    per_thread = re.search(r"constexpr int kE = kValues \? (\d+) : (\d+);", src)
    assert km.SORT_ROUND_KV_SPAN == threads * int(per_thread[1])


def test_tile_body_is_retired():
    """Every merge-path kernel runs the segment merge: no source defines the
    TPU-shaped tile body, its block search or its launcher any more, and
    the K4 library is ``sort_round``'s."""
    csrc = Path(km.__file__).parent / "csrc"
    for path in csrc.iterdir():
        text = path.read_text()
        for name in ("merge_tile", "block_co_rank", "sort_round_kernel", "launch_sort_round", "block_threads"):
            assert not re.search(rf"\b{name}\b", text), f"{path.name} names {name}"
    assert not (csrc / "sort_round_kv.cu").exists() and not (csrc / "merge_tile.cuh").exists()
    src = (csrc / "sort_round.cu").read_text()
    assert "int sort_round_kv_i16(" in src and "int sort_round_kv_i32(" in src
