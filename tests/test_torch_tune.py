"""The port's (tile, leaf) lookup and its autotuner against the reference's.

* with the empty ``DEFAULT_TABLE``, ``pick(n, dtype)`` is the fixed pick
  the port had before the table came back, for every ``n`` and dtype;
* ``_kind`` and ``_bucket`` equal the reference's;
* ``autotune`` of a small CPU sort updates the table, ``pick`` follows
  it, and the nearest-bucket fallback is the reference's; the table is
  restored afterwards.

All on the CPU (the autotuner times the plain versions with the
telemetry clock); nothing is built.
"""

import random

import jax.numpy as jnp
import pytest
import torch

from repro.kernels import tune as ref_tune
from repro_torch.kernels import tune

DTYPES = (None, torch.int16, torch.int32, torch.float32, torch.bfloat16)
JNP = {torch.int16: jnp.int16, torch.int32: jnp.int32, torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _fixed_pick(n: int):
    """The port's pick before the table: T = 512 and S = 32 capped at the
    next power of two at or above n (at least 128)."""
    cap = 1 << max(0, (max(1, n) - 1).bit_length())
    tile = min(512, max(cap, 128))
    return tile, min(32, tile)


@pytest.fixture
def table():
    """The in-process table, restored after the test."""
    saved = dict(tune._TABLE)
    yield tune._TABLE
    tune._TABLE.clear()
    tune._TABLE.update(saved)


def test_empty_table_picks_the_fixed_defaults_for_every_n():
    """Both picks depend on ``n`` only through its next power of two, so
    every ``n`` in ``[1, 2^16]`` and both ends of every power-of-two
    interval up to ``2^24`` (and 2000 random ``n`` between) cover all of
    ``[1, 2^24]``."""
    assert tune.DEFAULT_TABLE == {} and tune._TABLE == {}
    ns = set(range(1, (1 << 16) + 1))
    for e in range(16, 25):
        ns |= {(1 << e) - 1, 1 << e, (1 << e) + 1}
    rng = random.Random(0)
    ns |= {rng.randint(1, 1 << 24) for _ in range(2000)}
    for dtype in DTYPES:
        for n in sorted(ns):
            if n <= 1 << 24:
                assert tune.pick(n, dtype) == _fixed_pick(n), (n, dtype)


def test_kind_and_bucket_match_the_reference():
    for dtype, jdt in JNP.items():
        assert tune._kind(dtype) == ref_tune._kind(jdt)
    for n in list(range(0, 5000)) + [(1 << e) + d for e in range(12, 31) for d in (-1, 0, 1)] + [int(1.5 * 2**20)]:
        assert tune._bucket(n) == ref_tune._bucket(n), n


def test_autotune_updates_the_table_and_pick_follows(table):
    best = tune.autotune(512, torch.float32, tiles=(128, 256), iters=1, device="cpu")
    assert best in ((128, 32), (256, 32))
    assert table == {("f", 9): best}
    assert tune.pick(512, torch.float32) == best  # the exact bucket
    assert tune.pick(600, torch.bfloat16) == best  # the same kind's nearest bucket
    assert tune.pick(1 << 20, torch.float32) == best
    assert tune.pick(512, torch.int32) == _fixed_pick(512)  # no int bucket: the defaults
    table[("f", 9)] = (4096, 64)
    assert tune.pick(100, torch.float32) == (128, 64)  # capped at the next power of two (at least 128)


def test_nearest_bucket_is_the_reference_lookup(table):
    entries = {("i", 12): (256, 8), ("i", 18): (1024, 8), ("f", 15): (512, 8)}
    table.update(entries)
    saved = dict(ref_tune._TABLE)
    ref_tune._TABLE.clear()
    ref_tune._TABLE.update(entries)
    try:
        for n in (1, 100, 3000, 5000, 1 << 15, 40000, 1 << 18, 1 << 22):
            for dtype, jdt in ((torch.int32, jnp.int32), (torch.float32, jnp.float32)):
                assert tune.pick(n, dtype) == ref_tune.pick(n, jdt), (n, dtype)
    finally:
        ref_tune._TABLE.clear()
        ref_tune._TABLE.update(saved)


def test_build_table_and_its_literal(table):
    out = tune.build_table(sizes=(256, 1024), dtypes=(torch.int32,), tiles=(128, 256), iters=1, device="cpu")
    assert set(out) == {("i", 8), ("i", 10)} and set(table) == set(out)
    assert all(t in (128, 256) and s == tune.DEFAULT_LEAF for t, s in out.values())
    text = tune.format_table(out)
    assert text.startswith("DEFAULT_TABLE: Dict[Tuple[str, int], Tuple[int, int]] = {") and "('i', 8)" in text
    assert tune.TILE_CANDIDATES == (128, 256, 512, 1024, 2048, 4096) and tune.LEAF_CANDIDATES == (32,)


def test_main_needs_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="measures the card"):
            tune.main()
