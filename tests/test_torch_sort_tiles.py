"""The tile sort S1's plain versions against the JAX package, bit for bit.

S1 (``kernels.merge_path.sort_tiles`` / ``sort_tiles_kv``) runs every
narrow round of the flat merge sort in one launch.  Its plain versions are
those rounds, one batched rank merge each, and the JAX package runs the
same rounds in XLA (``repro.kernels.ops._sort_rounds`` and
``_sort_rounds_kv``).  With ``m = tile`` the reference runs only that loop
and no Pallas round.  The surface tests (``ops.sort``, ``ops.sort_kv``,
``ops.topk_batched`` at ``m > tile``) run the reference's wide rounds in
interpret mode, as its own tests do on the CPU; the port's CPU tensors take
every kernel's plain version, and nothing is built or launched here.
``chip_smoke.py`` holds the kernel against these plain versions on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import WRAPPERS
from repro_torch.kernels import merge_path as km
from repro_torch.kernels import ops

KINDS = ("random", "all_equal", "sorted", "reverse", "few", "iinfo_max")
CHUNKS = (2, 128, 512)
N_CHUNKS = 4


def _keys(kind, n, dtype, rng):
    """One family of keys: the whole range; one key; ascending; descending;
    3 distinct keys; half of them the dtype's largest (the sentinel's value)."""
    info = np.iinfo(dtype)
    if kind == "random":
        x = rng.integers(info.min, info.max, n, endpoint=True)
    elif kind == "all_equal":
        x = np.full(n, 7)
    elif kind == "sorted":
        x = np.sort(rng.integers(-50, 50, n))
    elif kind == "reverse":
        x = np.sort(rng.integers(-50, 50, n))[::-1]
    elif kind == "few":
        x = rng.integers(-1, 2, n)
    elif kind == "iinfo_max":
        x = np.where(rng.random(n) < 0.5, info.max, rng.integers(-3, 4, n))
    else:
        raise ValueError(kind)
    return np.ascontiguousarray(x.astype(dtype))


@functools.cache
def _reference(chunk):
    """The reference's narrow rounds up to runs of ``chunk``, keys alone and
    with values (``m = tile = chunk``: no wide round, so no Pallas kernel),
    in one jitted call."""
    return jax.jit(lambda k, v: (jax_ops._sort_rounds(k, chunk, chunk, 8, "hier", True),
                                 jax_ops._sort_rounds_kv(k, v, chunk, chunk, 8, "hier", True)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_plain_versions_match_the_reference_narrow_rounds(dtype, chunk, kind):
    rng = np.random.default_rng(chunk + len(kind))
    n = N_CHUNKS * chunk
    keys = _keys(kind, n, dtype, rng)
    vals = rng.permutation(n).astype(np.int32)
    before = (km.sort_tiles.launches, km.sort_tiles_kv.launches)
    want, (wk, wv) = _reference(chunk)(jnp.asarray(keys), jnp.asarray(vals))
    got = km.sort_tiles(torch.from_numpy(keys), chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gk, gv = km.sort_tiles_kv(torch.from_numpy(keys), torch.from_numpy(vals), chunk)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # a stable sort of each chunk: equal keys keep their input order
    order = np.argsort(keys.reshape(-1, chunk), axis=1, kind="stable")
    np.testing.assert_array_equal(gv.numpy(), np.take_along_axis(vals.reshape(-1, chunk), order, 1).reshape(-1))
    assert (km.sort_tiles.launches, km.sort_tiles_kv.launches) == before  # the CPU path launches nothing


@pytest.mark.parametrize(
    "fn,dtype,shape,tile",
    [
        ("sort", np.int16, (300,), 32),
        ("sort", np.int32, (1000,), 128),
        ("sort_kv", np.int32, (300,), 32),
        ("topk_batched", np.float32, (3, 300), 64),
        ("sort", np.int32, (5000,), 8192),  # a tile past MAX_TILE: S1's chunk stops at 4096
        ("sort", np.int8, (300,), 512),  # keys S1 does not take: the core merges, as before
    ],
)
def test_surface_matches_reference_past_the_tile(fn, dtype, shape, tile):
    """The whole sorts at ``m > tile`` (and one ``m <= tile`` past
    ``MAX_TILE``) with many ties: the tile sort, then the wide rounds."""
    rng = np.random.default_rng(shape[-1])
    x = rng.integers(-3, 4, shape).astype(dtype)
    if fn == "sort_kv":
        v = rng.permutation(shape[0]).astype(np.int32)
        wk, wv = jax_ops.sort_kv(jnp.asarray(x), jnp.asarray(v), tile=tile, leaf=8)
        gk, gv = ops.sort_kv(torch.from_numpy(x), torch.from_numpy(v), tile=tile, leaf=8)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    elif fn == "topk_batched":
        wv, wi = jax_ops.topk_batched(jnp.asarray(x), 20, tile=tile)
        gv, gi = ops.topk_batched(torch.from_numpy(x), 20, tile=tile)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    else:
        want = jax_ops.sort(jnp.asarray(x), tile=tile, leaf=8)
        np.testing.assert_array_equal(ops.sort(torch.from_numpy(x), tile=tile, leaf=8).numpy(), np.asarray(want))


def test_cpu_sorts_launch_nothing():
    before = [fn.launches for fn in WRAPPERS]
    x = torch.from_numpy(_keys("few", 2048, np.int32, np.random.default_rng(0)))
    ops.sort(x, tile=64)
    ops.sort_kv(x, torch.arange(2048, dtype=torch.int32), tile=64)
    km.sort_tiles(x, 64)
    assert [fn.launches for fn in WRAPPERS] == before


@pytest.mark.parametrize(
    "keys,values,chunk,error",
    [
        (torch.zeros(512, dtype=torch.int64), None, 128, TypeError),  # key dtype
        (torch.zeros(512, dtype=torch.float32), None, 128, TypeError),
        (torch.zeros(512, dtype=torch.int32), torch.zeros(512, dtype=torch.int16), 128, TypeError),  # value dtype
        (torch.zeros(4, 128, dtype=torch.int32), None, 128, ValueError),  # not 1-D
        (torch.zeros(500, dtype=torch.int32), None, 128, ValueError),  # not whole chunks
        (torch.zeros(512, dtype=torch.int32), torch.zeros(256, dtype=torch.int32), 128, ValueError),  # values' shape
        (torch.zeros(1024, dtype=torch.int32)[::2], None, 128, ValueError),  # strided
        (torch.zeros(512, dtype=torch.int32), None, 1, ValueError),  # chunk below 2
        (torch.zeros(512, dtype=torch.int32), None, 96, ValueError),  # chunk not a power of two
        (torch.zeros(8192, dtype=torch.int32), None, 8192, ValueError),  # chunk past MAX_TILE
    ],
)
def test_wrappers_reject_bad_operands(keys, values, chunk, error):
    with pytest.raises(error):
        if values is None:
            km.sort_tiles(keys, chunk)
        else:
            km.sort_tiles_kv(keys, values, chunk)


def test_no_fallback_off_the_cpu():
    """A tensor neither on the CPU nor on a card is refused, not sent to the
    plain version."""
    keys = torch.zeros(512, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        km.sort_tiles(keys, 128)
    with pytest.raises(ValueError, match="unsupported device"):
        km.sort_tiles_kv(keys, torch.zeros(512, dtype=torch.int32, device="meta"), 128)
