"""One stream of prompts whose lengths follow a clipped lognormal.

The mix file gives ``median``, ``sigma``, ``min``, ``max`` and
``quantiles`` (a power of two, M): the lengths are the M quantiles
``(i + 0.5) / M`` of the clipped distribution, the same for every seed.
Request ``i`` takes the length of rank ``bitreverse(i mod M) xor mask``,
the mask drawn for each block of M requests: every block holds each
length once, and every prefix of 2^j requests of a block one length from
each of 2^j strata.  Which requests are greedy: one in ``greedy_every``
of each block, at a rank of the block drawn with the masks, so that
greedy requests too see every length.  The masks and the greedy ranks
are drawn from the mix's ``order_seed`` where it gives one, so that every
run replays the same schedule of lengths, else from the run's seed.  The
run's seed draws the tokens (uniform over ``[1, vocab)``).  Every request
is due at the window's start: load above any rate the system sustains,
the queue never empty.
"""

from __future__ import annotations

import math
import random
from statistics import NormalDist
from typing import Dict, List

import torch


def lengths(mix: Dict) -> List[int]:
    m = mix["quantiles"]
    if m & (m - 1):
        raise ValueError(f"quantiles must be a power of two, got {m}")
    nd = NormalDist()
    out = [int(round(mix["median"] * math.exp(mix["sigma"] * nd.inv_cdf((i + 0.5) / m)))) for i in range(m)]
    return [min(mix["max"], max(mix["min"], n)) for n in out]


def _bitrev(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


class Requests:
    def __init__(self, mix: Dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        self.lengths = lengths(mix)
        self.m = len(self.lengths)
        self.bits = self.m.bit_length() - 1
        self._rng = random.Random(mix.get("order_seed", seed))
        self._masks: List[int] = []
        self._greedy: List[int] = []

    def _block(self, b: int):
        while len(self._masks) <= b:
            self._masks.append(self._rng.randrange(self.m))
            self._greedy.append(self._rng.randrange(self.mix.get("greedy_every", 1) or 1))
        return self._masks[b], self._greedy[b]

    def length(self, i: int) -> int:
        mask, _ = self._block(i // self.m)
        return self.lengths[_bitrev(i % self.m, self.bits) ^ mask]

    def greedy(self, i: int) -> bool:
        every = self.mix.get("greedy_every", 0)
        if not every:
            return False
        _, phase = self._block(i // self.m)
        return i % every == phase

    def tokens(self, i: int, device) -> torch.Tensor:
        gen = torch.Generator(device=device)
        gen.manual_seed((self.seed * 1_000_003 + i) % (1 << 63))
        return torch.randint(1, self.vocab, (self.length(i),), generator=gen, device=device)


def make(mix: Dict, seed: int, vocab: int) -> Requests:
    return Requests(mix, seed, vocab)
