"""Rows of packed documents for training, the same rows for every seed.

The mix file gives the row length ``row``, the rows of one cycle
``rows``, and the document lengths: a lognormal of mean ``mean`` and
shape ``sigma`` clipped to ``[min, max]``.  The documents are the most
quantiles of that distribution whose first-fit-decreasing packing fills
``rows`` rows to at most ``fill`` of their length, and each row's space
left over, where it is at least ``min``, takes one more document of that
length; the packing does not depend on the seed.  The rows of each
cycle and the documents inside each row are ordered by the mix's
``order_seed`` where it gives one (every run the same rows), else by the
run's seed; the run's seed draws the tokens (uniform over ``[1,
vocab)``).  A document's labels are its next tokens; its last token and
the padding at a row's end are masked (label -1).  Step ``i`` takes rows
``i * batch ... i * batch + batch - 1`` of the stream.
"""

from __future__ import annotations

import math
import random
from statistics import NormalDist
from typing import Dict, List

import torch


def doc_lengths(mix: Dict, n: int) -> List[int]:
    sigma = mix["sigma"]
    median = mix["mean"] / math.exp(sigma * sigma / 2)
    nd = NormalDist()
    out = [int(round(median * math.exp(sigma * nd.inv_cdf((i + 0.5) / n)))) for i in range(n)]
    return [min(mix["max"], max(mix["min"], x)) for x in out]


def _ffd(docs: List[int], row: int) -> List[List[int]]:
    bins: List[List[int]] = []
    free: List[int] = []
    for d in sorted(docs, reverse=True):
        for j, f in enumerate(free):
            if d <= f:
                bins[j].append(d)
                free[j] -= d
                break
        else:
            bins.append([d])
            free.append(row - d)
    return bins


def pack(mix: Dict) -> List[List[int]]:
    """The rows of one cycle, each a list of document lengths."""
    row, rows = mix["row"], mix["rows"]
    best = None
    n = rows
    while True:
        docs = doc_lengths(mix, n)
        if sum(docs) > mix["fill"] * row * rows:
            break
        bins = _ffd(docs, row)
        if len(bins) <= rows:
            best = bins
        n += 1
    if best is None or len(best) < rows:
        raise ValueError("the mix does not fill its rows")
    for docs in best:
        free = row - sum(docs)
        if free >= mix["min"]:
            docs.append(free)
    return best


class Batches:
    def __init__(self, mix: Dict, seed: int, vocab: int, batch: int):
        self.mix, self.seed, self.vocab, self.batch = mix, seed, vocab, batch
        self.rows = pack(mix)
        self._rng = random.Random(mix.get("order_seed", seed))
        self._order: List[List[int]] = []  # per row of the stream: its documents in order
        self._cache: Dict[int, torch.Tensor] = {}

    def _row(self, r: int) -> List[int]:
        while len(self._order) <= r:
            perm = list(range(len(self.rows)))
            self._rng.shuffle(perm)
            for j in perm:
                docs = list(self.rows[j])
                self._rng.shuffle(docs)
                self._order.append(docs)
        return self._order[r]

    def label_tokens(self, i: int) -> int:
        """The unmasked labels of step ``i``."""
        return sum(d - 1 for r in range(i * self.batch, (i + 1) * self.batch) for d in self._row(r))

    def _masks(self, i: int, device) -> torch.Tensor:
        """``(2, batch, row)``: which labels count and which tokens pad, of
        step ``i``; built on the host for 256 steps at a time and copied
        once, so that a step copies nothing from the host."""
        block = i // 256
        if block not in self._cache:
            row = self.mix["row"]
            m = torch.zeros((256, 2, self.batch, row), dtype=torch.bool)
            for s in range(256):
                for b in range(self.batch):
                    start = 0
                    for d in self._row((block * 256 + s) * self.batch + b):
                        m[s, 0, b, start:start + d - 1] = True  # a document's last token predicts nothing
                        start += d
                    m[s, 1, b, start:] = True
            self._cache[block] = m.to(device)
        return self._cache[block][i % 256]

    def batch_at(self, i: int, device) -> Dict[str, torch.Tensor]:
        row = self.mix["row"]
        gen = torch.Generator(device=device)
        gen.manual_seed((self.seed * 1_000_003 + i) % (1 << 63))
        tokens = torch.randint(1, self.vocab, (self.batch, row), generator=gen, device=device)
        keep, pad = self._masks(i, device)
        tokens = tokens.masked_fill(pad, 0)
        labels = torch.roll(tokens, -1, dims=1).masked_fill(~keep, -1)
        return {"tokens": tokens, "labels": labels}


def make(mix: Dict, seed: int, vocab: int, batch: int) -> Batches:
    return Batches(mix, seed, vocab, batch)
