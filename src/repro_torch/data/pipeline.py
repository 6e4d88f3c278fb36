"""Deterministic synthetic data pipeline with merge-path length packing.

The counterpart of the reference's ``repro/data/pipeline.py``: the same
numpy draws from the same seeds give the same batches.  Per-host shards
are deterministic in ``(seed, host_id, step)``, so a run restored to step
``k`` regenerates with ``batch_at(k)`` exactly the batch the failed run
would have seen.  Documents have a synthetic length distribution; a batch
is assembled by **length-sorted packing**: the document pool is sorted by
length, longest first, with the port's merge-path sort
(:func:`repro_torch.core.merge_sort_kv`, on the host's CPU as the
reference's runs) and packed greedily into rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import merge_sort_kv


@dataclasses.dataclass
class PipelineConfig:
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    pack: bool = True
    mean_doc_len: int = 512


class SyntheticLMPipeline:
    """Yields ``{"tokens", "labels"}`` int32 numpy batches ``(batch, seq_len)``;
    indexable by step."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int, pcfg: PipelineConfig):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.pcfg = pcfg

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.pcfg.seed * 1_000_003 + self.pcfg.host_id) * 1_000_003 + step)

    def _doc_lengths(self, rng: np.random.Generator, n: int) -> np.ndarray:
        lens = rng.geometric(1.0 / self.pcfg.mean_doc_len, size=n).clip(8, self.seq_len)
        return lens.astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        b, s = self.batch, self.seq_len
        if not self.pcfg.pack:
            toks = rng.integers(1, self.cfg.vocab_size, size=(b, s + 1), dtype=np.int64)
            return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
        # merge-path length-sorted packing: longest first (the keys are the
        # negated lengths, which lie in [8, seq_len]: no overflow)
        pool = self._doc_lengths(rng, 2 * b * max(1, s // self.pcfg.mean_doc_len))
        keys = torch.from_numpy(np.negative(pool))
        _, order = merge_sort_kv(keys, torch.arange(pool.shape[0], dtype=torch.int32))
        rows = np.full((b, s + 1), 0, dtype=np.int64)
        row_fill = np.zeros(b, dtype=np.int64)
        # longest-first first-fit: the sorted order makes this near-optimal
        for di in order.numpy():
            n = int(pool[di])
            target = int(np.argmin(row_fill))
            if row_fill[target] + n > s + 1:
                continue
            seg = rng.integers(1, self.cfg.vocab_size, size=n, dtype=np.int64)
            rows[target, row_fill[target]:row_fill[target] + n] = seg
            row_fill[target] += n
            if row_fill.min() >= s + 1:
                break
        labels = rows[:, 1:].copy()
        labels[labels == 0] = -1  # mask padding
        return {"tokens": rows[:, :-1].astype(np.int32), "labels": labels.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Host-side description of one batch: ``{"tokens", "labels"}`` shapes."""
    return {"tokens": (shape.global_batch, shape.seq_len), "labels": (shape.global_batch, shape.seq_len)}
