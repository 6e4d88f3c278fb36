"""Batched serving engine: slot-based continuous batching.

The PyTorch counterpart of the reference's ``repro/serving/engine.py``.
A fixed pool of ``batch`` slots; free slots are refilled from the request
queue (prefill), and all occupied slots decode in lockstep, one decode
step per tick.  Per-slot absolute positions make the lockstep correct for
ragged prompt lengths.  Sampled requests (``temperature > 0``) draw from
the merge-path top-k sampler with ``backend="kernel"``, so on the card
every sampled token goes through the K4 sort-round kernel.

Graceful degradation, as in the reference: every submitted request ends
in ``engine.done`` with an explicit terminal ``status`` —

* ``completed`` — generated ``max_new_tokens`` (or hit the sequence cap);
* ``timed_out`` — exceeded its ``deadline_ticks`` budget, or the engine ran
  out of ``run_until_done`` ticks, with its partial tokens kept;
* ``shed`` — rejected at ``submit`` because the queue was full
  (``max_pending``), or never scheduled before the tick budget ran out;
* ``failed`` — the decode step failed ``max_retries`` consecutive times
  while the request was in flight.

A failed tick backs off for ``min(backoff_base * 2**(streak-1),
backoff_cap)`` ticks and retries; every retry is counted in
``ServingReport.retries``, so a run with a faulting kernel never reports
``ok()`` with zero retries.  A fault plan can fail a tick's decode
(``launch:serving.decode:<ticks>``, :mod:`repro_torch.runtime.faults`),
as in the reference.  All timing is counted in engine ticks, never
wall clock, so every degradation path replays exactly.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward_decode, init_caches
from repro_torch.models.transformer import _dtype
from repro_torch.runtime import faults as _faults
from repro_torch.telemetry import WALL, TickClock, get_telemetry
from repro_torch.train.steps import _cast

from . import sampler as sampler_mod


class ServingWarning(RuntimeWarning):
    """A request ended other than ``completed``, or a decode tick was retried."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (L,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0  # 0 => greedy
    topk: int = 40
    deadline_ticks: Optional[int] = None  # tick budget from submission; None = no deadline
    # outputs
    generated: Optional[List[int]] = None
    status: str = "pending"  # pending | completed | timed_out | shed | failed
    reason: str = ""


@dataclasses.dataclass
class ServingReport:
    """Outcome summary returned by :meth:`ServingEngine.run_until_done`."""

    ticks: int = 0
    completed: int = 0
    timed_out: int = 0
    shed: int = 0
    failed: int = 0
    retries: int = 0
    statuses: Dict[int, str] = dataclasses.field(default_factory=dict)
    reasons: Dict[int, str] = dataclasses.field(default_factory=dict)
    telemetry: Dict[str, object] = dataclasses.field(default_factory=dict)

    def ok(self) -> bool:
        """True when no request timed out, was shed or failed."""
        return self.timed_out == 0 and self.shed == 0 and self.failed == 0


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        batch: int,
        max_seq: int,
        seed: int = 0,
        max_pending: Optional[int] = None,
        max_retries: int = 3,
        backoff_base: int = 1,
        backoff_cap: int = 8,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _cast(params, _dtype(cfg))
        self.batch = batch
        self.max_seq = max_seq
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.caches = init_caches(cfg, batch, max_seq, device=self.device)
        self.pos = np.zeros(batch, np.int64)
        self.active: List[Optional[Request]] = [None] * batch
        self.pending: List[Request] = []
        self.done: Dict[int, Request] = {}
        self.max_pending = max_pending
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.ticks = 0
        self.retries = 0
        self._cooldown = 0
        self._fail_streak = 0
        # while the engine steps, telemetry timestamps count engine ticks
        self.tick_clock = TickClock()

    def _decode(self, token: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        tok = torch.as_tensor(token, dtype=torch.int64).to(self.device)
        p = torch.as_tensor(pos, dtype=torch.int64).to(self.device)
        logits, self.caches = forward_decode(self.cfg, self.params, self.caches, tok, p)
        return logits

    # -- request lifecycle ------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request — or shed it, loudly, when the queue is full."""
        req.generated = []
        req._submit_tick = self.ticks
        if self.max_pending is not None and len(self.pending) >= self.max_pending:
            self._finish(req, "shed", f"queue full (max_pending={self.max_pending})")
            return
        req.status = "pending"
        self.pending.append(req)

    def _finish(self, req: Request, status: str, reason: str = "") -> None:
        req.status = status
        req.reason = reason
        if req.generated is None:
            req.generated = []
        self.done[req.uid] = req
        if status != "completed":
            warnings.warn(
                f"serving: request {req.uid} {status}" + (f" ({reason})" if reason else ""),
                ServingWarning,
                stacklevel=4,
            )

    def _expire_deadlines(self) -> None:
        """Terminate (loudly) every request past its tick budget."""
        for slot in range(self.batch):
            req = self.active[slot]
            if req is not None and self._past_deadline(req):
                self._finish(req, "timed_out", f"deadline_ticks={req.deadline_ticks} exceeded")
                self.active[slot] = None
        kept = []
        for req in self.pending:
            if self._past_deadline(req):
                self._finish(req, "timed_out", f"deadline_ticks={req.deadline_ticks} in queue")
            else:
                kept.append(req)
        self.pending = kept

    def _past_deadline(self, req: Request) -> bool:
        if req.deadline_ticks is None:
            return False
        return self.ticks - getattr(req, "_submit_tick", 0) >= req.deadline_ticks

    # -- decode -----------------------------------------------------------

    def _fill_slot(self, slot: int, req: Request) -> None:
        """Prefill one request into a slot by stepping its prompt tokens."""
        prompt = req.prompt.astype(np.int64)
        for t, tok in enumerate(prompt):
            token = np.zeros((self.batch, 1), np.int64)
            token[slot, 0] = tok
            pos = np.where(np.arange(self.batch) == slot, t, self.pos)
            logits = self._decode(token, pos)
        self.pos[slot] = len(prompt)
        self.active[slot] = req
        req._next_from_prefill = logits[slot]

    def _sample(self, req: Request, logits_row: torch.Tensor) -> int:
        lrow = logits_row[None]
        if req.temperature <= 0:
            return int(sampler_mod.greedy(lrow)[0])
        tok = sampler_mod.topk_sample(
            lrow, self.generator, k=req.topk, temperature=req.temperature, backend="kernel"
        )
        return int(tok[0])

    def _tick_body(self) -> None:
        """Refill free slots, then one lockstep decode."""
        tel = get_telemetry()
        for slot in range(self.batch):
            if self.active[slot] is None and self.pending:
                req = self.pending.pop(0)
                try:
                    self._fill_slot(slot, req)
                    req.generated.append(self._sample(req, req._next_from_prefill))
                except Exception:
                    # back to the head of the queue, to be prefilled again on
                    # the retry: a failed prefill must not drop the request
                    self.active[slot] = None
                    self.pending.insert(0, req)
                    raise
                tel.histogram("serving.ticks_to_first_token").record(
                    self.ticks - getattr(req, "_submit_tick", 0)
                )
                req._last_tok_tick = self.ticks
        occupied = [s for s in range(self.batch) if self.active[s] is not None]
        # sampled after refill: a request admitted and finished within one
        # tick still counts toward the occupancy it used
        tel.gauge("serving.slot_occupancy").set(len(occupied))
        tel.histogram("serving.slot_occupancy").record(len(occupied))
        if not occupied:
            return
        token = np.zeros((self.batch, 1), np.int64)
        for s in occupied:
            token[s, 0] = self.active[s].generated[-1]
        logits = self._decode(token, self.pos)
        for s in occupied:
            req = self.active[s]
            self.pos[s] += 1
            req.generated.append(self._sample(req, logits[s]))
            tel.histogram("serving.ticks_per_token").record(
                self.ticks - getattr(req, "_last_tok_tick", self.ticks)
            )
            req._last_tok_tick = self.ticks
            if len(req.generated) >= req.max_new_tokens or self.pos[s] >= self.max_seq - 1:
                self._finish(req, "completed")
                self.active[s] = None

    def _on_step_failure(self, err: BaseException) -> None:
        self._fail_streak += 1
        self.retries += 1
        if self._fail_streak > self.max_retries:
            # retry budget spent: end the in-flight requests with their
            # partial tokens, then recover; the queue keeps draining
            for slot in range(self.batch):
                req = self.active[slot]
                if req is not None:
                    self._finish(
                        req, "failed",
                        f"decode failed {self._fail_streak}x: {type(err).__name__}: {err}",
                    )
                    self.active[slot] = None
            self._fail_streak = 0
            self._cooldown = 0
            return
        self._cooldown = min(self.backoff_base * (2 ** (self._fail_streak - 1)), self.backoff_cap)
        warnings.warn(
            f"serving: decode tick failed ({type(err).__name__}: {err}); "
            f"retry {self._fail_streak}/{self.max_retries} after {self._cooldown} tick(s)",
            ServingWarning,
            stacklevel=3,
        )

    def step(self) -> None:
        """One engine tick: expire deadlines, then refill + lockstep decode.

        A tick spent cooling down after a failed decode still advances the
        clock, so a wedged backend cannot stall requests forever.
        """
        self.ticks += 1
        tel = get_telemetry()
        self.tick_clock.advance(self.ticks)
        occupied = sum(a is not None for a in self.active)
        queue_depth = len(self.pending)
        tel.gauge("serving.queue_depth").set(queue_depth)
        tel.histogram("serving.queue_depth").record(queue_depth)
        wall0 = WALL.now()
        with tel.use_clock(self.tick_clock), tel.span(
            "serving.tick", tick=self.ticks, occupied=occupied, queue_depth=queue_depth
        ) as sp:
            self._expire_deadlines()
            if self._cooldown > 0:
                self._cooldown -= 1
                sp.set("cooldown", True)
                tel.counter("serving.cooldown_ticks").add(1)
                return
            idx = _faults.next_index("serving.decode")
            try:
                if _faults.should_fire("launch", "serving.decode", idx, label="decode"):
                    raise _faults.InjectedFault(f"injected launch failure: serving.decode[{idx}]")
                self._tick_body()
            except Exception as err:  # the engine keeps serving; the retry is counted
                sp.set("failed", type(err).__name__)
                self._on_step_failure(err)
                return
            finally:
                # wall time goes to a histogram only, never into the tick-clocked spans
                tel.histogram("serving.tick_wall_us").record(WALL.now() - wall0)
            self._fail_streak = 0

    # -- draining ---------------------------------------------------------

    def _report(self) -> ServingReport:
        rep = ServingReport(ticks=self.ticks, retries=self.retries)
        for uid, req in self.done.items():
            rep.statuses[uid] = req.status
            if req.reason:
                rep.reasons[uid] = req.reason
            if req.status == "completed":
                rep.completed += 1
            elif req.status == "timed_out":
                rep.timed_out += 1
            elif req.status == "shed":
                rep.shed += 1
            elif req.status == "failed":
                rep.failed += 1
        return rep

    def run_until_done(self, max_ticks: int = 10_000) -> ServingReport:
        """Drain the engine; always return a :class:`ServingReport`.

        On hitting ``max_ticks`` no request is abandoned silently: in-flight
        requests are marked ``timed_out`` and still-queued ones ``shed``.
        """
        tel = get_telemetry()
        with tel.use_clock(self.tick_clock), tel.span("serving.run", batch=self.batch):
            for _ in range(max_ticks):
                if not self.pending and all(a is None for a in self.active):
                    break
                self.step()
            else:
                for slot in range(self.batch):
                    req = self.active[slot]
                    if req is not None:
                        self._finish(req, "timed_out", f"engine out of ticks (max_ticks={max_ticks})")
                        self.active[slot] = None
                for req in self.pending:
                    self._finish(req, "shed", f"never scheduled within max_ticks={max_ticks}")
                self.pending = []
        rep = self._report()
        rep.telemetry = {
            name: tel.histogram(f"serving.{name}").stats()
            for name in ("tick_wall_us", "ticks_to_first_token", "ticks_per_token", "slot_occupancy", "queue_depth")
        }
        return rep
