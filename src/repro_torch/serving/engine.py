"""Batched inference engine scheduled by DIANA queues.

Requests enter the §X multilevel feedback queues (a serving tenant =
a grid user; per-user quota economy). Each engine cycle forms a batch
from the highest-priority requests (FCFS on ties, §X), prefills, and
decodes the batch to completion — non-preemptive, exactly the paper's
execution rule ("once a job starts execution we do not move it").
Bulk submissions arrive as §VIII groups: every member shares a group
id and priority, so groups naturally batch together.

Iteration batching is lockstep (one shared position stream per batch):
``decode_step`` takes one position for the whole batch, so requests in a
batch share a prompt length (bulk jobs "have similar characteristics",
§VII). The prefill is a lockstep decode over the prompt, as in the
reference (``repro.serving.engine``); empty slots decode zeros. The
step runs eagerly on the engine's device and updates the KV cache in
place. As in the reference, a batch starts from the cache the last one
left: stale attention rows are masked by position, while the hybrid's
RG-LRU state and the ssm's Mamba-2 state carry over (the reference's
engine resets neither). Its caches are built without image or audio
embeddings, so vlm and encdec models raise here, as they do there.

Data locality: prompts seen before are prefix-cache hits with zero
data-transfer cost — the term the grid layer feeds into DIANA's DTC.

With ``repro_torch.tracing`` on, a submission, a cycle and its parts, and
each lockstep step's launch, readback and bookkeeping record spans, and a
request its ``first_token`` mark on the host clock; ``first_token_time``
and ``finish_time`` stay the engine's logical clock, as the reference's.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..core import Job, MultilevelFeedbackQueues
from ..models import LM, decode

__all__ = ["InferenceRequest", "ServingEngine", "EngineStats"]

_rid = itertools.count()


@dataclass
class InferenceRequest:
    user: str
    prompt: np.ndarray                  # (P,) int32
    max_new_tokens: int = 16
    rid: int = field(default_factory=lambda: next(_rid))
    group_id: Optional[str] = None
    submit_time: float = 0.0
    generated: list = field(default_factory=list)
    done: bool = False
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None


@dataclass
class EngineStats:
    served: int = 0
    decode_steps: int = 0
    batches: int = 0
    prefix_hits: int = 0
    cycles: int = 0
    truncated: bool = False             # hit max_cycles with requests still queued


class ServingEngine:
    """One engine: ``num_slots`` decode lanes over one KV cache, on the
    model's device (the CUDA card unless the model was built elsewhere)."""

    def __init__(self, lm: LM, num_slots: int = 4, max_len: int = 256,
                 quotas: Optional[dict[str, float]] = None):
        self.lm = lm
        self.num_slots = num_slots
        self.max_len = max_len
        self.queues = MultilevelFeedbackQueues(quotas=quotas or {})
        self.cache = decode.init_cache(lm, num_slots, max_len)
        self.pending: dict[int, InferenceRequest] = {}
        self.prefix_cache: set[bytes] = set()
        self.stats = EngineStats()
        self._clock = 0.0

    # -- admission -------------------------------------------------------------
    def submit(self, req: InferenceRequest, now: float = 0.0):
        job = Job(user=req.user, t=1.0, submit_time=now,
                  compute_work=float(req.max_new_tokens),
                  input_bytes=float(req.prompt.nbytes), group_id=req.group_id)
        job.job_id = req.rid
        self.pending[req.rid] = req
        self.queues.submit(job, now=now)

    def submit_group(self, reqs: list[InferenceRequest], now: float = 0.0):
        """§VIII: a bulk burst shares one group id (and thus priority)."""
        with tracing.span("engine.submit", requests=len(reqs)):
            gid = reqs[0].group_id or f"grp{reqs[0].rid}"
            for r in reqs:
                r.group_id = gid
                self.submit(r, now)

    def queue_depth(self) -> int:
        return len(self.queues)

    def jobs_ahead(self, priority: float) -> int:
        return self.queues.jobs_ahead(priority)

    # -- execution ---------------------------------------------------------------
    def _form_batch(self, now: float) -> list[InferenceRequest]:
        batch: list[InferenceRequest] = []
        plen = None
        skipped: list[Job] = []
        while len(batch) < self.num_slots and len(self.queues):
            job = self.queues.pop_next(now=now)
            req = self.pending[job.job_id]
            if plen is None:
                plen = len(req.prompt)
            if len(req.prompt) != plen:
                skipped.append(job)      # different shape class → next batch
                continue
            del self.pending[job.job_id]
            batch.append(req)
        for job in skipped:              # requeue preserved (FCFS keeps order)
            self.queues.jobs.append(job)
        return batch

    def _step(self, tokens: np.ndarray, pos: int) -> torch.Tensor:
        """One lockstep decode step → logits (B, 1, V) on the device."""
        with tracing.span("step.launch"):
            t = torch.from_numpy(tokens).to(device=self.lm.device, dtype=torch.int64)
            logits, self.cache = decode.decode_step(self.lm, t, self.cache, pos)
            return logits

    @staticmethod
    def _greedy(logits: torch.Tensor) -> np.ndarray:
        """The first-index argmax of every slot, on the host."""
        with tracing.span("step.readback"):
            return torch.argmax(logits[:, 0], dim=-1).to(torch.int32).cpu().numpy()

    def _decode_batch(self, batch: list[InferenceRequest]):
        B = self.num_slots
        plen = len(batch[0].prompt)
        prompts = np.zeros((B, plen), np.int32)
        for i, r in enumerate(batch):
            prompts[i] = r.prompt
            if r.prompt.tobytes() in self.prefix_cache:
                self.stats.prefix_hits += 1
            self.prefix_cache.add(r.prompt.tobytes())
        # prefill: lockstep decode over the prompt (pos resets per batch;
        # stale cache beyond pos is masked out)
        logits = None
        with tracing.span("engine.prefill"):
            for t in range(plen):
                logits = self._step(prompts[:, t : t + 1], t)
        with tracing.span("engine.generate"):
            nxt = self._greedy(logits)
            pos = plen
            live = {i: r for i, r in enumerate(batch)}
            with tracing.span("step.bookkeep"):
                for i, r in live.items():
                    r.generated.append(int(nxt[i]))
                    r.first_token_time = self._clock
                    tracing.mark(r.rid, "first_token")
            while live and pos < self.max_len - 1:
                nxt = self._greedy(self._step(nxt[:, None], pos))
                self.stats.decode_steps += 1
                pos += 1
                with tracing.span("step.bookkeep"):
                    for i in list(live):
                        r = live[i]
                        r.generated.append(int(nxt[i]))
                        if len(r.generated) >= r.max_new_tokens:
                            r.done = True
                            r.finish_time = self._clock
                            self.stats.served += 1
                            del live[i]
            for r in list(live.values()):    # hit max_len
                r.done = True
                r.finish_time = self._clock
                self.stats.served += 1

    def step(self, now: Optional[float] = None) -> int:
        """One engine cycle: form a batch by DIANA priority and run it."""
        self._clock = now if now is not None else self._clock + 1.0
        with tracing.span("engine.step") as sp:
            with tracing.span("engine.form_batch"):
                batch = self._form_batch(self._clock)
            if not batch:
                return 0
            sp.set(batch=self.stats.batches, lanes=len(batch), plen=len(batch[0].prompt))
            self.stats.batches += 1
            self._decode_batch(batch)
            return len(batch)

    def run_until_drained(
        self, max_cycles: int = 1000, on_truncation: str = "raise"
    ) -> EngineStats:
        """Cycle until the queues drain or ``max_cycles`` is hit.

        Hitting the cap with requests still queued is never silent:
        ``on_truncation="raise"`` (default) raises RuntimeError, while
        ``"flag"`` returns stats with ``truncated=True`` so batch
        harnesses can record the partial run.
        """
        if on_truncation not in ("raise", "flag"):
            raise ValueError(f"on_truncation must be 'raise' or 'flag', got {on_truncation!r}")
        for _ in range(max_cycles):
            if not len(self.queues):
                break
            self.step()
            self.stats.cycles += 1
        if len(self.queues):
            self.stats.truncated = True
            if on_truncation == "raise":
                raise RuntimeError(
                    f"run_until_drained truncated: {len(self.queues)} request(s) "
                    f"still queued after max_cycles={max_cycles} "
                    f"(served={self.stats.served}); raise max_cycles or pass "
                    f"on_truncation='flag' to accept partial stats"
                )
        return self.stats
