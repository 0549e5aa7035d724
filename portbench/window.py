"""The measured window: the traffic into ``ServingEngine``, and its records.

The window opens once set-up is done and closes at the end of the batch
in progress when ``--seconds`` have passed (``engine.step`` returns only
when its batch is done), or at ``--seconds`` when the engine is idle.
Every time is the host's clock in seconds after the window opened.

What is recorded, all from the benchmark's side of the engine's calls:

- each submission (``engine.submit_group``, one §VIII group) with its
  host time, and the event list that ``queue_ref.replay`` replays;
- each request: when it was due, the batch that served it (the requests
  that a ``step`` call finished are its batch), its tokens;
- each batch: when ``step`` was called and returned, its prompt length,
  the engine's counters before and after;
- the token ids that every ``models.decode.decode_step`` call fed the
  model (``StepTap``), kept on the device, which give each batch's lanes
  in order and the lanes left empty.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

__all__ = ["StepTap", "Request", "Batch", "Record", "Driver"]


class StepTap:
    """Records (position, token ids) of every ``repro_torch.models.decode.decode_step``
    call, the function the engine calls once a lockstep step."""

    def __init__(self):
        import repro_torch.models.decode as dec

        self._mod, self._orig, self.calls = dec, dec.decode_step, []

        def tap(lm, tokens_t, cache, pos, **kw):
            self.calls.append((int(pos), tokens_t))
            return self._orig(lm, tokens_t, cache, pos, **kw)

        dec.decode_step = tap

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls

    def close(self) -> None:
        self._mod.decode_step = self._orig


@dataclass
class Request:
    rid: int
    user: str
    due: float
    prompt: np.ndarray
    output_len: int
    obj: object                        # the engine's InferenceRequest
    batch: int | None = None           # index in Record.batches


@dataclass
class Batch:
    t_call: float
    t_end: float
    rids: list[int]                    # the requests this step finished (its batch), in no order
    plen: int
    calls: list                        # StepTap's (pos, tokens) of its steps
    decode_steps: int                  # EngineStats.decode_steps added
    served: int                        # EngineStats.served added

    @property
    def steps(self) -> int:
        return self.plen + self.decode_steps


@dataclass
class Record:
    slots: int
    requests: dict[int, Request] = field(default_factory=dict)
    batches: list[Batch] = field(default_factory=list)
    submits: list[tuple[float, int]] = field(default_factory=list)     # (host seconds, requests) a call
    events: list[tuple] = field(default_factory=list)
    open_t: float = 0.0                 # when the window opened, on the traffic's clock
    open_wall: float = 0.0              # and on time.perf_counter()'s
    window_s: float = 0.0               # its length
    first: int = 0                      # batches[first:n_window] ran inside the window
    n_window: int = 0
    late_s: float = 0.0                 # open loop: the longest a group waited to be submitted past its due time


class Driver:
    """Feeds one engine from one traffic mix."""

    def __init__(self, engine, traffic, tap: StepTap):
        self.engine, self.traffic, self.tap = engine, traffic, tap
        self.quotas = traffic.quotas()
        self.closed = traffic.mix["loop"] == "closed"
        self._pending: dict[str, int] = {}          # group id → requests not yet served
        self._user_of: dict[str, str] = {}

    def _submit(self, rec: Record, groups, now: float) -> None:
        from repro_torch.serving import InferenceRequest

        for g in groups:
            reqs = [InferenceRequest(user=g.user, prompt=p, max_new_tokens=g.output_len, group_id=g.gid)
                    for p in g.prompts]
            t0 = time.perf_counter()
            self.engine.submit_group(reqs, now=g.due)
            rec.submits.append((time.perf_counter() - t0, len(reqs)))
            rec.late_s = max(rec.late_s, now - g.due)
            self._pending[g.gid] = len(reqs)
            self._user_of[g.gid] = g.user
            for r in reqs:
                rec.requests[r.rid] = Request(r.rid, g.user, g.due, r.prompt, g.output_len, r)
                rec.events.append(("submit", r.rid, g.user, self.quotas[g.user], g.due, len(r.prompt)))

    def _arrivals(self, rec: Record, now: float) -> None:
        if self.closed:
            waiting: dict[str, int] = {}
            for gid, n in self._pending.items():
                if n:
                    waiting[self._user_of[gid]] = waiting.get(self._user_of[gid], 0) + 1
            self._submit(rec, self.traffic.refill(now, waiting), now)
        else:
            self._submit(rec, self.traffic.due(now), now)

    def _step(self, rec: Record, clock, profile=None) -> Batch:
        st = self.engine.stats
        d0, s0 = st.decode_steps, st.served
        open_rids = [rid for rid, r in rec.requests.items() if r.batch is None]
        rec.events.append(("batch",))
        self.tap.take()
        t_call = clock()
        if profile is None:
            self.engine.step(now=t_call)
        else:
            profile(lambda: self.engine.step(now=t_call))
        t_end = clock()
        done = [rid for rid in open_rids if rec.requests[rid].obj.done]
        b = Batch(t_call, t_end, done, len(rec.requests[done[0]].prompt) if done else 0, self.tap.take(),
                  st.decode_steps - d0, st.served - s0)
        for rid in done:
            rec.requests[rid].batch = len(rec.batches)
            gid = rec.requests[rid].obj.group_id
            self._pending[gid] -= 1
        rec.batches.append(b)
        return b

    def run(self, seconds: float) -> Record:
        """The window: arrivals and batches until ``seconds`` have passed.

        An open loop's traffic starts ``lead_in_s`` (of the mix) before
        the window, which opens at the first batch boundary at or after
        time 0, so that the window begins with the queue in its steady
        state; the lead-in is neither set-up nor window. The traffic's
        clock is the window's."""
        rec = Record(slots=self.engine.num_slots)
        lead = 0.0 if self.closed else float(self.traffic.mix.get("lead_in_s", 0.0))
        t0 = time.perf_counter() + lead
        clock = lambda: time.perf_counter() - t0        # noqa: E731
        self._clock = clock
        self._loop(rec, clock, 0.0)
        rec.open_wall = time.perf_counter()
        rec.open_t, rec.first = rec.open_wall - t0, len(rec.batches)
        self._loop(rec, clock, rec.open_t + seconds)
        if not self.closed:
            self._arrivals(rec, clock())                # what came due during the last batch
        rec.window_s = clock() - rec.open_t
        rec.n_window = len(rec.batches)
        return rec

    def _loop(self, rec: Record, clock, until: float) -> None:
        while True:
            now = clock()
            if now >= until:
                return
            self._arrivals(rec, now)
            if not self.engine.queue_depth():
                nxt = self.traffic.next_due()
                time.sleep(max(0.0, min(until if nxt is None else nxt, until) - clock()))
                continue
            self._step(rec, clock)

    def one_more(self, rec: Record, profile) -> Batch:
        """After the window: one more batch of the same traffic, run under ``profile``.
        Its requests join ``rec`` but lie past ``rec.window_s``."""
        clock = self._clock
        while True:
            self._arrivals(rec, clock())
            if self.engine.queue_depth():
                return self._step(rec, clock, profile)
            nxt = self.traffic.next_due()
            if nxt is None:
                raise RuntimeError("the traffic ran out before the traced batch")
            time.sleep(max(0.0, nxt - clock()))
