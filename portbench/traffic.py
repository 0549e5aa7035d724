"""The one traffic generator: a mix is a data file, ``traffic/<name>.json``.

Keys of a mix (every length in tokens, every time in seconds):

  loop            "closed": every tenant keeps ``groups_queued`` groups
                  waiting; a group is submitted when one of the tenant's
                  waiting groups has been taken into a batch.
                  "open": groups arrive on a schedule, whatever the engine does.
  tenants, quota  the number of tenants (grid users) and each one's §X quota
  tenant_zipf_s   open loop: a group's tenant is drawn with odds ∝ 1/(i+1)^s
  group_size      [lo, hi]: requests a group (one §VIII bulk submission)
  prompt_len      the prompt lengths; a group takes one, with equal odds
  output_len      tokens generated a request (greedy)
  rate_rps        open loop: requests offered a second
  schedule_seed   open loop: the seed of the arrival times and of the
                  multiset of (group size, prompt length) pairs
  horizon_s       open loop: how far the schedule reaches
  lead_in_s       open loop: the schedule starts this long before the
                  window opens (after set-up), so that the window finds
                  the queue as the traffic keeps it
  slots, max_len  the engine's batch lanes and cache length

Every seed gets the same work. The open loop replays one schedule, drawn
from ``schedule_seed``: the arrival times (a Poisson process of groups at
rate_rps / mean group size) and each arrival's group size, prompt length
and tenant (with the Zipf odds). ``--seed`` draws every prompt's tokens
(and the harness the weights). The closed loop's sizes are fixed; the
seed draws the tokens.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["Group", "Traffic", "load_mix", "seed_rng"]


def load_mix(root: Path, name: str) -> dict:
    return json.loads((root / "portbench" / "traffic" / f"{name}.json").read_text())


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """NumPy's generator for ``seed`` (any whole number) and a stream id."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


@dataclass
class Group:
    gid: str
    user: str
    due: float                  # on the traffic's clock (s); the window opens at or after 0
    prompts: np.ndarray         # (size, prompt_len) int32
    output_len: int


class Traffic:
    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.vocab = vocab
        self.users = [f"tenant{i}" for i in range(mix["tenants"])]
        self._tokens = seed_rng(seed, 1)
        self._count = 0
        self._queue: list[tuple[float, int, int, str]] = []    # open loop: (due, size, prompt_len, user)
        if mix["loop"] == "open":
            self._queue = self._schedule()
        elif mix["loop"] != "closed":
            raise ValueError(f"traffic loop {mix['loop']!r} is not 'closed' or 'open'")

    # -- what every mix has ----------------------------------------------------
    def quotas(self) -> dict[str, float]:
        return {u: float(self.mix["quota"]) for u in self.users}

    def _group(self, user: str, due: float, size: int, plen: int) -> Group:
        self._count += 1
        prompts = self._tokens.integers(0, self.vocab, (size, plen), dtype=np.int64).astype(np.int32)
        return Group(f"{user}-g{self._count}", user, due, prompts, int(self.mix["output_len"]))

    # -- closed loop -------------------------------------------------------------
    def refill(self, now: float, waiting: dict[str, int]) -> list[Group]:
        """Closed loop: the groups that bring every tenant back to
        ``groups_queued`` waiting groups (``waiting`` counts them), in
        tenant order."""
        lo, hi = self.mix["group_size"]
        if lo != hi or len(self.mix["prompt_len"]) != 1:
            raise ValueError("a closed loop takes one group size and one prompt length")
        out = []
        for u in self.users:
            for _ in range(self.mix["groups_queued"] - waiting.get(u, 0)):
                out.append(self._group(u, now, lo, self.mix["prompt_len"][0]))
        return out

    # -- open loop -----------------------------------------------------------------
    def _schedule(self) -> list[tuple[float, int, int, str]]:
        mix = self.mix
        lo, hi = mix["group_size"]
        sched = np.random.default_rng(mix["schedule_seed"])
        mean_gap = (lo + hi) / 2 / mix["rate_rps"]
        n = int(mix["horizon_s"] / mean_gap * 1.5) + 16
        due = np.cumsum(sched.exponential(mean_gap, n))
        due = due[due < mix["horizon_s"]]
        t0 = -float(mix.get("lead_in_s", 0.0))
        sizes = sched.integers(lo, hi + 1, len(due))
        plens = sched.choice(np.asarray(mix["prompt_len"]), len(due))
        w = 1.0 / np.arange(1, len(self.users) + 1) ** mix.get("tenant_zipf_s", 0.0)
        users = sched.choice(len(self.users), len(due), p=w / w.sum())
        return [(t0 + float(t), int(s), int(p), self.users[u]) for t, s, p, u in zip(due, sizes, plens, users)][::-1]

    def due(self, now: float) -> list[Group]:
        """Open loop: the groups due at or before ``now``, oldest first."""
        out = []
        while self._queue and self._queue[-1][0] <= now:
            t, size, plen, user = self._queue.pop()
            out.append(self._group(user, t, size, plen))
        return out

    def next_due(self) -> float | None:
        return self._queue[-1][0] if self._queue else None
