"""A plain re-derivation of the §X queues' batches, in NumPy and Python.

It replays what the benchmark did to the engine (every submission, every
call that formed a batch) against the paper's rules and predicts each
batch, lane by lane:

- every arrival re-prioritises every waiting request (§X): for a request
  of user u needing t processors (t = 1 here), N = (q·T)/(Q·t), with q
  u's quota, Q the quotas of the distinct users waiting, T the
  processors all waiting requests need, n u's waiting requests (the new
  one included); Pr = (N − n)/N if n ≤ N, else (N − n)/n. Taking
  requests into a batch re-prioritises nothing;
- a batch takes the waiting requests in order of priority, highest
  first, first come first served among equals (by submission time, then
  by order of submission), skipping those whose prompt length differs
  from the first one's, until its lanes are full.
"""
from __future__ import annotations

__all__ = ["replay"]


def replay(events: list[tuple], slots: int) -> list[list[int]]:
    """``events``: ("submit", rid, user, quota, time, prompt_len) and
    ("batch",) in the order they happened → the predicted batches, each
    the rids in lane order (an empty list where no request waited)."""
    waiting: list[dict] = []
    quotas: dict[str, float] = {}
    batches = []
    for ev in events:
        if ev[0] == "submit":
            _, rid, user, quota, t, plen = ev
            quotas.setdefault(user, quota)
            waiting.append({"rid": rid, "user": user, "time": t, "plen": plen, "pr": 0.0})
            n_user: dict[str, int] = {}
            for j in waiting:
                n_user[j["user"]] = n_user.get(j["user"], 0) + 1
            Q = sum(quotas[u] for u in n_user)
            T = float(len(waiting))
            for j in waiting:
                N = (quotas[j["user"]] * T) / (Q * 1.0)
                n = n_user[j["user"]]
                j["pr"] = (N - n) / N if n <= N else (N - n) / n
        else:
            order = sorted(waiting, key=lambda j: (-j["pr"], j["time"], j["rid"]))
            batch = []
            for j in order:
                if len(batch) == slots:
                    break
                if batch and j["plen"] != batch[0]["plen"]:
                    continue
                batch.append(j)
            taken = {j["rid"] for j in batch}
            waiting = [j for j in waiting if j["rid"] not in taken]
            batches.append([j["rid"] for j in batch])
    return batches
