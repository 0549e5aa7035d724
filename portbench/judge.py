"""The comparisons that decide ``correct``, once the window has closed.

1. The queues: ``queue_ref.replay`` re-derives every batch the engine
   formed (the §X priorities, first come first served among equals, one
   prompt length a batch); ``batches_wrong`` counts the batches whose
   requests or lane order differ. The lane order is read from the token
   ids the model was fed (``window.StepTap``): lane j's first prompt-length
   tokens are its request's prompt. Limit 0.
2. What was fed: ``fed_wrong`` counts the requests whose lane was not fed
   its prompt and then its own served tokens, at positions 0, 1, …, or
   whose count of tokens or whose ids (outside the vocabulary) are wrong.
   Limit 0.
3. The model: a sample of the window's batches drawn from the seed (a
   batch of the longest prompt first), each run through the plain
   reference (``reference.Reference``, float32) over the token ids its
   lanes were fed: every lane where the experts couple the lanes (one
   dispatch a position), else a sample of its requests. ``token_gap`` is
   the widest gap, over every served token of the judged requests, by
   which the reference's logit of the served token lies below its best
   logit there; ``token_miss`` the share of those tokens that the
   reference does not put first; ``lane_gap_mean_max`` the largest mean
   gap of one judged lane (one request's served tokens), its ``trim``
   largest gaps left out (the limits file's ``sample.trim``, 0 where it
   gives none), so that a single lane gone wrong among many shows. A cell compares those of the three that
   its ``limits/<cell>.json`` gives a limit, the limit set from the
   readings the file records beside it.

A batch for which no ``decode_step`` call was seen has no lanes to
compare: each of its requests counts in ``fed_wrong``.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from .queue_ref import replay
from .traffic import seed_rng

__all__ = ["lanes", "check_queue", "check_model", "gaps"]


def lanes(torch, rec, i: int, device) -> torch.Tensor:
    """The token ids batch ``i``'s lanes were fed, (B, steps), on ``device``."""
    return torch.cat([t.reshape(-1, 1) for _, t in rec.batches[i].calls], dim=1).to(device)


def check_queue(torch, rec, vocab: int) -> tuple[dict, list[list[int]]]:
    """(numbers, the predicted batches): ``batches_wrong`` and ``fed_wrong``."""
    pred = replay(rec.events, rec.slots)
    wrong = fed = 0
    for i, b in enumerate(rec.batches):
        p = pred[i] if i < len(pred) else []
        if set(p) != set(b.rids) or len(p) != len(b.rids):
            wrong += 1
            continue
        if [c[0] for c in b.calls] != list(range(b.steps)):
            fed += len(p)               # no step seen, or steps at other positions
            continue
        seen = lanes(torch, rec, i, "cpu").numpy()
        for j, rid in enumerate(p):
            r = rec.requests[rid]
            gen = np.asarray(r.obj.generated, np.int64)
            if len(gen) != r.output_len or gen.min() < 0 or gen.max() >= vocab:
                fed += 1
                continue
            want = np.concatenate([r.prompt, gen[:-1]])
            if len(want) != b.steps or not np.array_equal(seen[j], want):
                if not np.array_equal(seen[j, :len(r.prompt)], r.prompt):
                    wrong += 1          # another request's prompt in this lane: the order differs
                    break
                fed += 1
    return {"batches_wrong": wrong, "fed_wrong": fed}, pred


def gaps(torch, ref, tokens: torch.Tensor, served: torch.Tensor, control=None, block: int = 8) -> dict:
    """Per served token, the reference's best logit minus its logit of the
    served token (``served`` ≥ 0 marks the positions judged), and its lane
    (row of ``tokens``); with ``control`` (a lower-precision reference)
    also the gap of the token the control puts first, read on the
    reference's logits."""
    h = ref.hidden(tokens)
    hc = control.hidden(tokens) if control is not None else None
    table = ref.head_table()
    table_c = control.head_table() if control is not None else None
    rows = torch.arange(tokens.shape[0], device=tokens.device)[:, None].expand_as(served)
    out = {"gap": [], "lane": [], "control_gap": []}
    for s in range(0, tokens.shape[0], block):
        mask = served[s:s + block] >= 0
        if not bool(mask.any()):
            continue
        lg = ref.logits(h[s:s + block], table)                        # (b, L, V)
        best = lg.amax(-1)
        pick = lg.gather(-1, served[s:s + block].clamp(min=0)[..., None])[..., 0]
        out["gap"].append((best - pick)[mask])
        out["lane"].append(rows[s:s + block][mask])
        if hc is not None:
            first = control.logits(hc[s:s + block], table_c).argmax(-1)
            out["control_gap"].append((best - lg.gather(-1, first[..., None])[..., 0])[mask])
        del lg
    return {k: torch.cat(v).cpu().numpy() if v else np.zeros(0) for k, v in out.items()}


def sample_batches(rec, n: int, seed: int) -> list[int]:
    """n of the window's batches, drawn from the seed, one of the longest prompt first."""
    pool = [i for i in range(rec.first, rec.n_window) if rec.batches[i].rids]
    if not pool:
        return []
    rng = seed_rng(seed, 4)
    longest = max(rec.batches[i].plen for i in pool)
    first = [i for i in pool if rec.batches[i].plen == longest]
    pick = [first[int(rng.integers(len(first)))]]
    rest = [i for i in pool if i != pick[0]]
    pick += [rest[j] for j in rng.permutation(len(rest))[:max(0, n - 1)]]
    return pick


def judged(torch, rec, i: int, predicted: list[int], spec: dict, moe: bool, seed: int, device):
    """(lane tokens, served tokens with −1 where not judged) of batch ``i``: all
    lanes where the experts couple them, else ``spec["lanes"]`` of its requests."""
    b = rec.batches[i]
    tokens = lanes(torch, rec, i, device)
    served = torch.full_like(tokens, -1)
    rows = list(range(len(predicted)))
    if not moe and spec.get("lanes") and len(rows) > spec["lanes"]:
        rows = sorted(seed_rng(seed, 5 + i).permutation(len(rows))[:spec["lanes"]].tolist())
    for j in rows:
        gen = rec.requests[predicted[j]].obj.generated
        served[j, b.plen - 1:b.plen - 1 + len(gen)] = torch.as_tensor(gen, device=device)
    keep = list(range(tokens.shape[0])) if moe else rows
    return tokens[keep], served[keep]


def check_model(torch, ref, rec, predicted: list[list[int]], spec: dict, moe: bool, seed: int, device,
                control=None) -> dict:
    """``token_gap``, ``token_miss`` and ``lane_gap_mean_max`` (and the served
    tokens compared) over the sampled batches."""
    out = {"gap": [], "lane": [], "control_gap": []}
    lanes_before = 0
    for i in sample_batches(rec, spec["batches"], seed):
        if [c[0] for c in rec.batches[i].calls] != list(range(rec.batches[i].steps)):
            continue                    # nothing to compare: ``fed_wrong`` has counted it
        t0 = time.perf_counter()
        tokens, served = judged(torch, rec, i, predicted[i], spec, moe, seed, device)
        g = gaps(torch, ref, tokens, served, control)
        g["lane"] = g["lane"] + lanes_before
        lanes_before += tokens.shape[0]
        print(f"judge: batch {i}, {tokens.shape[0]} lanes x {tokens.shape[1]} positions, {g['gap'].size} tokens "
              f"compared, {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
        for k in out:
            out[k].append(g[k])
    cat = {k: np.concatenate(v) if v else np.zeros(0) for k, v in out.items()}
    trim = int(spec.get("trim", 0))
    res = {**_numbers(cat["gap"], cat["lane"], trim), "tokens_compared": int(cat["gap"].size),
           "gaps": cat["gap"], "lanes": cat["lane"]}
    if control is not None:
        res["control"] = _numbers(cat["control_gap"], cat["lane"], trim)
        res["control_gaps"] = cat["control_gap"]
    return res


def lane_gap_means(g: np.ndarray, lane: np.ndarray, trim: int) -> np.ndarray:
    """Each lane's mean gap, its ``trim`` largest gaps left out."""
    means = []
    for i in np.unique(lane):
        x = np.sort(g[lane == i])
        means.append(x[:max(1, x.size - trim)].mean())
    return np.asarray(means)


def _numbers(g: np.ndarray, lane: np.ndarray, trim: int = 0) -> dict:
    """``token_gap``, the widest gap; ``token_miss``, the share of served
    tokens that the reference does not put first (gap > 0); and
    ``lane_gap_mean_max``, the largest trimmed mean gap of one lane.
    Infinite where nothing was compared."""
    if not g.size:
        return {"token_gap": float("inf"), "token_miss": float("inf"), "lane_gap_mean_max": float("inf")}
    return {"token_gap": float(g.max()), "token_miss": float((g > 0).mean()),
            "lane_gap_mean_max": float(lane_gap_means(g, lane, trim).max())}
