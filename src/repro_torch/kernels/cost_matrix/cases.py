"""Inputs that hold the float64 cost kernels to their plain versions at
their edges: the fused argmin's screen (estimates that reverse a one-ulp
order, exact ties, NaN and inf cells, the gate switched off, subnormal
and near-overflow costs) and ragged shapes.

Each case is a dict of NumPy arrays in the kernels' packed layout —
``bytes_``/``work`` (J,) float64, ``cls`` (J,) int8 (0 COMPUTE, 1 DATA,
2 BOTH), ``rows`` (8, S) float64 in PACK_FIELDS order (cap, queue, work,
load, bw, loss, rtt, mss), ``alive`` (S,) bool — and the weights ``w``.
Everything is drawn from NumPy generators with fixed seeds.
"""
from __future__ import annotations

import numpy as np
import torch

from .ref import CLASS_BOTH, CLASS_COMPUTE, CLASS_DATA

__all__ = ["ADVERSARIAL", "adversarial", "ragged", "tensors"]

CAP, QUEUE, WORK, LOAD, BW, LOSS, RTT, MSS = range(8)


def ragged(J: int, S: int, seed: int = 0, dead: float = 0.05) -> dict:
    """A random grid in the bulk bench's ranges, all three job classes."""
    rng = np.random.default_rng(seed)
    rows = np.stack([
        rng.integers(50, 2000, S).astype(np.float64),
        rng.integers(0, 50, S).astype(np.float64),
        rng.uniform(0, 500, S),
        rng.uniform(0, 1, S),
        rng.uniform(1e8, 1e10, S),
        np.where(rng.uniform(size=S) < 0.3, 0.0, rng.uniform(1e-4, 0.05, S)),
        rng.uniform(0.005, 0.3, S),
        rng.choice([536.0, 1460.0, 9000.0], S),
    ])
    alive = rng.uniform(size=S) > dead
    alive[rng.integers(0, S)] = True
    return dict(
        bytes_=rng.uniform(0, 30e9, J), work=rng.uniform(0.1, 100, J),
        cls=rng.integers(0, 3, J).astype(np.int8), rows=rows, alive=alive,
        w=(1.0, 1.0, 1.0),
    )


def _ulp_pair(seed: int) -> tuple[float, float, float, float, float]:
    """Two lossless sites (cap_a, load_a), (cap_b, load_b) with no queue
    and a COMPUTE job's work w where the exact cost load + w/cap of b is
    one ulp below a's while the screen's estimates load + w·(1/cap)
    order the other way round."""
    rng = np.random.default_rng(seed)
    while True:
        cap_a, cap_b = rng.uniform(50, 2000, 2)
        load_a, w = rng.uniform(0, 1), rng.uniform(10, 100)
        v_a = load_a + w / cap_a
        target = np.nextafter(v_a, -np.inf)
        load_b = target - w / cap_b
        for _ in range(8):
            v_b = load_b + w / cap_b
            if v_b == target:
                break
            load_b = np.nextafter(load_b, np.inf if v_b < target else -np.inf)
        e_a = load_a + w * (1.0 / cap_a)
        e_b = load_b + w * (1.0 / cap_b)
        if v_b == target and load_b >= 0 and e_b > e_a:
            return cap_a, load_a, cap_b, load_b, w


def _cheap_site(rows: np.ndarray, col: int) -> None:
    rows[:, col] = [1e6, 0.0, 0.0, 0.0, 1e12, 0.0, 0.01, 1460.0]


def adversarial(name: str) -> dict:
    """The named edge case (see ADVERSARIAL)."""
    if name.startswith("ulp_reversal"):
        across = name.endswith("lanes")
        S = 70 if across else 2
        case = ragged(5, S, seed=11, dead=0.0)
        rows = case["rows"]
        rows[QUEUE], rows[WORK], rows[LOSS], rows[LOAD] = 0.0, 0.0, 0.0, 1e3   # dear sites
        cap_a, load_a, cap_b, load_b, w = _ulp_pair(seed=5)
        a_col, b_col = (3, 36) if across else (0, 1)         # the exact minimum second
        rows[CAP, a_col], rows[LOAD, a_col] = cap_a, load_a
        rows[CAP, b_col], rows[LOAD, b_col] = cap_b, load_b
        if across:   # a twin of b in b's lane: the lane walks its columns again
            rows[:, 68] = rows[:, b_col]
        case["work"][0], case["cls"][0] = w, CLASS_COMPUTE
        return case
    if name == "exact_ties":
        case = ragged(40, 70, seed=12)
        for col in (5, 37, 69):
            _cheap_site(case["rows"], col)
            case["alive"][col] = True
        return case
    if name == "bw_zero_nan":                     # 0/0 network cost: gate off
        case = ragged(40, 40, seed=13)
        case["rows"][BW, 7], case["rows"][LOSS, 7] = 0.0, 0.0
        case["alive"][7] = True
        return case
    if name == "eff_zero_inf":                    # mss 0: eff 0, bytes/0 = inf (0/0 at bytes 0)
        case = ragged(40, 40, seed=14)
        case["rows"][MSS, 9], case["rows"][LOSS, 9] = 0.0, 0.01
        case["alive"][9] = True
        case["bytes_"][:3], case["cls"][:3] = 0.0, CLASS_DATA
        return case
    if name == "negative_weight":
        case = ragged(40, 70, seed=15)
        case["w"] = (-0.5, 1.0, 1.0)
        return case
    if name == "negative_load":
        case = ragged(40, 70, seed=16)
        case["rows"][LOAD, 3] = -0.3
        return case
    if name == "all_dead":
        case = ragged(9, 40, seed=17)
        case["alive"][:] = False
        return case
    if name == "one_alive":
        case = ragged(9, 70, seed=18)
        case["alive"][:] = False
        case["alive"][69] = True
        return case
    if name == "bytes_zero":
        case = ragged(40, 70, seed=19)
        case["bytes_"][:] = 0.0
        return case
    if name == "subnormal":                       # costs near 1e-309: net 0, comp_site 0
        case = ragged(40, 70, seed=20, dead=0.0)
        rng = np.random.default_rng(21)
        rows = case["rows"]
        rows[QUEUE], rows[WORK], rows[LOAD], rows[LOSS] = 0.0, 0.0, 0.0, 0.0
        rows[CAP] = rng.uniform(1e2, 1e4, 70)
        case["work"] = rng.uniform(1e-307, 1e-305, 40)
        case["bytes_"] = rng.uniform(1e-301, 1e-299, 40)
        return case
    if name == "near_overflow":                   # costs near 1e308, some +inf
        case = ragged(40, 70, seed=22, dead=0.0)
        rng = np.random.default_rng(23)
        rows = case["rows"]
        rows[BW] = rng.uniform(0.5, 50.0, 70)
        rows[CAP] = rng.uniform(0.5, 5.0, 70)
        rows[LOSS] = 0.0
        case["work"] = rng.uniform(1e306, 1.7e308, 40)
        case["bytes_"] = rng.uniform(1e306, 1.7e308, 40)
        case["cls"][:] = np.resize(np.array([CLASS_COMPUTE, CLASS_DATA, CLASS_BOTH], np.int8), 40)
        return case
    raise KeyError(name)


ADVERSARIAL = (
    "ulp_reversal", "ulp_reversal_across_lanes", "exact_ties", "bw_zero_nan",
    "eff_zero_inf", "negative_weight", "negative_load", "all_dead", "one_alive",
    "bytes_zero", "subnormal", "near_overflow",
)


def tensors(case: dict, device) -> tuple:
    """(bytes_, work, cls, rows, alive) on ``device`` and the weights as
    keyword arguments of the ops wrappers."""
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)  # noqa: E731
    args = (t(case["bytes_"], torch.float64), t(case["work"], torch.float64),
            t(case["cls"], torch.int8), t(case["rows"], torch.float64), t(case["alive"], torch.bool))
    wq, ww, wl = case["w"]
    return args, dict(w_queue=wq, w_work=ww, w_load=wl)
