"""Inputs that hold the cost kernels to their plain versions at their
edges: the fused f64 argmin's screen (estimates that reverse a one-ulp
order, exact ties, NaN and inf cells, the gate switched off, subnormal
and near-overflow costs), the f32 plane's exact division and its window
(``ADVERSARIAL_F32``) and ragged shapes.

Each case is a dict of NumPy arrays in the kernels' packed layout —
``bytes_``/``work`` (J,) float64, ``cls`` (J,) int8 (0 COMPUTE, 1 DATA,
2 BOTH), ``rows`` (8, S) float64 in PACK_FIELDS order (cap, queue, work,
load, bw, loss, rtt, mss), ``alive`` (S,) bool — and the weights ``w``.
Everything is drawn from NumPy generators with fixed seeds.
``tensors`` gives a case as the f64 kernels' arguments, ``tensors_f32``
as the f32 plane's (``ops.cost_matrix_classed``).
"""
from __future__ import annotations

import numpy as np
import torch

from .ref import CLASS_BOTH, CLASS_COMPUTE, CLASS_DATA, cost_matrix_classed_ref

__all__ = ["ADVERSARIAL", "ADVERSARIAL_F32", "adversarial", "ragged", "tensors", "tensors_f32"]

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
    """The named edge case (see ADVERSARIAL and ADVERSARIAL_F32)."""
    if name.startswith("f32_"):
        return _adversarial_f32(name)
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


_FLT_MIN = 2.0**-126
_WIN_LO, _WIN_HI = 2.0**-62, 2.0**63     # the f32 division's window (ref.DIV32_EXP_LO/HI)


def _live(case: dict, *cols: int) -> None:
    case["alive"][list(cols)] = True


def _adversarial_f32(name: str) -> dict:
    if name == "f32_beyond_range":           # cast to f32: inf, 0 and subnormals
        case = ragged(40, 70, seed=30)
        rows = case["rows"]
        case["bytes_"][:3] = 1e39, 1e-40, 1e-46
        case["work"][3:6] = 1e39, 3e-42, 1e-50
        rows[CAP, 5], rows[CAP, 6], rows[CAP, 7] = 1e40, 1e-39, 1e-46
        rows[BW, 8], rows[LOSS, 8] = 1e39, 0.0
        rows[BW, 9], rows[LOSS, 9] = 1e-40, 0.0
        rows[QUEUE, 10], rows[LOSS, 11] = 1e-41, 1e-40
        _live(case, *range(5, 12))
        return case
    if name == "f32_window_edges":           # operands at and just outside 2^-62 and 2^63
        case = ragged(12, 70, seed=31)
        rows = case["rows"]
        below, top = np.nextafter(np.float32(_WIN_LO), np.float32(0)), np.nextafter(np.float32(_WIN_HI), np.float32(0))
        edges = [_WIN_LO, float(below), float(top), _WIN_HI]
        case["bytes_"][:4] = edges
        case["work"][4:8] = edges
        rows[CAP, 20:24] = edges
        rows[BW, 24:28], rows[LOSS, 24:28] = edges, 0.0
        _live(case, *range(20, 28))
        return case
    if name == "f32_cap_flt_min":            # RN(1/cap) = 2^126: jw·y overflows
        case = ragged(40, 70, seed=32)
        case["rows"][CAP, [2, 33, 65]] = _FLT_MIN
        case["rows"][CAP, 40] = np.nextafter(np.float32(_FLT_MIN), np.float32(1))
        _live(case, 2, 33, 40, 65)
        return case
    if name == "f32_huge_jobs":              # jb, jw at 3e38; caps below 1 overflow comp
        case = ragged(40, 70, seed=33)
        case["bytes_"][:6] = 3e38
        case["work"][3:9] = 3e38
        case["rows"][CAP, :10] = np.linspace(0.25, 4.0, 10)
        case["rows"][BW, 10:14], case["rows"][LOSS, 10:14] = 0.5, 0.0   # dtc overflows
        _live(case, *range(14))
        return case
    if name == "f32_loss_edges":             # loss 0, 1e-12 (the clamp) and just around it
        case = ragged(40, 70, seed=34)
        rows = case["rows"]
        rows[LOSS, :6] = 0.0, 1e-12, 1e-13, 2e-12, 1.0, 1e-30
        _live(case, *range(6))
        return case
    if name == "f32_nonfinite_column":       # live columns with inf and NaN terms
        case = ragged(40, 70, seed=35)
        rows = case["rows"]
        nan, inf = float("nan"), float("inf")
        rows[CAP, 1], rows[BW, 2], rows[QUEUE, 3], rows[RTT, 4] = inf, nan, inf, 0.0
        rows[MSS, 5], rows[LOSS, 5] = nan, 0.01
        rows[LOAD, 6], rows[WORK, 7], rows[CAP, 8] = -inf, nan, nan
        _live(case, *range(1, 9))
        return case
    if name == "f32_wc_zero_inf_comp":       # 0·inf = NaN: DATA rows by an inf comp, COMPUTE by eff 0
        case = ragged(30, 70, seed=36)
        rows = case["rows"]
        rows[QUEUE, 4], rows[CAP, 9] = float("inf"), 0.0
        rows[MSS, 12], rows[LOSS, 12] = 0.0, 0.01
        case["cls"][:] = np.resize(np.array([CLASS_COMPUTE, CLASS_DATA, CLASS_BOTH], np.int8), 30)
        _live(case, 4, 9, 12)
        return case
    if name == "f32_ulp_lanes":              # job 0: column 36 one ulp below column 3
        case = ragged(5, 70, seed=37, dead=0.0)
        rows = case["rows"]
        rows[LOAD] = 1e3                     # dear sites
        for col in (3, 36):
            rows[:, col] = [1000.0, 0.0, 0.0, 0.25, 1e10, 0.0, 0.01, 1460.0]
        case["cls"][0] = CLASS_BOTH
        case["bytes_"][0], case["work"][0] = float(np.float32(3e9)), float(np.float32(37.5))
        _one_ulp_below(case, job=0, a_col=3, b_col=36)
        return case
    raise KeyError(name)


def _one_ulp_below(case: dict, job: int, a_col: int, b_col: int) -> None:
    """Lower column b_col's load, one float32 ulp at a time, until the
    f32 plane's cost of ``job`` there is one ulp below a_col's."""
    load_b = np.float32(case["rows"][LOAD, b_col])
    for _ in range(4096):
        load_b = np.nextafter(load_b, np.float32(-1))
        case["rows"][LOAD, b_col] = float(load_b)
        args, w = tensors_f32(case, "cpu")
        cost = cost_matrix_classed_ref(*args, **w)[0][job]
        a, b = cost[a_col].item(), cost[b_col].item()
        if b < a:
            assert b == float(np.nextafter(np.float32(a), np.float32(-np.inf))), (a, b)
            return
    raise RuntimeError("no load gives a one-ulp gap")


ADVERSARIAL_F32 = (
    "f32_beyond_range", "f32_window_edges", "f32_cap_flt_min", "f32_huge_jobs",
    "f32_loss_edges", "f32_nonfinite_column", "f32_wc_zero_inf_comp", "f32_ulp_lanes",
)


def tensors_f32(case: dict, device) -> tuple:
    """The f32 plane's arguments for a case on ``device``: (jb, jw, wc,
    wd, cap, queue, work, load, bw, loss, rtt, alive, mss), float32 but
    ``alive`` (bool), with the class as the wc/wd masks ``JobPack``
    packs (COMPUTE 1/0, DATA 0/1, BOTH 1/1); and the weights as keyword
    arguments of ``ops.cost_matrix_classed``. Values beyond float32's
    range become inf or 0 in the cast, as ``.float()`` makes them."""
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)  # noqa: E731
    f32 = lambda a: t(torch.as_tensor(np.asarray(a, np.float64)).float().numpy(), torch.float32)  # noqa: E731
    cls = case["cls"]
    wc, wd = (cls != CLASS_DATA).astype(np.float32), (cls != CLASS_COMPUTE).astype(np.float32)
    rows = case["rows"]
    args = (f32(case["bytes_"]), f32(case["work"]), f32(wc), f32(wd),
            *(f32(rows[i]) for i in (CAP, QUEUE, WORK, LOAD, BW, LOSS, RTT)),
            t(case["alive"], torch.bool), f32(rows[MSS]))
    wq, ww, wl = case["w"]
    return args, dict(w_queue=wq, w_work=ww, w_load=wl)


def tensors(case: dict, device) -> tuple:
    """(bytes_, work, cls, rows, alive) on ``device`` and the weights as
    keyword arguments of the ops wrappers."""
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)  # noqa: E731
    args = (t(case["bytes_"], torch.float64), t(case["work"], torch.float64),
            t(case["cls"], torch.int8), t(case["rows"], torch.float64), t(case["alive"], torch.bool))
    wq, ww, wl = case["w"]
    return args, dict(w_queue=wq, w_work=ww, w_load=wl)
