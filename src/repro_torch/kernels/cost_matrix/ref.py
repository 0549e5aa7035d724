"""Plain PyTorch versions of the cost_matrix kernels (paper §IV/§V).

Each takes exactly the packed inputs its CUDA kernel takes and repeats
its arithmetic in the same order, so on the card kernel and plain
version agree bit for bit; on the host the ops wrappers run these.

Job classes ride as an int8 (J,) column: 0 COMPUTE, 1 DATA, 2 BOTH.
"""
from __future__ import annotations

import math
import struct
from fractions import Fraction

import numpy as np
import torch

from ..._device import sqrt_rn

__all__ = [
    "CLASS_COMPUTE",
    "CLASS_DATA",
    "CLASS_BOTH",
    "cost_matrix_f32_ref",
    "cost_matrix_classed_ref",
    "site_rows_f32",
    "cost_matrix_f64_ref",
    "cost_argmin_f64_ref",
    "cost_argmin_f64_screen_model",
    "div32_in_window",
    "div_rn_f32_model",
]

CLASS_COMPUTE, CLASS_DATA, CLASS_BOTH = 0, 1, 2
DEAD_F32 = 3.0e38
# The fused f64 argmin's screen (csrc/cost_matrix.cu): the lanes of a
# warp, the guard and the range in which an estimate's relative error
# bound holds.
LANES = 32
GUARD = 1.0 + 2.0**-40
SCREEN_LO, SCREEN_HI = 2.0**-960, 2.0**1000
_MIN_NORMAL = 2.0**-1022
_INF_KEY = 0x7FF00000      # +inf's screen key (the high word of its bits)
# The f32 plane's exact division (csrc/cost_matrix.cu, div_rn_f32) is
# used where both operands' biased exponents lie in [DIV32_EXP_LO,
# DIV32_EXP_HI], i.e. |x| in [2^-62, 2^63); other cells take IEEE division.
DIV32_EXP_LO, DIV32_EXP_HI = 65, 189


def cost_matrix_f32_ref(jb, jw, wc, wd, rows, w_queue=1.0, w_work=1.0, w_load=1.0):
    """The TPU kernel's float32 plane: ``rows`` is (9, S) — cap, queue,
    work, load, bw, loss, rtt, alive, mss; net + wc·comp + wd·dtc with
    dead columns at 3e38."""
    cap, queue, work, load, bw, loss, rtt, alive, mss = rows
    mathis = mss / (rtt * torch.sqrt(torch.clamp_min(loss, 1e-12)))
    eff = torch.where(loss > 0.0, torch.minimum(bw, mathis), bw)
    net = (loss / bw) * 1.0e6
    comp_site = (w_queue * queue + w_work * work) / cap + w_load * load
    comp = comp_site[None, :] + jw[:, None] / cap[None, :]
    dtc = jb[:, None] / eff[None, :]
    cost = net[None, :] + wc[:, None] * comp + wd[:, None] * dtc
    return torch.where(alive[None, :] > 0.5, cost, DEAD_F32)


def site_rows_f32(cap, queue, work, load, bw, loss, rtt, alive, mss):
    """The f32 plane's (9, S) site rows from its (S,) columns."""
    return torch.stack([cap, queue, work, load, bw, loss, rtt, alive.to(torch.float32), mss])


def cost_matrix_classed_ref(jb, jw, wc, wd, cap, queue, work, load, bw, loss, rtt, alive, mss,
                            w_queue=1.0, w_work=1.0, w_load=1.0):
    """``ops.cost_matrix_classed``'s plain version on its tensor
    arguments (``mss`` an (S,) tensor): (cost, best (J,) int32, the
    first index of each row's minimum; a NaN counts as the minimum)."""
    rows = site_rows_f32(cap, queue, work, load, bw, loss, rtt, alive, mss)
    cost = cost_matrix_f32_ref(jb, jw, wc, wd, rows, w_queue, w_work, w_load)
    return cost, torch.argmin(cost, dim=1).to(torch.int32)


def _site_terms_f64(rows, w_queue, w_work, w_load):
    """Per-site (net, eff_bw, comp_site, cap) in ``repro.core.batch``'s
    ``cost_components``/``comp_site_column`` operation order; ``rows``
    is (8, S) in PACK_FIELDS order."""
    cap, queue, work, load, bw, loss, rtt, mss = rows
    net = (loss / bw) * 1.0e6
    mathis = mss / (rtt * sqrt_rn(loss))
    eff = torch.where(loss > 0.0, torch.minimum(bw, mathis), bw)
    comp_site = w_queue * queue / cap + w_work * work / cap + w_load * load
    return net, eff, comp_site, cap


def cost_matrix_f64_ref(
    bytes_, work, cls, rows, alive,
    w_queue=1.0, w_work=1.0, w_load=1.0, mask_dead=True,
):
    """Per-class float64 (J, S) plane with ``class_total``'s addition
    order — DATA dtc+net, COMPUTE comp+net, BOTH (net+comp)+dtc — dead
    columns +inf when ``mask_dead``."""
    net, eff, comp_site, cap = _site_terms_f64(rows, w_queue, w_work, w_load)
    dtc = bytes_[:, None] / eff[None, :]
    comp = comp_site[None, :] + work[:, None] / cap[None, :]
    c = cls[:, None]
    cost = torch.where(
        c == CLASS_DATA,
        dtc + net,
        torch.where(c == CLASS_COMPUTE, comp + net, (net + comp) + dtc),
    )
    if mask_dead:
        cost = cost.masked_fill(~alive[None, :], float("inf"))
    return cost


def cost_argmin_f64_ref(bytes_, work, cls, rows, alive, w_queue=1.0, w_work=1.0, w_load=1.0):
    """Per-row (first index of the minimum, its cost) over the
    dead-masked float64 plane; a NaN counts as the minimum."""
    cost = cost_matrix_f64_ref(bytes_, work, cls, rows, alive, w_queue, w_work, w_load)
    best = torch.argmin(cost, dim=1)
    return best, cost.gather(1, best[:, None])[:, 0]


def _div_range(x):
    """The kernels' fast division domain: normal, |x| in [2^-500, 2^501)."""
    e = (x.view(torch.int64) >> 52) & 0x7FF
    return (e >= 523) & (e <= 1523)


def cost_argmin_f64_screen_model(
    bytes_, work, cls, rows, alive, w_queue=1.0, w_work=1.0, w_load=1.0,
):
    """The fused f64 argmin kernel's screened walk, step for step: the
    gate, the per-site reciprocals, the estimates, each lane's least
    screen key, its column and the least key of its other cells (lane l
    walks columns l, l + 32, ... of the row padded with dead columns to a
    multiple of 32), the threshold from the lanes' least cells, which
    cells take the exact path, and the rows the fix-up pass redoes. Rows
    are independent, so the R rows a warp carries change no decision.
    Returns (best (J,) int64, cost (J,) float64, skipped: real cells
    whose exact evaluation the screen saved). For the tests: the result
    must equal ``cost_argmin_f64_ref`` bit for bit on any input."""
    J, S = bytes_.shape[0], rows.shape[1]
    Sp = -(-S // LANES) * LANES
    dev, f64 = rows.device, torch.float64
    inf = float("inf")
    net, eff, comp_site, cap = _site_terms_f64(rows, w_queue, w_work, w_load)
    screen = (
        min(w_queue, w_work, w_load) >= 0.0
        and bool((net >= 0).all() and (eff >= 0).all())
        and bool((rows[1] >= 0).all() and (rows[2] >= 0).all() and (rows[3] >= 0).all())
        and bool((cap > 0).all() and (cap < inf).all())
        and bool((bytes_ >= 0).all() and (work >= 0).all())
    )
    one = torch.ones_like(eff)
    reff, rcap = one / eff, one / cap     # tensor / tensor: correctly rounded

    def normal(x):
        return (x.abs() >= _MIN_NORMAL) & (x.abs() < inf)

    ok = normal(reff) & normal(rcap)

    def padded(x, fill):
        return torch.cat([x, torch.full((Sp - S,), fill, dtype=f64, device=dev)])

    dead = padded((~alive).to(f64), 1.0) != 0
    snet = torch.where(dead, inf, padded(torch.where(ok, net, float("nan")), 0.0))
    sbase = torch.where(dead, inf, padded(torch.where(ok, net + comp_site, float("nan")), 0.0))
    re = torch.where(dead, 0.0, padded(torch.where(ok, reff, 0.0), 0.0))
    rc = torch.where(dead, 0.0, padded(torch.where(ok, rcap, 0.0), 0.0))

    c = cls[:, None]
    bb = torch.where(c != CLASS_COMPUTE, bytes_[:, None], 0.0)
    wa = torch.where(c != CLASS_DATA, work[:, None], 0.0)
    base = torch.where(c == CLASS_DATA, snet[None, :], sbase[None, :])
    est = (base + wa * rc[None, :]) + bb * re[None, :]                 # (J, Sp)
    exact = cost_matrix_f64_ref(bytes_, work, cls, rows, alive, w_queue, w_work, w_load)
    exact = torch.cat([exact, torch.full((J, Sp - S), inf, dtype=f64, device=dev)], dim=1)

    # Per lane (J, rounds, LANES), on screen keys (the estimate's high word,
    # sign cleared; NaN keys, above +inf's, count as +inf): the least key,
    # the first column reaching it, the least key of the lane's other
    # cells, and whether the lane met a NaN.
    lanes = est.view(J, Sp // LANES, LANES)
    isnan = torch.isnan(lanes)
    key = torch.clamp_max((lanes.view(torch.int64) >> 32) & 0x7FFFFFFF, _INF_KEY)
    emin = key.amin(dim=1)
    first = key == emin[:, None, :]
    hits = first.sum(dim=1)
    rounds = Sp // LANES
    second = key.sort(dim=1).values[:, 1, :] if rounds > 1 else torch.full_like(emin, _INF_KEY)
    e2 = torch.where(hits > 1, emin, second)
    imin = torch.argmax(first.to(torch.int8), dim=1)                     # first round reaching it
    # t from the least estimate of the lanes' least cells
    ey = torch.where(emin < _INF_KEY, lanes.gather(1, imin[:, None, :])[:, 0, :], inf)
    x = ey.amin(dim=1, keepdim=True) * GUARD * GUARD
    t = torch.where(x <= SCREEN_HI, torch.clamp_min(x, SCREEN_LO), inf)
    if not screen:
        t = torch.full_like(t, inf)

    def lower(k):                                                        # the key's least value
        return (k << 32).view(f64)

    rescan = isnan.any(dim=1) | ~(lower(e2) > t)
    own = ~rescan & ~(lower(emin) > t)
    one_cell = own[:, None, :] & (torch.arange(rounds, device=dev)[None, :, None] == imin[:, None, :])
    evaluated = (rescan[:, None, :] & ~(lanes > t[:, :, None])) | one_cell
    evaluated = evaluated.reshape(J, Sp)[:, :S]
    # A row whose evaluated cells include one outside the kernels' fast
    # division range is redone in full by the fix-up pass.
    fast_eff, fast_cap = _div_range(eff), _div_range(cap)
    slow = alive[None, :] & (
        ((c != CLASS_COMPUTE) & ~(_div_range(bytes_)[:, None] & fast_eff[None, :]))
        | ((c != CLASS_DATA) & ~(_div_range(work)[:, None] & fast_cap[None, :]))
    )
    redone = (evaluated & slow).any(dim=1, keepdim=True)
    evaluated = evaluated | redone
    skipped = int((~evaluated).sum())
    evaluated = torch.cat([evaluated, torch.zeros((J, Sp - S), dtype=torch.bool, device=dev)], dim=1)

    # The warp's merge of the lanes' bests: the argmin order (NaN first,
    # then the least value, then the least index) over the evaluated cells.
    col = torch.arange(Sp, device=dev).expand(J, -1)
    nan_cell = evaluated & torch.isnan(exact)
    value = torch.where(evaluated & ~torch.isnan(exact), exact, inf)
    low = value.amin(dim=1, keepdim=True)
    cand = torch.where(nan_cell.any(dim=1, keepdim=True), nan_cell, evaluated & (value == low))
    best = torch.where(cand, col, Sp).amin(dim=1)
    cost = exact.gather(1, best[:, None])[:, 0]
    return best, cost, skipped


def div32_in_window(x: float) -> bool:
    """The f32 kernel's window test (``div32_window``): ``x`` as float32
    is a normal number with |x| in [2^-62, 2^63)."""
    e = (struct.unpack("<I", struct.pack("<f", x))[0] >> 23) & 0xFF
    return DIV32_EXP_LO <= e <= DIV32_EXP_HI


def _round_f32(v: Fraction, neg_zero: bool = False) -> float:
    """``v`` rounded to the nearest float32 (ties to even; subnormals and
    overflow to inf as IEEE does), as a Python float. An exact zero is
    -0.0 when ``neg_zero``."""
    if v == 0:
        return -0.0 if neg_zero else 0.0
    sign = -1.0 if v < 0 else 1.0
    n, d = abs(v.numerator), v.denominator
    e = n.bit_length() - d.bit_length()            # floor(log2 |v|) is e or e - 1
    if (n << max(0, -e)) < (d << max(0, e)):
        e -= 1
    u = max(e, -126) - 23                           # the exponent of the ulp
    num, den = (n << -u, d) if u < 0 else (n, d << u)
    q, r = divmod(num, den)
    if 2 * r > den or (2 * r == den and q & 1):
        q += 1
    if q * 2.0**u >= 2.0**128:
        return sign * float("inf")
    return sign * q * 2.0**u


def _fma32(a: float, b: float, c: float) -> float:
    """RN32(a·b + c) with one rounding (``__fmaf_rn``), for finite
    float32 operands."""
    (na, da), (nb, db), (nc, dc) = a.as_integer_ratio(), b.as_integer_ratio(), c.as_integer_ratio()
    exact = Fraction(na * nb * dc + nc * da * db, da * db * dc)
    neg_zero = math.copysign(1.0, a) * math.copysign(1.0, b) < 0 and math.copysign(1.0, c) < 0
    return _round_f32(exact, neg_zero=neg_zero)


def div_rn_f32_model(a: float, b: float) -> float:
    """a / b in float32 as the f32 plane's kernel computes it: inside the
    window (``div32_in_window`` of both), y = RN(1/b), q = RN(a·y), then
    two corrections r = fma(−b, q, a), q = fma(r, y, q), each FMA exact
    before its one rounding (``fractions.Fraction``); outside it, IEEE
    float32 division. For the tests: equal to IEEE division everywhere."""
    a, b = float(np.float32(a)), float(np.float32(b))
    if not (div32_in_window(a) and div32_in_window(b)):
        with np.errstate(all="ignore"):
            return float(np.float32(a) / np.float32(b))
    y = _round_f32(1 / Fraction(b))
    q = _round_f32(Fraction(a) * Fraction(y))
    for _ in range(2):
        r = _fma32(-b, q, a)
        q = _fma32(r, y, q)
    return q
