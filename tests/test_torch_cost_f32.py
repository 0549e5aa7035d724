"""The f32 plane's exact division and edge sets, on the CPU.

The kernel (``csrc/cost_matrix.cu``, ``cost_matrix_f32_kernel``) divides
without a divide: y = RN(1/b) from the site pre-pass, q = RN(a·y), then
two FMA corrections, for operands inside a window where nothing under-
or overflows; other cells take IEEE division. ``ref.div_rn_f32_model``
repeats that sequence with exact FMAs (``fractions.Fraction``); here it
is held equal to IEEE float32 division on every in-window operand pair
of the f32 edge sets of ``cases.py``, on seeded pairs spread over the
window and on hard-to-round pairs, and the window test against the operands it must refuse. The
card tests and ``chip_smoke.py`` run the same edge sets through the
kernel itself. Last, the plain version against the Pallas kernel in
interpret mode on the f32 edge sets whose costs are finite.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.cost_matrix.ops import cost_matrix_classed as jax_cost_matrix_classed

from repro_torch.kernels.cost_matrix import cases, ops, ref

_CU = Path(ref.__file__).resolve().parent / "csrc" / "cost_matrix.cu"
_F32 = np.float32


def _ieee(a, b):
    with np.errstate(all="ignore"):
        return float(_F32(a) / _F32(b))


def _operand_pairs(name):
    """The (numerator, denominator) pairs the f32 plane divides on an
    edge set's live cells: (jb, eff) and (jw, cap), both in the window."""
    args, _ = cases.tensors_f32(cases.adversarial(name), "cpu")
    jb, jw, _, _, cap, _, _, _, bw, loss, rtt, alive, mss = args
    mathis = mss / (rtt * torch.sqrt(torch.clamp_min(loss, 1e-12)))
    eff = torch.where(loss > 0.0, torch.minimum(bw, mathis), bw)
    pairs = set()
    for num, den in ((jb, eff[alive]), (jw, cap[alive])):
        nums = [x for x in set(num.tolist()) if ref.div32_in_window(x)]
        dens = [y for y in set(den.tolist()) if ref.div32_in_window(y)]
        pairs.update((x, y) for x in nums for y in dens)
    return sorted(pairs)


def test_window_constants_are_the_kernels():
    text = _CU.read_text()
    lo, hi = re.search(r"kDiv32ExpLo = (\d+), kDiv32ExpHi = (\d+);", text).groups()
    assert (int(lo), int(hi)) == (ref.DIV32_EXP_LO, ref.DIV32_EXP_HI)
    assert ops.scratch_floats(5) == 35 and "kYCap32, kFlags32, kF32Fields" in text


def test_window_refuses_what_needs_ieee_division():
    """Zero, subnormal, FLT_MIN, inf and NaN operands (bytes or work 0,
    eff 0 at mss 0, cap at FLT_MIN) and the first values outside
    [2^-62, 2^63) go to IEEE division; the window's own edges do not."""
    lo, hi = 2.0**-62, 2.0**63
    outside = [0.0, -0.0, 1e-40, 2.0**-149, 2.0**-126, float("inf"), -float("inf"), float("nan"),
               float(np.nextafter(_F32(lo), _F32(0))), hi, -hi, 3e38]
    inside = [lo, -lo, float(np.nextafter(_F32(hi), _F32(0))), 1.0, -1.0, 1460.0, 3e9, 1e-12]
    assert not any(ref.div32_in_window(x) for x in outside)
    assert all(ref.div32_in_window(x) for x in inside)
    # Outside the window the model is IEEE division itself.
    for a in outside + inside:
        for b in outside + inside:
            got, want = ref.div_rn_f32_model(a, b), _ieee(a, b)
            assert got == want or (np.isnan(got) and np.isnan(want)), (a, b)


@pytest.mark.parametrize("name", cases.ADVERSARIAL_F32)
def test_division_on_the_edge_sets(name):
    pairs = _operand_pairs(name)
    bad = [(a, b) for a, b in pairs if ref.div_rn_f32_model(a, b) != _ieee(a, b)]
    assert not bad, f"{len(bad)} of {len(pairs)} pairs differ from IEEE division: {bad[:3]}"


def test_division_on_seeded_pairs_over_the_window():
    """20,000 pairs: mantissas and signs at random, each operand's
    exponent uniform over the window's 125 binades."""
    rng = np.random.default_rng(15)
    n = 20_000
    m = rng.uniform(1.0, 2.0, (2, n)).astype(_F32) * rng.choice(_F32([-1, 1]), (2, n))
    e = rng.integers(-62, 63, (2, n))
    a, b = (np.ldexp(m[i], e[i]).astype(_F32) for i in range(2))
    assert all(ref.div32_in_window(float(x)) for x in np.concatenate([a, b]))
    bad = [(x, y) for x, y in zip(a.tolist(), b.tolist()) if ref.div_rn_f32_model(x, y) != _ieee(x, y)]
    assert not bad, bad[:3]


def test_division_on_hard_to_round_pairs():
    """Quotients within 1/(2B) of an ulp of a rounding midpoint, for
    divisors B just below 2^24 (whose reciprocals round farthest, so
    RN(a·y) lands up to 1.5 ulp away): B·t ≡ ±1 (mod 2^25) with t the
    midpoint's 25-bit odd significand, a = (B·t ∓ 1) / 2^25."""
    pairs = []
    for k in range(1, 4001, 2):
        B = 2**24 - k
        inv = pow(B, -1, 2**25)
        for s in (-1, 1):
            t = (s * inv) % 2**25
            if t >= 2**24:
                pairs.append((float((B * t - s) >> 25), float(B)))
    assert len(pairs) > 1500
    bad = [(a, b) for a, b in pairs if ref.div_rn_f32_model(a, b) != _ieee(a, b)]
    assert not bad, bad[:3]


# The f32 edge sets whose costs are all finite: the ones the Pallas kernel
# is held to at the JAX kernel suite's tolerance.
FINITE = ("f32_window_edges", "f32_loss_edges", "f32_ulp_lanes")


@pytest.mark.parametrize("name", FINITE)
def test_plain_version_against_pallas_on_the_edge_sets(name):
    args, w = cases.tensors_f32(cases.adversarial(name), "cpu")
    cost, best = ops.cost_matrix_classed(*args, **w)
    assert bool(torch.isfinite(cost).all())
    np_args = [a.numpy() for a in args]
    ck, bk = jax_cost_matrix_classed(*np_args, use_kernel=True, interpret=True, **w)
    np.testing.assert_allclose(cost.numpy(), np.asarray(ck), rtol=1e-5)
    np.testing.assert_array_equal(best.numpy(), np.asarray(bk))


def test_ulp_set_orders_two_lanes_by_one_ulp():
    """f32_ulp_lanes: job 0's cost at column 36 is one ulp below column
    3's (threads 9 and 0 of the kernel's first warp), so the argmin must
    take the later column."""
    args, w = cases.tensors_f32(cases.adversarial("f32_ulp_lanes"), "cpu")
    cost, best = ops.cost_matrix_classed(*args, **w)
    a, b = cost[0, 3].item(), cost[0, 36].item()
    assert b == float(np.nextafter(_F32(a), _F32(-np.inf)))
    assert best[0].item() == 36
