"""The fused float64 argmin's screen and tiling, on the CPU.

The kernel (``csrc/cost_matrix.cu``, ``cost_argmin_f64_kernel``) estimates
each cell with multiplications by per-site reciprocals and takes the
exact divisions only for cells within a guard of its row's least
estimate, under a gate (nonnegative terms, finite positive capacities).
Its walk — 32 lanes striding the columns, each keeping the screen key of
its least estimate, that cell's column and the least key of its other
cells, dead pad columns up to a multiple of 32, rows with a cell outside
the fast division range redone in full — is modelled step for step by
``ref.py``'s ``cost_argmin_f64_screen_model``. Here that model is held against the
plain version and the reference's NumPy path, bit for bit, on the edge
cases of ``cases.py`` (which the card tests and ``chip_smoke.py`` run
through the kernel itself), with the count of skipped cells reported.
"""
import numpy as np
import pytest
import torch

from repro.core import batch as RB
from repro.core import CostWeights as RWeights

from repro_torch.core import batch as PB
from repro_torch.core import state_from_reference
from repro_torch.kernels.cost_matrix import cases, ref
from repro_torch.kernels.cost_matrix.ops import scratch_doubles

from test_torch_cost_matrix import _grid, _jobs, _packs

_CLASSES = (RB.JobClass.COMPUTE, RB.JobClass.DATA, RB.JobClass.BOTH)


def _reference(case):
    """The reference's plane (batched_cost_matrix, NumPy float64) and its
    row argmin (np.argmin: first index, NaN first) for a packed case."""
    rows = case["rows"]
    names = [f"s{i}" for i in range(rows.shape[1])]
    sr = RB.SitePack(names, *[rows[i].copy() for i in range(8)], case["alive"].copy())
    classes = [_CLASSES[c] for c in case["cls"]]
    jr = RB.JobPack(
        bytes_=case["bytes_"].copy(), work=case["work"].copy(),
        wcomp=np.asarray([1.0 if c != RB.JobClass.DATA else 0.0 for c in classes]),
        wdtc=np.asarray([1.0 if c != RB.JobClass.COMPUTE else 0.0 for c in classes]),
        classes=classes,
    )
    wq, ww, wl = case["w"]
    with np.errstate(all="ignore"):
        plane = RB.batched_cost_matrix(jr, sr, RWeights(w_queue=wq, w_work=ww, w_load=wl))
    idx = np.argmin(plane, axis=1)
    return plane, sr, idx, plane[np.arange(plane.shape[0]), idx]


def _same(a, b):
    """Equal bit for bit, NaN where NaN."""
    a, b = np.asarray(a), np.asarray(b)
    return np.array_equal(np.isnan(a), np.isnan(b)) and np.array_equal(a[~np.isnan(a)], b[~np.isnan(b)])


def _check(case, record_property):
    args, w = cases.tensors(case, "cpu")
    wq, ww, wl = w.values()
    best, cost, skipped = ref.cost_argmin_f64_screen_model(*args, wq, ww, wl)
    pb, pc = ref.cost_argmin_f64_ref(*args, wq, ww, wl)
    assert torch.equal(best, pb) and _same(cost.numpy(), pc.numpy())
    plane, sr, idx, picked = _reference(case)
    assert best.tolist() == idx.tolist() and _same(cost.numpy(), picked)
    if np.all(np.isfinite(picked)):
        placement = RB.batched_argmin(plane, sr)
        assert placement.site_indices.tolist() == best.tolist()
    else:
        with pytest.raises(RuntimeError, match="no alive site"):
            RB.batched_argmin(plane, sr)
    J, S = plane.shape
    assert 0 <= skipped <= J * S
    record_property("skipped_cells", skipped)
    record_property("cells", J * S)
    return skipped


_GATE_OFF = {"bw_zero_nan", "negative_weight", "negative_load"}


@pytest.mark.parametrize("name", cases.ADVERSARIAL)
def test_screen_model_on_the_edge_cases(name, record_property):
    """One-ulp reversals, ties, NaN and inf cells, the gate off, dead
    columns, zero bytes, subnormal and near-overflow costs."""
    case = cases.adversarial(name)
    skipped = _check(case, record_property)
    if name in _GATE_OFF:
        assert skipped == 0          # the gate is off: every cell exact
    if name.startswith("ulp_reversal"):
        # the precondition: the exact minimum's estimate is the larger
        args, _ = cases.tensors(case, "cpu")
        exact = ref.cost_matrix_f64_ref(*args)[0]
        a, b = (0, 1) if name == "ulp_reversal" else (3, 36)
        assert float(exact[b]) == np.nextafter(float(exact[a]), -np.inf)
        rows = case["rows"]
        w = case["work"][0]
        assert rows[3, b] + w * (1.0 / rows[0, b]) > rows[3, a] + w * (1.0 / rows[0, a])


@pytest.mark.parametrize("S", [1, 31, 33, 257, 1025])
@pytest.mark.parametrize("J", [37, 130])
def test_screen_model_on_ragged_shapes(J, S, record_property):
    """S around the 32 lanes and past several rounds of them; J not a
    multiple of the 4 rows a warp carries or of a block's 32."""
    skipped = _check(cases.ragged(J, S, seed=J * 7 + S), record_property)
    if S >= 257:
        assert skipped > 0.5 * J * S     # the screen prunes most cells


@pytest.mark.parametrize(
    "seed,J,S,dead,lossless",
    [(0, 1, 1, 0.0, 0.0), (1, 7, 5, 0.25, 0.3), (2, 64, 33, 0.5, 0.5),
     (3, 300, 130, 0.25, 1.0), (4, 129, 257, 0.0, 0.0), (5, 50, 24, 0.9, 0.3)],
)
def test_screen_model_on_the_float64_sweeps(seed, J, S, dead, lossless, record_property):
    """TestFloat64BitIdentical's seeded grids (tests/test_torch_cost_matrix.py),
    through the port's packs."""
    rng = np.random.default_rng(seed)
    sites, links = _grid(rng, S, dead_fraction=dead, lossless_fraction=lossless)
    jobs = _jobs(rng, J)
    jr, sr, jp, sp = _packs(sites, links, jobs)
    best, cost, skipped = ref.cost_argmin_f64_screen_model(
        jp.bytes_, jp.work, jp.cls, sp.pack_rows(), sp.alive)
    plane = RB.batched_cost_matrix(jr, sr)
    idx = np.argmin(plane, axis=1)
    assert best.tolist() == idx.tolist()
    assert _same(cost.numpy(), plane[np.arange(J), idx])
    record_property("skipped_cells", skipped)


def test_screen_model_on_the_bench_config(record_property):
    """The bulk bench's 10,000 × 256 grid (seed 0), where the main path's
    select runs the fused argmin: the model picks what the reference's
    fused path picks."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
    from bulk_placement_bench import _build as bench_build

    site_d, link_d, jobs = bench_build(10_000, 256, 0)
    jr, sr, jp, sp = _packs(site_d, link_d, jobs)
    best, cost, skipped = ref.cost_argmin_f64_screen_model(
        jp.bytes_, jp.work, jp.cls, sp.pack_rows(), sp.alive)
    expect = RB.batched_argmin(RB.batched_cost_matrix(jr, sr), sr)
    assert best.tolist() == expect.site_indices.tolist()
    assert cost.tolist() == list(expect.costs)
    assert skipped > 0.9 * 10_000 * 256
    record_property("skipped_cells", skipped)


def test_screen_model_gate_follows_the_weights():
    """A negative weight turns the gate off; weights of zero keep it on."""
    case = cases.ragged(40, 70, seed=3)
    args, _ = cases.tensors(case, "cpu")
    *_, on = ref.cost_argmin_f64_screen_model(*args, 0.0, 1.0, 0.0)
    *_, off = ref.cost_argmin_f64_screen_model(*args, 1.0, -1.0, 1.0)
    assert on > 0 and off == 0


@pytest.mark.parametrize("S,J", [(1, 1), (31, 2), (32, 63), (33, 64), (1025, 100_003)])
def test_scratch_holds_the_padded_terms_gates_and_row_flags(S, J):
    """The wrapper's scratch: eleven term arrays over S rounded up to the
    32 lanes, 256 int32 partial gates, 256 int32 partial column flags, J
    int32 row flags."""
    Sp = -(-S // 32) * 32
    assert scratch_doubles(S, J) * 8 >= 11 * Sp * 8 + 512 * 4 + J * 4
    assert scratch_doubles(S, J) == 11 * Sp + 256 + -(-J // 2)


def test_port_fused_argmin_equals_the_model():
    """On the host the port's select path is the plain version; the model
    picks the same sites on a grid with every class and custom weights."""
    rng = np.random.default_rng(12)
    sites, links = _grid(rng, 45)
    jobs = _jobs(rng, 30)
    jr, sr, jp, sp = _packs(sites, links, jobs, list(_CLASSES) * 10)
    w = RWeights(w_queue=0.3, w_work=1.7, w_load=2.9)
    pw = state_from_reference({}, {}, weights=w).weights
    got = PB.fused_argmin(jp, sp, pw)
    best, cost, _ = ref.cost_argmin_f64_screen_model(
        jp.bytes_, jp.work, jp.cls, sp.pack_rows(), sp.alive, 0.3, 1.7, 2.9)
    assert got.site_indices.tolist() == best.tolist()
    assert got.costs.tolist() == cost.tolist()
