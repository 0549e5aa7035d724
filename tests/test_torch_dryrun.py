"""The port's dry run (``repro_torch.launch.dryrun``) and its op-level
analysis (``launch.op_analysis``), on the CPU with no card.

``count_params`` (total and active) equals the reference's for all 10
architectures at full width. Records of reduced cells carry every key of
the reference's record (and those ``tests/launch/test_dryrun_smoke.py``
asserts), load through ``grid.capacity_from_roofline`` into a
``DianaGridRuntime`` that places with them, and leave every kernel launch
counter at 0. One full-width cell (gemma2-9b ``decode_32k``) is held to
independent sums of its arguments and its kernels' work. The analysis
counts FLOPs, bytes, the live-storage high-water mark and the
microbatch trips as it says; ``chip_smoke.py``'s bounds at its timed
shapes are the same floats through the kernels' ``work`` functions."""
import ast
import importlib.util
import inspect
import json
import math
import os
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM
from repro_torch import _counting
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, Shape, cells
from repro_torch.grid import capacity as cap
from repro_torch.grid import runtime as grid_rt
from repro_torch.kernels.cost_matrix import ops as cm_ops
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.priority_requeue import ops as pr_ops
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.models import LM
from repro_torch.runtime.serve import abstract_cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as every CPU-heavy port test file (ROADMAP C3)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _ref_dryrun():
    """``repro.launch.dryrun``, imported after JAX has its devices (the
    module sets XLA_FLAGS at import) with XLA_FLAGS restored after."""
    jax.devices()
    prev = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as rd
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return rd


def _ref_record_keys():
    """{section: keys} of the dict the reference's run_cell returns (its
    source's literal; run_cell itself compiles for minutes)."""
    tree = ast.parse(inspect.getsource(_ref_dryrun().run_cell))
    ret = next(n for n in ast.walk(tree) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict))
    keys = {"": {k.value for k in ret.value.keys}}
    for k, v in zip(ret.value.keys, ret.value.values):
        if isinstance(v, ast.Dict):
            keys[k.value] = {kk.value for kk in v.keys}
    return keys


def _all_counters():
    return {"cost_matrix_f32": cm_ops.cost_matrix_classed, "cost_matrix_f64": cm_ops.cost_matrix_f64,
            "cost_argmin_f64": cm_ops.cost_argmin_f64, "priority_requeue": pr_ops.priority_requeue,
            "flash_attention": fa_ops.flash_attention, "flash_attention_bwd": fa_ops.flash_attention_bwd,
            "decode_attention": da_ops.decode_attention}


def _launch_counts():
    return {n: (f.launches, dict(getattr(f, "by_pair", {})), getattr(f, "padded", 0))
            for n, f in _all_counters().items()}


# -- count_params --------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_count_params_equals_the_reference(arch):
    rd = _ref_dryrun()
    ref_cfg = ref_get_config(arch)
    want = rd.count_params(RefLM(ref_cfg).abstract_params(), ref_cfg)
    got = dryrun.count_params(LM(get_config(arch), device="meta"), get_config(arch))
    assert got == want
    if get_config(arch).num_experts:
        assert got[1] < got[0]


# -- records of reduced cells ----------------------------------------------------------

SMOKE_CELLS = [("gemma3-12b", "train_4k", "2x4"), ("deepseek-v2-236b", "train_4k", "2x4"),
               ("mamba2-780m", "decode_32k", "2x4"), ("recurrentgemma-2b", "prefill_32k", "2x4"),
               ("gemma2-9b", "train_4k", "2x2x2"), ("whisper-base", "decode_32k", "1"),
               ("llama-3.2-vision-11b", "prefill_32k", "1x4"), ("deepseek-v3-671b", "train_4k", "1")]


@pytest.mark.parametrize("arch,shape,mesh", SMOKE_CELLS)
def test_reduced_cell_reports(arch, shape, mesh):
    before = _launch_counts()
    rec = dryrun.run_cell(arch, shape, mesh, reduced=True)
    assert _launch_counts() == before                   # the meta route launches nothing
    want = _ref_record_keys()
    assert want[""] <= rec.keys()
    for section in set(want) - {""}:
        assert want[section] <= rec[section].keys(), section
    assert {"total_bytes", "by_op", "top"} <= rec["collectives"].keys()
    # tests/launch/test_dryrun_smoke.py's assertions
    assert rec["arch"] == arch
    assert all(v >= 0 for v in rec["roofline_terms"].values())
    assert rec["dominant_term"] in ("compute_s", "memory_s", "collective_s")
    assert rec["memory"]["argument_bytes"] > 0
    if shape.startswith("train"):
        assert rec["cost"]["hlo_flops"] > 0
        assert rec["params"]["total"] > 0
    n = math.prod(int(x) for x in mesh.split("x"))
    assert rec["n_devices"] == n
    coll = rec["collectives"]
    if n > 1:       # rank 0's sharded program: the bytes it receives over NVLink
        assert coll["total_bytes"] > 0 and coll["top"] and coll["largest"] > 0
        assert coll["total_bytes"] == sum(v["bytes"] for v in coll["by_op"].values())
        assert rec["roofline_terms"]["collective_s"] == coll["total_bytes"] / cap.NVLINK_RX_BW
        assert rec["collective_link"] == dryrun.COLLECTIVE_LINK
    else:
        assert rec["roofline_terms"]["collective_s"] == 0.0 and coll["total_bytes"] == 0.0
    assert rec["step_time_lower_bound_s"] == max(rec["roofline_terms"].values())
    assert "per_device_terms" not in rec
    json.dumps(rec)


def test_multi_pod_axis_shards():
    """The reference's multi-pod case: the batch and the parameters divide
    over the 2x2x2 mesh, so a device holds less than the whole."""
    one = dryrun.run_cell("gemma2-9b", "train_4k", "1", reduced=True)
    pod = dryrun.run_cell("gemma2-9b", "train_4k", "2x2x2", reduced=True)
    assert pod["n_devices"] == 8
    assert pod["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]
    # B 8 over (pod, data) = 4 devices, replicated over model
    assert pod["memory"]["argument_groups"]["batch"] * 4 == one["memory"]["argument_groups"]["batch"]
    # rank 0's own program: its share of the work, and the collectives' and the replicas' besides
    assert one["cost"]["hlo_flops"] <= pod["cost"]["hlo_flops"] * 8 < one["cost"]["hlo_flops"] * 2


def test_records_feed_the_pod_runtime(tmp_path):
    """The CLI's artifacts load through capacity_from_roofline unchanged,
    and DianaGridRuntime places with their step costs."""
    out = tmp_path / "dr"
    dryrun.main(["--arch", "gemma2-9b", "--shape", "train_4k", "--mesh", "1", "--reduced", "--out", str(out)])
    dryrun.main(["--arch", "mamba2-780m", "--shape", "decode_32k", "--mesh", "1", "--reduced", "--out", str(out)])
    assert len(list(out.glob("*.json"))) == 2
    pods = [cap.capacity_from_roofline("p0", out, chips=1), cap.capacity_from_roofline("p1", out, chips=1)]
    recs = {(r["arch"], r["shape"]): r for r in (json.loads(p.read_text()) for p in out.glob("*.json"))}
    for key, r in recs.items():
        assert pods[0].step_cost(*key) == r["step_time_lower_bound_s"] > 0
    grid = grid_rt.DianaGridRuntime(pods)
    item = grid_rt.WorkItem(user="u", arch="gemma2-9b", shape="train_4k", steps=10)
    assert grid.pods["p0"].work_seconds(item) == 10 * recs[("gemma2-9b", "train_4k")]["step_time_lower_bound_s"]
    placed = grid.schedule_bulk([grid_rt.WorkItem(user="u", arch="gemma2-9b", shape="train_4k", steps=10)
                                 for _ in range(6)], division_factor=2)
    assert sum(len(v) for v in placed.values()) == 6 and set(placed) <= {"p0", "p1"}


def test_the_whole_sweep_launches_no_kernel(tmp_path, capsys):
    """``--all`` (reduced here; the full sweep takes about two minutes):
    a record for each of the 34 runnable cells, every counter unmoved."""
    before = _launch_counts()
    dryrun.main(["--all", "--mesh", "1", "--reduced", "--out", str(tmp_path)])
    assert _launch_counts() == before
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == 34 and "34 records in" in capsys.readouterr().out
    assert {(r["arch"], r["shape"]) for r in recs} == {(a, s) for a, s, ok in cells(list_archs()) if ok}


def test_cli_refuses_what_waits_for_the_sharded_paths(tmp_path):
    """What refused before the per-rank programs now writes records:
    ``--moe-impl a2a`` and ``auto`` on a deepseek cell (rank 0's a2a
    dispatch, its all-to-alls counted), ``--compress-pod-grads`` at
    2x2x2 (the pod axis's int32 sum counted) and at mesh 1 (a no-op)."""
    from repro_torch.models import moe

    for i, extra in enumerate((["--moe-impl", "a2a"], ["--moe-impl", "auto"])):
        out = tmp_path / f"moe{i}"
        dryrun.main(["--arch", "deepseek-v2-236b", "--shape", "train_4k", "--mesh", "1x4", "--reduced",
                     "--out", str(out), *extra])
        rec = json.loads(next(out.glob("*.json")).read_text())
        assert rec["collectives"]["by_op"]["all_to_all"]["count"] > 0
        assert rec["collectives"]["by_op"]["all_to_all.backward"]["count"] > 0
        assert moe.MOE_IMPL == "gather"                 # the CLI leaves the dispatch as it found it
    plain = dryrun.run_cell("gemma2-9b", "train_4k", "2x2x2", reduced=True)
    dryrun.main(["--arch", "gemma2-9b", "--shape", "train_4k", "--mesh", "2x2x2", "--reduced", "--out",
                 str(tmp_path / "pod"), "--compress-pod-grads"])
    rec = json.loads(next((tmp_path / "pod").glob("*.json")).read_text())
    assert rec["compress_pod_grads"] and not plain["compress_pod_grads"]
    assert any(" pod int32[" in line for line in rec["collectives"]["top"])
    assert not any(" pod int32[" in line for line in plain["collectives"]["top"])
    one = dryrun.run_cell("gemma2-9b", "train_4k", "1", reduced=True, compress_pod_grads=True)
    assert one["roofline_terms"] == dryrun.run_cell("gemma2-9b", "train_4k", "1", reduced=True)["roofline_terms"]


# -- a decode step holds the rules' blocks and receives one-token activations only ---------

DECODE_CELLS = [(a, s) for a, s, ok in cells(list_archs()) if ok and SHAPES[s].kind == "decode"]
# the six families at reduced size; the reduced llama-3.2-vision has no cross layer, so 8 layers with one every 4
DECODE_FAMILIES = {"gemma2-9b": {}, "recurrentgemma-2b": {}, "mamba2-780m": {},
                   "llama-3.2-vision-11b": dict(num_layers=8, cross_attn_every=4), "whisper-base": {},
                   "deepseek-v2-236b": {}}


@pytest.mark.parametrize("mesh", ["1x4", "2x2", "2x2x2"])
def test_every_reduced_decode_cell_holds_the_rules_blocks(mesh):
    """Rank 0 of every reduced decode cell holds exactly the bytes the rules
    count, parameters and caches (``run_cell`` checks it for every cell;
    here it is also read off the record): the cells whose stacked layer axis
    is as long as the batch at 2x2x2 (nemotron, mistral, whisper: 4 layers at
    B 4; ROADMAP C13) write records too."""
    for arch, shape in DECODE_CELLS:
        rec = dryrun.run_cell(arch, shape, mesh, reduced=True)
        assert rec["memory"]["held_groups"] == rec["memory"]["argument_groups"], (arch, shape)
        assert rec["collectives"]["parameter_gathers"] == {}, (arch, shape)


def _received(cfg, B: int, S: int, mesh: dict) -> dict:
    return dryrun.analyze_rank_step(cfg, Shape("decode_32k", S, B, "decode"), mesh)[1]


def _buffer_shape(desc: str) -> tuple:
    """The buffer's shape of a ``launch.mesh.received`` call description."""
    inner = desc.split("[", 1)[1].split("]", 1)[0]
    return tuple(int(n) for n in inner.split(",")) if inner else ()


def _parameter_blocks(cfg, mesh: dict) -> dict:
    """shape → name of every block of a parameter of the reduced model
    that a rank could hold or gather: its serving block
    (``param_specs(serve=True)``) gathered over each subset of the mesh
    axes that cut it, the empty one (the block) and the whole (the
    parameter) included."""
    from itertools import combinations

    from repro_torch.launch.mesh import spec_axes
    from repro_torch.runtime import sharding

    lm = LM(cfg, device="meta")
    out = {}
    for name, spec in sharding.param_specs(mesh, lm, serve=True).items():
        shape = tuple(lm.get_parameter(name).shape)
        axes = sorted({a for e in spec for a in spec_axes(e) if mesh.get(a, 1) > 1})
        for cut in (c for k in range(len(axes) + 1) for c in combinations(axes, k)):
            sub = tuple(tuple(a for a in spec_axes(e) if a in cut) or None for e in spec)
            out[sharding.block_shape(shape, sub, mesh)] = name
    return out


@pytest.mark.parametrize("mesh", [{"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2}], ids=["2x2", "2x2x2"])
@pytest.mark.parametrize("arch", list(DECODE_FAMILIES))
def test_a_decode_step_receives_one_token_activations_only(arch, mesh):
    """Rank 0's bytes received (meta) in one decode step of the reduced
    model, B 4 over max_len 256: the same at max_len 512, since no cache
    block moves, and twice as many at B 8, since all that moves is one
    token a row; no gather receives a block of a parameter, gathered over
    any of its axes or none. The moe family's dispatch moves slots of a
    capacity that does not follow the batch; there no call of any kind
    receives one."""
    cfg = get_config(arch, reduced=True).replace(**DECODE_FAMILIES[arch])
    base = _received(cfg, 4, 256, mesh)
    assert base["total"] > 0
    assert _received(cfg, 4, 512, mesh)["by_kind"] == base["by_kind"]
    blocks = _parameter_blocks(cfg, mesh)
    moves = [d for d in base["calls"] if _buffer_shape(d) in blocks and (cfg.family == "moe" or
                                                                         d.startswith("all_gather "))]
    assert moves == [], [(d, blocks[_buffer_shape(d)]) for d in moves]
    assert base["parameter_gathers"] == []
    if cfg.family != "moe":
        assert {k: 2 * v for k, v in base["by_kind"].items()} == _received(cfg, 8, 256, mesh)["by_kind"]


def test_the_dry_run_lists_a_decode_step_s_parameter_gathers(monkeypatch):
    """Where the gather dispatch gathers a held expert block at use (12
    experts on 2 × 4 under serving's ZeRO: E over 'model', d over 'data';
    at published width deepseek-v2's 160 experts at 16 × 16, ROADMAP Next
    3), the record lists the gather, with the blocks of the experts' shape
    gathered over 'data', and the test above's check catches it."""
    from repro_torch.runtime import sharding

    monkeypatch.setattr(sharding, "_SERVE_ZERO3_BUDGET", 0)
    mesh = {"data": 2, "model": 4}
    cfg = get_config("deepseek-v2-236b", reduced=True).replace(num_experts=12)
    coll = _received(cfg, 8, 256, mesh)
    E, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    assert coll["parameter_gathers"] == [f"all_gather data bfloat16[{E // 4},{d // 2},{f}] g=2"], coll["calls"]
    assert _parameter_blocks(cfg, mesh)[(E // 4, d // 2, f)].endswith((".w_gate", ".w_up", ".w_down"))
    rec = dryrun._collectives(coll)
    assert list(rec["parameter_gathers"]) == coll["parameter_gathers"]


@pytest.mark.parametrize("arch,shape,mesh,want", [
    ("gemma2-9b", "train_4k", "1", 128), ("gemma2-9b", "train_4k", "single", 8),
    ("mistral-large-123b", "train_4k", "1", 256), ("whisper-base", "train_4k", "1", 1),
    ("mamba2-780m", "train_4k", "multi", 2)])
def test_auto_microbatches_equal_the_reference(arch, shape, mesh, want):
    from repro_torch.launch.mesh import mesh_from_arg

    rd = _ref_dryrun()

    class _Mesh:            # the reference reads mesh.shape only
        shape = mesh_from_arg(mesh)

    got = dryrun.auto_microbatches(get_config(arch), SHAPES[shape], mesh_from_arg(mesh))
    assert got == rd.auto_microbatches(ref_get_config(arch), SHAPES[shape], _Mesh) == want


def test_a_full_width_decode_cell():
    """gemma2-9b decode_32k at mesh 1: arguments (weights, the 42 layers'
    caches, the tokens) and the 42 decode-kernel calls at the last
    position, each against its own sum."""
    before = _launch_counts()
    rec = dryrun.run_cell("gemma2-9b", "decode_32k", "1")
    assert _launch_counts() == before
    assert rec["compile_seconds"] < 20
    cfg = get_config("gemma2-9b")
    lm = LM(cfg, device="meta")
    B, S_ = 128, 32768
    cache = abstract_cache(lm, B, S_)
    groups = rec["memory"]["argument_groups"]
    assert groups["params"] == sum(p.numel() * p.element_size() for p in lm.parameters())
    assert groups["cache"] == sum(t.numel() * 2 for t in cache.values())
    assert groups["batch"] == B * 4
    assert rec["memory"]["argument_bytes"] == sum(groups.values())
    H, KV, D, W = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, cfg.local_window
    local, glob = da_ops.work(B, H, KV, D, W - 1), da_ops.work(B, H, KV, D, S_ - 1)
    assert rec["kernels"] == {"decode_attention": {"calls": 42, "flops": 21 * (local[0] + glob[0]),
                                                   "bytes": 21 * (local[1] + glob[1])}}
    assert rec["cost"]["hlo_flops"] == rec["cost"]["xla_raw_flops"] + 21 * (local[0] + glob[0])
    assert rec["tokens_per_step"] == B and rec["params"]["total"] == 9_241_404_928
    assert rec["model_flops_per_device"] == 2.0 * 9_241_404_928 * B
    assert rec["dominant_term"] == "memory_s" and not rec["fits_device_memory"]


# -- op_analysis ------------------------------------------------------------------------

def test_analysis_counts_products_bytes_and_the_high_water_mark():
    a, b = torch.empty(64, 32, device="meta"), torch.empty(32, 16, device="meta")

    def f():
        x = a @ b                     # 2·64·32·16 FLOPs; 8 KiB + 2 KiB in, 4 KiB out
        y = x.relu()                  # x and y live: 8 KiB
        del x
        z = y.t()                     # a view: no traffic, no storage
        return z.sum()

    with OpAnalysis() as mode:
        out = f()
    c = mode.cost
    assert out.shape == () and c.flops == c.aten_flops == 2 * 64 * 32 * 16
    assert c.hbm_bytes == (8192 + 2048 + 4096) + (4096 + 4096) + (4096 + 4)
    assert c.peak_bytes == 8192 and c.ops == 4
    assert c.top_hbm[0] == (14336.0, "aten.mm.default -> float32[64, 16]")


def test_analysis_charges_the_kernels():
    with OpAnalysis() as mode:
        _counting.charge("k", 10, 20)
        _counting.charge("k", 1, 2)
    assert mode.cost.flops == 11 and mode.cost.hbm_bytes == 22
    assert mode.cost.by_kernel == {"k": {"calls": 2, "flops": 11, "bytes": 22}}
    _counting.charge("k", 1, 1)                         # no active counter: nothing happens
    assert mode.cost.flops == 11


def test_trips_count_one_trip_times_n():
    w = torch.empty(16, 16, device="meta")

    def loop():
        acc = torch.zeros(16, 16, device="meta")
        for _ in _counting.trips(8):
            acc = acc + w @ w
        return acc

    assert list(_counting.trips(3)) == [0, 1, 2]
    costs = []
    for trips in (False, True):
        with OpAnalysis(trips=trips) as mode:
            loop()
        costs.append(mode.cost)
    plain, tripped = costs
    assert plain.flops == tripped.flops == 8 * 2 * 16 ** 3
    assert plain.ops == tripped.ops
    with pytest.raises(RuntimeError, match="only meta programs"):
        with OpAnalysis(trips=True):
            torch.ones(2) + 1


def test_train_step_trips_count_every_microbatch():
    """A train step of 4 microbatches counted with trips equals the same
    step counted microbatch by microbatch, in FLOPs and kernel work."""
    sh = Shape("train_4k", 64, 8, "train")
    costs = []
    for trips in (False, True):
        lm = LM(get_config("gemma2-9b", reduced=True), device="meta")
        args = dryrun.step_arguments(lm, sh)
        step = dryrun.make_step(lm, sh, microbatches=4)
        with OpAnalysis(trips=trips) as mode:
            step(args)
        costs.append(mode.cost)
    assert costs[0].flops == costs[1].flops and costs[0].by_kernel == costs[1].by_kernel
    assert costs[1].by_kernel["flash_attention_bwd"]["calls"] == 4 * lm.cfg.num_layers


# -- the smoke's bounds through the work functions ----------------------------------------

def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_module", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_bounds_are_unchanged():
    """Each timed shape's (bytes, operations) as chip_smoke.py counted them
    before the counts moved into the kernels' work functions, through the
    smoke's ``bound``: the same floats."""
    cs = _smoke()
    pairs = fa_ops.visible_pairs
    B, S_, H, KV, D = (cs.PREFILL[k] for k in ("B", "S", "H", "KV", "D"))
    for window in (0, 4096):
        old = cs.bound((2 * B * S_ * H * D + 2 * B * S_ * KV * D) * 2, 4 * B * H * D * pairs(S_, S_, True, window),
                       "bf16")
        flops, nbytes = fa_ops.work(B, S_, S_, H, KV, D, D, window=window)
        assert cs.bound(nbytes, flops, "bf16") == old
    for c in cs.FLASH_ROWS.values():
        B_, Sq, Sk, H_, KV_, D_ = (c[k] for k in ("B", "Sq", "Sk", "H", "KV", "D"))
        old = cs.bound((2 * B_ * Sq * H_ * D_ + 2 * B_ * Sk * KV_ * D_) * 2,
                       4 * B_ * H_ * D_ * pairs(Sq, Sk, c["causal"], 0), "bf16")
        flops, nbytes = fa_ops.work(B_, Sq, Sk, H_, KV_, D_, D_, causal=c["causal"])
        assert cs.bound(nbytes, flops, "bf16") == old
    B, S_, H, DQK, DV = (cs.MLA_ROW[k] for k in ("B", "S", "H", "DQK", "DV"))
    old = cs.bound(2 * B * S_ * H * (DQK + DV) * 2, 2 * B * H * pairs(S_, S_, True, 0) * (DQK + DV), "bf16")
    flops, nbytes = fa_ops.work(B, S_, S_, H, H, DQK, DV)
    assert cs.bound(nbytes, flops, "bf16") == old
    B, S_, H, KV, D, W = (cs.DECODE[k] for k in ("B", "S", "H", "KV", "D", "W"))
    rows = [(B, H, KV, D, S_ - 1), (B, H, KV, D, min(cs.DECODE["ring_pos"], W - 1))]
    rows += [(c["B"], c["H"], c["KV"], c["D"], c["pos"]) for c in cs.DECODE_ROWS.values()]
    for B_, H_, KV_, D_, pos in rows:
        visible = pos + 1
        old = cs.bound(2 * B_ * visible * KV_ * D_ * 2 + 2 * B_ * H_ * D_ * 2, 4 * B_ * H_ * D_ * visible, "bf16")
        flops, nbytes = da_ops.work(B_, H_, KV_, D_, pos)
        assert cs.bound(nbytes, flops, "bf16") == old
    B, S_, H, KV, D = (cs.BWD_ROW[k] for k in ("B", "S", "H", "KV", "D"))
    for window in (0, 4096):
        old = cs.bound((4 * B * S_ * H * D + 4 * B * S_ * KV * D) * 2,
                       2 * (3 * D + 2 * D) * H * pairs(S_, S_, True, window) * B, "bf16")
        flops, nbytes = fa_ops.bwd_work(B, S_, S_, H, KV, D, D, window=window)
        assert cs.bound(nbytes, flops, "bf16") == old


def test_smoke_training_bound_is_unchanged():
    cs = _smoke()
    from repro_torch.models.common import layer_flags

    cfg = get_config("gemma2-9b").replace(num_layers=cs.TRAIN["layers"])
    n_params, B, S_ = 2_503_000_000, cs.TRAIN["B"], cs.TRAIN["S"]
    attn = 0.0
    for g in layer_flags(cfg)["is_global"]:
        p = fa_ops.visible_pairs(S_, S_, True, 0 if g else cfg.local_window)
        attn += (4 * cfg.head_dim_ + 2 * (3 * cfg.head_dim_ + 2 * cfg.head_dim_)) * cfg.num_heads * p * B
    assert cs.train_bound_ops(cfg, n_params, B, S_) == 6.0 * n_params * B * S_ + attn
