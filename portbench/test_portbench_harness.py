"""CPU tests of the benchmark's harness, at sizes a test run holds.

The port runs on the host here (``device="cpu"``) in float32 or bfloat16;
the card's numbers come only from ``run.py`` on the card.
"""
import ast
import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import counts, harness, judge, model
from portbench.cells import Cell, as_run, reader, resolve
from portbench.reference import Reference
from portbench.traffic import Traffic
from portbench.window import Driver

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"

TINY_MOE = {
    "model_type": "deepseek_v2", "num_hidden_layers": 3, "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 4, "intermediate_size": 96, "hidden_act": "silu", "vocab_size": 512,
    "max_position_embeddings": 512, "rope_theta": 10000, "tie_word_embeddings": False, "torch_dtype": "float32",
    "rms_norm_eps": 1e-6, "q_lora_rank": 32, "kv_lora_rank": 16, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "n_routed_experts": 16, "n_shared_experts": 1, "num_experts_per_tok": 4,
    "moe_intermediate_size": 32, "first_k_dense_replace": 1, "capacity_factor": 1.25, "scoring_func": "softmax",
}
TINY_DENSE = {
    "model_type": "nemotron", "num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128, "hidden_act": "relu2",
    "vocab_size": 512, "max_position_embeddings": 512, "rope_theta": 10000, "tie_word_embeddings": False,
    "torch_dtype": "float32", "rms_norm_eps": 1e-6,
}
CLOSED = {"loop": "closed", "tenants": 3, "quota": 1.0, "groups_queued": 2, "group_size": [8, 8],
          "prompt_len": [4], "output_len": 5, "slots": 32, "max_len": 16}
OPEN = {"loop": "open", "tenants": 3, "quota": 1.0, "tenant_zipf_s": 1.1, "rate_rps": 40.0, "schedule_seed": 0,
        "horizon_s": 30, "lead_in_s": 0.1, "group_size": [1, 3], "prompt_len": [3, 5], "output_len": 5,
        "slots": 8, "max_len": 16}
LIMITS = {"sample": {"batches": 2, "lanes": None}, "limits": {"token_miss": 0.13, "lane_gap_mean_max": 0.05}}


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny products are slower on many host threads than on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell(cfg=TINY_MOE, mix=CLOSED, limits=LIMITS) -> Cell:
    return Cell("tiny", 1, cfg["model_type"], cfg, "tiny", mix, limits,
                [{"name": n, "unit": "u"} for n in ("tokens_per_s", "setup_s")],
                [{"name": n, "unit": "u"} for n in ("submit_ms", "queue_wait_p95_s", "request_turnaround_mean_s",
                                                    "request_turnaround_p95_s", "batch_fill", "step_ms",
                                                    "step_mfu", "device_idle_share", "decode_attention_roofline")])


# -- traffic -------------------------------------------------------------------------

def _closed_groups(seed: int):
    t = Traffic(CLOSED, seed, 512)
    return t.refill(0.0, {}) + t.refill(1.0, {"tenant0": 1, "tenant1": 2, "tenant2": 2})


def test_closed_traffic_same_seed_same_inputs_other_seed_other_tokens():
    a, b, c = _closed_groups(5), _closed_groups(5), _closed_groups(6)
    assert [(g.user, g.due, g.prompts.shape) for g in a] == [(g.user, g.due, g.prompts.shape) for g in c]
    assert all(np.array_equal(x.prompts, y.prompts) for x, y in zip(a, b))
    assert not all(np.array_equal(x.prompts, y.prompts) for x, y in zip(a, c))
    assert len(a) == 6 + 1                      # two groups a tenant, then tenant0 topped up


def test_open_traffic_replays_one_schedule_and_draws_tokens_from_the_seed():
    big = 2 ** 31 + 12345                       # seeds past 32 signed bits
    a, b, c = Traffic(OPEN, big, 512), Traffic(OPEN, big, 512), Traffic(OPEN, big + 1, 512)
    assert a._queue == c._queue                 # the same arrivals, sizes, lengths and tenants
    ga, gb, gc = a.due(5.0), b.due(5.0), c.due(5.0)
    assert len(ga) > 50 and [g.due for g in ga] == sorted(g.due for g in ga)
    assert ga[0].due < 0                        # the lead-in starts before the window
    assert all(np.array_equal(x.prompts, y.prompts) for x, y in zip(ga, gb))
    assert not all(np.array_equal(x.prompts, y.prompts) for x, y in zip(ga, gc))
    assert {g.prompts.shape[1] for g in ga} == {3, 5}


# -- counts ----------------------------------------------------------------------------

def _cfg(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_counts_of_nemotron_4_15b_match_hand_worked_figures():
    cfg = _cfg("nemotron-4-15b")
    layer = 6144 * 6144 * 2 + 6144 * 1024 * 2 + 6144 * 24576 * 2          # q, o; k, v; up, down
    assert counts.params(cfg)["attention"] + counts.params(cfg)["mlp"] == 32 * layer == 12_482_248_704
    assert counts.total_params(cfg) == 12_482_248_704 + 2 * 256_000 * 6144 + 32 * 2 * 6144 + 6144
    assert counts.weight_bytes_per_step(cfg) == 2 * (12_482_248_704 + 1_572_864_000) + 4 * (65 * 6144)
    assert round(counts.weight_bytes_per_step(cfg) / 1e9, 2) == 28.11
    assert counts.matmul_params_per_token(cfg) == 14_055_112_704
    assert round(512 * 2 * counts.matmul_params_per_token(cfg) / 1e12, 1) == 14.4
    assert counts.attention_flops(cfg, 127) == 32 * 2 * 48 * 256 * 128
    assert counts.kv_cache_bytes(cfg, 512, 256) == 32 * 512 * 256 * 2 * 8 * 128 * 2 == 17_179_869_184
    assert counts.decode_attention_work(512, 48, 8, 128, 63) == (
        4 * 512 * 48 * 128 * 64, (2 * 512 * 64 * 8 * 128 + 2 * 512 * 48 * 128) * 2)


def test_counts_of_deepseek_v2_stage_match_hand_worked_figures():
    cfg = _cfg("deepseek-v2-236b")
    assert counts.total_params(cfg) == 21_247_144_960                   # phase 9's six layers
    p = counts.params(cfg)
    assert p["experts"] == 5 * 160 * 3 * 5120 * 1536
    assert round(2 * p["experts"] / 1e9, 1) == 37.7
    assert round(counts.weight_bytes_per_step(cfg) / 1e9, 1) == 41.5
    mla = 5120 * 1536 + 1536 * 128 * 192 + 5120 * 576 + 512 * 128 * 256 + 128 * 128 * 5120
    assert counts.matmul_params_per_token(cfg) == (6 * mla + 3 * 5120 * 12288 + 5 * 5120 * 160
                                                   + 5 * 3 * 5120 * 3072 + 5 * 6 * 3 * 5120 * 1536 + 102400 * 5120)
    assert round(2 * counts.matmul_params_per_token(cfg) / 1e9, 2) == 5.11
    assert counts.kv_cache_bytes(cfg, 256, 256) == 6 * 256 * 256 * 576 * 2


# -- the reference against the port -------------------------------------------------------

@pytest.mark.parametrize("cfg", [TINY_MOE, TINY_DENSE], ids=["moe", "dense"])
def test_reference_equals_the_port_decode_at_reduced_size(cfg):
    from repro_torch.models import decode

    lm = model.build(cfg, "cpu")
    model.fill_weights(lm, 3)
    B, L = 32, 10
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg["vocab_size"], (B, L)))
    cache = decode.init_cache(lm, B, 16)
    port = torch.cat([decode.decode_step(lm, tokens[:, t:t + 1], cache, t)[0] for t in range(L)], dim=1)
    ref = Reference(model.named_weights(lm), cfg)
    got = ref.logits(ref.hidden(tokens), ref.head_table())
    assert torch.allclose(got, port[..., :cfg["vocab_size"]], atol=2e-4, rtol=1e-4)
    assert (ref.dropped > 0) == (cfg is TINY_MOE)   # 32 lanes × 4 choices over 16 experts of 10 slots


def test_port_config_refuses_what_the_port_does_not_compute():
    with pytest.raises(ValueError, match="routed_scaling_factor"):
        model.port_config(dict(TINY_MOE, routed_scaling_factor=16.0))
    published = _cfg("deepseek-v2-236b")
    with pytest.raises(ValueError, match="the port computes"):
        model.port_config({k: v for k, v in published.items() if k != "program_departs"})
    assert as_run(published)["topk_method"] == "greedy" and published["topk_method"] == "group_limited_greedy"
    assert model.port_config(as_run(published)).num_layers == 6
    assert model.port_config(_cfg("nemotron-4-15b")).mlp == "squared_relu"


# -- a whole run on the host, and its faults ----------------------------------------------------

def _run(cell, seed=11):
    return harness.run_cell(cell, seed, 0.3, False, "cpu", __import__("time").perf_counter())


@pytest.mark.parametrize("cfg,mix", [(TINY_MOE, CLOSED), (TINY_DENSE, OPEN)], ids=["moe-closed", "dense-open"])
def test_a_sound_run_is_correct(cfg, mix):
    line = _run(tiny_cell(cfg, mix))
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"tokens_per_s", "setup_s"} <= set(line["metrics"])
    assert list(line)[-1] == "checks" and line["checks"]["batches_wrong"]["value"] == 0


def _state_unchanged(monkeypatch):
    import repro_torch.models.decode as dec

    orig = dec.decode_step

    def step(lm, tokens, cache, pos, **kw):            # the cache written, then put back as it was
        saved = torch.utils._pytree.tree_map(lambda t: t.clone(), cache)
        logits, _ = orig(lm, tokens, cache, pos, **kw)
        torch.utils._pytree.tree_map(lambda t, s: t.copy_(s), cache, saved)
        return logits, cache
    monkeypatch.setattr(dec, "decode_step", step)


def _half_batch(monkeypatch):
    import repro_torch.models.decode as dec

    orig = dec.decode_step

    def step(lm, tokens, cache, pos, **kw):            # the second half of the lanes not computed
        logits, cache = orig(lm, tokens, cache, pos, **kw)
        B = logits.shape[0]
        logits[B // 2:] = logits[:B - B // 2]
        return logits, cache
    monkeypatch.setattr(dec, "decode_step", step)


def _token_altered(monkeypatch):
    from repro_torch.serving import ServingEngine

    orig = ServingEngine._greedy
    monkeypatch.setattr(ServingEngine, "_greedy", staticmethod(lambda logits: (orig(logits) + 1) % 512))


def _one_lane_altered(monkeypatch):
    from repro_torch.serving import ServingEngine

    orig = ServingEngine._greedy

    def greedy(logits):                                 # every token of lane 0 altered, the others sound
        out = orig(logits)
        out[0] = (out[0] + 1) % 512
        return out
    monkeypatch.setattr(ServingEngine, "_greedy", staticmethod(greedy))


def _steps_unseen(monkeypatch):
    from portbench.window import StepTap

    monkeypatch.setattr(StepTap, "take", lambda self: [])   # no decode_step call recorded


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered, _one_lane_altered, _steps_unseen],
                         ids=["state-unchanged", "half-batch", "token-altered", "one-lane-altered", "steps-unseen"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    line = _run(tiny_cell())
    assert not line["correct"], line["checks"]


def test_the_float8_control_fails_every_cells_limit():
    """The reference in float8 put in the program's place: on the same
    lanes and tokens, the share of the tokens it puts first that the
    float32 reference does not lies above every cell's ``token_miss``."""
    cell = tiny_cell(dict(TINY_MOE, torch_dtype="bfloat16"))
    lm, engine, traffic, tap = harness.setup(cell, 2, "cpu")
    try:
        rec = Driver(engine, traffic, tap).run(0.3)
    finally:
        tap.close()
    numbers, pred = judge.check_queue(torch, rec, 512)
    W = model.named_weights(lm)
    res = judge.check_model(torch, Reference(W, cell.config), rec, pred, {"batches": 3, "lanes": None}, True, 2,
                            "cpu", control=Reference(W, cell.config, "fp8"))
    limits = [json.loads(f.read_text())["limits"] for f in (BENCH / "limits").glob("*.json")]
    assert res["control"]["token_miss"] > max(lim["token_miss"] for lim in limits)
    assert res["token_miss"] < min(lim["token_miss"] for lim in limits)


def test_the_queue_comparison_fails_first_come_first_served():
    """A FIFO queue in place of §X's priorities is caught: the skewed
    tenant's requests are re-prioritised behind the others'."""
    from portbench.queue_ref import replay

    events = [("submit", i, "heavy" if i < 6 else f"t{i}", 1.0, float(i), 4) for i in range(9)] + [("batch",)]
    fifo = list(range(4))
    assert replay(events, 4)[0] != fifo
    assert set(replay(events, 4)[0]) >= {6, 7, 8}


# -- the harness finds everything by name ---------------------------------------------------

def test_a_new_cell_is_a_new_traffic_file_and_entries(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in tmp_path.rglob("*") if p.is_file()}
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    mix = dict(json.loads((tmp_path / "portbench/traffic/chat-open.json").read_text()), prompt_len=[1024],
               output_len=256)
    (tmp_path / "portbench/traffic/longctx.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/limits/nemo15b-longctx.json").write_text(json.dumps(LIMITS))
    spec["workloads"].append({"name": "nemo15b-longctx", "config": "nemotron-4-15b", "traffic": "longctx",
                              "chips": 1, "why": "long prompts"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = resolve(tmp_path, "nemo15b-longctx")
    assert cell.mix["prompt_len"] == [1024] and cell.config["hidden_size"] == 6144
    assert {m["name"] for m in cell.end_to_end} == {"tokens_per_s", "setup_s"}
    assert "decode_attention_roofline" not in {m["name"] for m in cell.per_layer}
    assert {"step_ms", "step_mfu", "device_idle_share"} <= {m["name"] for m in cell.per_layer}
    assert all(callable(reader(tmp_path, m["name"])) for m in cell.end_to_end + cell.per_layer)
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in before}
    assert {p for p in before if before[p] != after[p]} == {tmp_path / "BENCHMARK.json"}


def test_every_cell_of_the_benchmark_resolves():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = resolve(ROOT, w["name"])
        model.port_config(cell.config)
        assert set(cell.limits["limits"]) <= {"token_gap", "token_miss", "lane_gap_mean_max"}
        for m in cell.end_to_end + cell.per_layer:
            reader(ROOT, m["name"])


def test_the_command_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "dsv2-bulk", "--seed", "1", "--seconds", "1"], 0.0) != 0
    assert capsys.readouterr().out == ""


# -- imports --------------------------------------------------------------------------------

def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package_and_the_reference_nothing_of_the_port():
    files = [p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts]
    assert len(files) > 15
    for p in files:
        assert not _imports(p) & {"jax", "jaxlib", "flax", "repro"}, p
    for name in ("reference.py", "queue_ref.py", "counts/__init__.py", "traffic.py", "judge.py"):
        assert "repro_torch" not in _imports(BENCH / name), name
