"""The port's tracing (``repro_torch.tracing``) on the CPU: the recorder
itself, the served path's spans, marks and counters on a tiny dense and a
tiny moe model, and the engine's outputs with tracing on and off."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.models import LM
from repro_torch.models.moe import _positions_in_expert, _route, moe_layer
from repro_torch.serving import InferenceRequest, ServingEngine

SMALL = dict(num_layers=2, remat=False, param_dtype="float32", compute_dtype="float32")
ARCHS = {"dense": ("gemma2-9b", SMALL), "moe": ("deepseek-v2-236b", dict(param_dtype="float32",
                                                                           compute_dtype="float32"))}

# the span each span opens inside (None: at the top)
PARENTS = {
    "engine.submit": {None}, "engine.step": {None},
    "engine.form_batch": {"engine.step"}, "engine.prefill": {"engine.step"}, "engine.generate": {"engine.step"},
    "step.launch": {"engine.prefill", "engine.generate"}, "step.readback": {"engine.generate"},
    "step.bookkeep": {"engine.generate"},
    "decode.embed": {"step.launch"}, "decode.block": {"step.launch"}, "decode.head": {"step.launch"},
    "decode.attn": {"decode.block"}, "decode.mla": {"decode.block"}, "decode.mlp": {"decode.block"},
    "decode.moe": {"decode.block"},
    "moe.route": {"decode.moe"}, "moe.dispatch": {"decode.moe"}, "moe.experts": {"decode.moe"},
    "moe.combine": {"decode.moe"},
}


@pytest.fixture
def recording():
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()


@pytest.fixture(scope="module", params=sorted(ARCHS))
def lm(request):
    arch, kw = ARCHS[request.param]
    cfg = get_config(arch, reduced=True).replace(**kw)
    model = LM(cfg, device="cpu")
    g = torch.Generator()
    g.manual_seed(0)
    model.init(g)
    return model


def _serve(lm):
    """Two prompt lengths, more requests than lanes: three batches."""
    rng = np.random.default_rng(0)
    eng = ServingEngine(lm, num_slots=3, max_len=24, quotas={"a": 1.0, "b": 2.0})
    reqs = [InferenceRequest(user="ab"[i % 2], prompt=rng.integers(0, lm.cfg.vocab_size, 4 if i < 5 else 6)
                             .astype(np.int32), max_new_tokens=3 + i % 3, group_id=f"g{i // 4}") for i in range(7)]
    for i in range(0, 7, 4):
        eng.submit_group(reqs[i:i + 4], now=float(i))
    stats = eng.run_until_drained()
    return eng, reqs, dataclasses.asdict(stats)


def _outputs(reqs, stats):
    return [(r.rid % 7, r.generated, r.first_token_time, r.finish_time) for r in reqs], stats


def test_the_recorder_nests_counts_and_marks(recording):
    with tracing.span("a", k=1) as a:
        with tracing.span("b"):
            tracing.count("n", 2)
            tracing.count("n", torch.tensor(3))
        a.set(j=2)
        tracing.mark(7, "first_token")
    with tracing.span("c"):
        pass
    rec = tracing.collect()
    assert [(s.name, s.parent, s.attrs) for s in rec.spans] == [("a", -1, {"k": 1, "j": 2}), ("b", 0, {}),
                                                               ("c", -1, {})]
    a, b, c = rec.spans
    assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns <= c.start_ns <= c.end_ns
    assert rec.counts == {"n": 5} and isinstance(rec.counts["n"], int)
    assert [(rid, name) for rid, name, _ in rec.marks] == [(7, "first_token")]
    assert a.start_ns <= rec.marks[0][2] <= a.end_ns
    tracing.disable()
    assert not tracing.is_on() and tracing.collect().spans == []


def test_off_records_nothing_and_every_off_span_is_one_shared_context():
    assert not tracing.is_on()
    assert tracing.span("x") is tracing.span("y", k=1)
    with tracing.span("x") as s:
        s.set(k=1)
        tracing.count("n", 1)
        tracing.mark(1, "first_token")
    assert tracing.collect() == tracing.Recording()


def test_the_engine_serves_the_same_with_tracing_on_and_off(lm):
    _, reqs, stats = _serve(lm)
    assert tracing.collect().spans == []
    tracing.enable()
    try:
        _, reqs_on, stats_on = _serve(lm)
        assert tracing.collect().spans
    finally:
        tracing.disable()
    assert _outputs(reqs_on, stats_on) == _outputs(reqs, stats)


def test_the_served_path_records_its_spans_marks_and_counters(lm, recording):
    eng, reqs, stats = _serve(lm)
    rec = tracing.collect()
    names = {s.name for s in rec.spans}
    for s in rec.spans:
        assert (rec.spans[s.parent].name if s.parent >= 0 else None) in PARENTS[s.name], s
        assert s.start_ns <= s.end_ns
    steps = rec.named("engine.step")
    assert len(rec.named("engine.submit")) == 2 and [s.attrs["requests"] for s in rec.named("engine.submit")] == [4, 3]
    assert len(steps) == stats["batches"] == len(rec.named("engine.form_batch")) == 3
    assert [s.attrs["batch"] for s in steps] == [0, 1, 2] and sum(s.attrs["lanes"] for s in steps) == 7
    plens = sum(s.attrs["plen"] for s in steps)
    assert len(rec.named("step.launch")) == plens + stats["decode_steps"]
    assert len(rec.named("step.readback")) == len(rec.named("step.bookkeep")) == stats["decode_steps"] + 3
    moe = lm.cfg.family == "moe"
    layers = lm.cfg.num_layers
    launches = len(rec.named("step.launch"))
    assert len(rec.named("decode.embed")) == len(rec.named("decode.head")) == launches
    assert len(rec.named("decode.block")) == launches * layers
    assert {s.attrs["kind"] for s in rec.named("decode.block")} == {"mla" if moe else "attn"}
    routed = layers - lm.cfg.first_k_dense if moe else 0
    assert len(rec.named("decode.moe")) == len(rec.named("moe.dispatch")) == launches * routed
    assert ("moe.route" in names) == moe and ("decode.attn" in names) != moe
    # one first token a request, stamped after its batch's first readback
    firsts = {rid: ns for rid, name, ns in rec.marks if name == "first_token"}
    assert sorted(firsts) == sorted(r.rid for r in reqs) and len(rec.marks) == 7
    first_reads = [next(r for r in rec.named("step.readback") if r.start_ns >= s.start_ns) for s in steps]
    assert all(any(rb.end_ns <= ns <= s.end_ns for rb, s in zip(first_reads, steps)) for ns in firsts.values())
    if moe:
        T = eng.num_slots
        assert rec.counts["moe.routed"] == launches * routed * T * lm.cfg.top_k
        assert 0 <= rec.counts["moe.dropped"] < rec.counts["moe.routed"]
    else:
        assert rec.counts == {}


def test_moe_counters_equal_a_host_count_where_tokens_drop(recording):
    cfg = get_config("deepseek-v2-236b", reduced=True).replace(param_dtype="float32", compute_dtype="float32",
                                                              capacity_factor=0.5)
    model = LM(cfg, device="cpu")
    g = torch.Generator()
    g.manual_seed(1)
    model.init(g)
    params = model.moe_blocks[0].moe
    x = torch.randn(4, 16, cfg.d_model, generator=g)
    dropped = routed = 0
    with torch.no_grad():
        for xb in (x, x[:2]):
            moe_layer(params, xb, cfg)
            T = xb.shape[0] * xb.shape[1]
            C = max(8, int(T * cfg.top_k * cfg.capacity_factor / cfg.num_experts))
            _, idx, _ = _route(params, xb.reshape(T, -1), cfg)
            dropped += int((_positions_in_expert(idx, cfg.num_experts) >= C).sum())
            routed += T * cfg.top_k
    assert dropped > 0
    assert tracing.collect().counts == {"moe.routed": routed, "moe.dropped": dropped}
