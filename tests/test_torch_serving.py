"""The port's serving engine, on the CPU: the reference engine's own
cases (tests/substrate/test_serving_grid.py) on the port, the port
against the reference engine (same weights and requests → the same
tokens, first-token times and stats), and the CLI."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM
from repro.serving import InferenceRequest as RefRequest, ServingEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import LM, params_from_reference
from repro_torch.serving import InferenceRequest, ServingEngine
from test_torch_models import warm_cpu_math

warm_cpu_math()

SMALL = dict(num_layers=2, remat=False, param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def engine_setup():
    ref_cfg = ref_get_config("gemma2-9b", reduced=True).replace(**SMALL)
    cfg = get_config("gemma2-9b", reduced=True).replace(**SMALL)
    ref_lm = RefLM(ref_cfg)
    params = ref_lm.init(jax.random.PRNGKey(0))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return cfg, lm, ref_lm, params


def _req(cfg, user, rng, n_new=4, plen=6):
    return InferenceRequest(
        user=user,
        prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
        max_new_tokens=n_new)


class TestServingEngine:
    def test_drains_all_requests(self, engine_setup):
        cfg, lm, _, _ = engine_setup
        rng = np.random.default_rng(0)
        eng = ServingEngine(lm, num_slots=2, max_len=32)
        reqs = [_req(cfg, "u", rng) for _ in range(5)]
        for r in reqs:
            eng.submit(r)
        stats = eng.run_until_drained()
        assert stats.served == 5
        assert all(r.done and len(r.generated) == 4 for r in reqs)

    def test_generation_deterministic(self, engine_setup):
        cfg, lm, _, _ = engine_setup
        rng = np.random.default_rng(1)
        prompt = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
        outs = []
        for _ in range(2):
            eng = ServingEngine(lm, num_slots=2, max_len=32)
            r = InferenceRequest(user="u", prompt=prompt.copy(), max_new_tokens=4)
            eng.submit(r)
            eng.run_until_drained()
            outs.append(r.generated)
        assert outs[0] == outs[1]

    def test_quota_priority_orders_batches(self, engine_setup):
        """§X: high-quota tenant jumps the low-quota flood."""
        cfg, lm, _, _ = engine_setup
        rng = np.random.default_rng(2)
        eng = ServingEngine(lm, num_slots=2, max_len=32, quotas={"hog": 10.0, "vip": 1000.0})
        hogs = [_req(cfg, "hog", rng) for _ in range(6)]
        eng.submit_group(hogs, now=0.0)
        vip = _req(cfg, "vip", rng)
        eng.submit(vip, now=1.0)
        eng.run_until_drained()
        assert vip.first_token_time is not None
        later_hogs = sum(1 for h in hogs if h.first_token_time > vip.first_token_time)
        assert later_hogs >= 3  # vip overtook most of the flood

    def test_prefix_cache_hits(self, engine_setup):
        cfg, lm, _, _ = engine_setup
        rng = np.random.default_rng(3)
        eng = ServingEngine(lm, num_slots=2, max_len=32)
        prompt = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
        for _ in range(3):
            eng.submit(InferenceRequest(user="u", prompt=prompt.copy(), max_new_tokens=2))
        eng.run_until_drained()
        assert eng.stats.prefix_hits >= 2

    def test_truncation_raises_by_default(self, engine_setup):
        cfg, lm, _, _ = engine_setup
        rng = np.random.default_rng(4)
        eng = ServingEngine(lm, num_slots=1, max_len=32)
        for _ in range(4):
            eng.submit(_req(cfg, "u", rng))
        with pytest.raises(RuntimeError, match="truncated"):
            eng.run_until_drained(max_cycles=1)
        assert eng.stats.truncated
        assert eng.stats.cycles == 1
        assert len(eng.queues) > 0          # partial drain really happened

    def test_truncation_flag_mode(self, engine_setup):
        cfg, lm, _, _ = engine_setup
        rng = np.random.default_rng(5)
        eng = ServingEngine(lm, num_slots=1, max_len=32)
        for _ in range(4):
            eng.submit(_req(cfg, "u", rng))
        stats = eng.run_until_drained(max_cycles=1, on_truncation="flag")
        assert stats.truncated and stats.cycles == 1
        stats = eng.run_until_drained(on_truncation="flag")
        assert stats.served == 4
        with pytest.raises(ValueError):
            eng.run_until_drained(on_truncation="ignore")


def _traffic(cfg, cls, n=10, seed=7):
    """Two tenants, mixed prompt lengths (two shape classes), a bulk group
    and a max_len cut: every branch of batch forming and truncation."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = 6 if i % 3 else 4
        reqs.append(cls(user=f"tenant-{'ab'[i % 2]}",
                        prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
                        max_new_tokens=3 + i % 4))
    reqs.append(cls(user="tenant-a", prompt=reqs[1].prompt.copy(), max_new_tokens=40))
    group = [cls(user="bulk", prompt=rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                 max_new_tokens=2) for _ in range(3)]
    return reqs, group


def test_engine_equals_the_reference_engine(engine_setup):
    """Same weights (float32) and requests: identical generated tokens,
    first-token times, finish times and EngineStats."""
    cfg, lm, ref_lm, params = engine_setup
    quotas = {"tenant-a": 100.0, "tenant-b": 30.0, "bulk": 10.0}
    runs = []
    for engine_cls, req_cls, args in ((RefEngine, RefRequest, (ref_lm, params)),
                                      (ServingEngine, InferenceRequest, (lm,))):
        eng = engine_cls(*args, num_slots=3, max_len=24, quotas=quotas)
        reqs, group = _traffic(cfg, req_cls)
        for i, r in enumerate(reqs):
            eng.submit(r, now=float(i))
        eng.submit_group(group, now=2.5)
        stats = eng.run_until_drained()
        runs.append(([(r.generated, r.first_token_time, r.finish_time, r.done)
                      for r in reqs + group], stats))
    (ref_out, ref_stats), (out, stats) = runs
    assert out == ref_out
    assert dataclasses.asdict(stats) == dataclasses.asdict(ref_stats)
    assert stats.served == 14 and stats.prefix_hits == 1


def test_cli_serves_on_the_host(capsys):
    stats, reqs = serve.main(["--device", "cpu", "--requests", "4", "--new-tokens", "3"])
    assert stats.served == 4 and stats.batches == 1 and stats.decode_steps == 2
    assert all(len(r.generated) == 3 for r in reqs)
    assert "served=4/4" in capsys.readouterr().out

