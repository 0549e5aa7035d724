"""The port's scenario pack (``repro_torch.scenarios``) against the
reference's, on the host: every pack at smoke scale gives the reference's
metrics exactly (invariants, twins and recorded envelopes verified on
the way), and the registry, baseline plumbing and CLI behave as the
reference's do — reading the reference's ``baseline.json`` in place and
writing only where the caller says."""
import json

import pytest

import repro.scenarios as RSc
import repro_torch.scenarios as PSc
from repro_torch.scenarios import __main__ as cli
from repro_torch.scenarios.common import REFERENCE_SCENARIOS

CPU = "cpu"


@pytest.mark.parametrize("name", PSc.SCENARIOS)
def test_smoke_metrics_equal_the_reference(name):
    spec, sim, result, metrics = PSc.run_scenario(name, scale="smoke", device=CPU)
    ref = RSc.run_scenario(name, scale="smoke")[3]
    assert repr(sorted(metrics.items())) == repr(sorted(ref.items()))
    assert spec.name == name and spec.scale == "smoke"
    assert metrics["finished"] == result.stats.finished > 0
    assert len(result.jobs) >= result.stats.finished     # retain_jobs on
    assert sim.device.type == CPU


def test_registry_and_scales_match_the_reference():
    assert PSc.SCENARIOS == RSc.SCENARIOS and PSc.SCALES == RSc.SCALES
    assert PSc.DEFAULT_REL_TOL == RSc.DEFAULT_REL_TOL
    with pytest.raises(KeyError, match="unknown scenario"):
        PSc.generate("not_a_scenario")
    for name in PSc.SCENARIOS:
        for scale in PSc.SCALES:
            mine, ref = PSc.generate(name, scale), RSc.generate(name, scale)
            assert mine.params == ref.params and mine.p2p == ref.p2p
            assert mine.site_nodes == ref.site_nodes
            assert sorted((e.time, e.kind) for e in mine.fault_plan.events) == sorted(
                (e.time, e.kind) for e in ref.fault_plan.events)
        assert PSc.generate(name, "bench").params["duration_s"] > PSc.generate(
            name, "smoke").params["duration_s"]


def test_baselines_are_the_references_read_in_place():
    for name in PSc.SCENARIOS:
        path = PSc.baseline_path(name)
        assert path == RSc.baseline_path(name).resolve()
        assert path.parent.parent == REFERENCE_SCENARIOS
        recorded = json.loads(path.read_text())
        assert PSc.load_baseline(name) == recorded == RSc.load_baseline(name)


def test_a_violated_envelope_raises():
    base = PSc.load_baseline("site_failure")
    bad = json.loads(json.dumps(base))
    bad["smoke"]["metrics"]["requeued"] += 1
    with pytest.raises(PSc.ScenarioViolation, match="requeued"):
        PSc.run_scenario("site_failure", baseline=bad, device=CPU)


def test_record_writes_only_where_it_is_told(tmp_path):
    before = {n: PSc.baseline_path(n).read_bytes() for n in PSc.SCENARIOS}
    out = tmp_path / "rec" / "x.json"
    data = PSc.record_baseline(out, "smoke", {"finished": 3, "makespan": 2.5})
    assert json.loads(out.read_text()) == data == {
        "smoke": {"metrics": {"finished": 3, "makespan": 2.5}, "rel_tol": 0.15}}
    assert cli.main(["record", "--out", str(tmp_path / "cli"), "--scale", "smoke",
                     "--device", CPU]) == 0
    for name in PSc.SCENARIOS:
        got = json.loads((tmp_path / "cli" / name / "baseline.json").read_text())
        assert got["smoke"] == PSc.load_baseline(name)["smoke"]
    assert {n: PSc.baseline_path(n).read_bytes() for n in PSc.SCENARIOS} == before


def test_cli_list_and_run(capsys):
    assert cli.main(["list"]) == 0
    assert capsys.readouterr().out.split() == list(PSc.SCENARIOS)
    assert cli.main(["run", "diurnal_flash", "--device", CPU]) == 0
    got = json.loads(capsys.readouterr().out)
    ref = RSc.run_scenario("diurnal_flash")[3]
    assert {k: v for k, v in got.items() if k != "wall_s"} == ref


def test_the_card_is_the_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PSc.run_scenario("diurnal_flash")
