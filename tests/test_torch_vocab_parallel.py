"""The tables used where they stand under a mesh: the vocab-parallel
embedding, logits and loss (``layers.vocab_embed``, ``lm.vocab_lse``,
``LM._chunk_ce`` on a rank's rows), the bytes each step receives
(``launch.mesh.received``) and the decode's table specs
(``decode.param_blocks``), on gloo ranks on the host
(``tests/_torch_vocab_ranks.py``, spawned by ``launch.mesh.run_ranks``,
one intra-op thread a rank) over ('data', 'model') meshes 1 × 2, 2 × 2
and 1 × 4. The step parities against the reference's sharded steps are
in ``tests/test_torch_sharded{,_train,_families,_moe,_ssm}.py``.

- The lookup equals ``F.embedding`` on the whole table bit for bit, in
  float32 and bfloat16, at every block's edges and ``padded_vocab − 1``;
  its block's gradient within 1e-6 of the whole table's, repeated tokens
  included.
- A loss chunk's (Σ nll, Σ lse², count) within 1e-6 (relative) of one
  process's, with and without soft-cap and z-loss, the labels −1,
  ``vocab_size``, a padded id and the blocks' edges among them; its
  gradients to the hidden states and the table within 1e-6 of the largest.
- On 2 × 2, reduced gemma2-9b, whatever collective moved the bytes: no
  call of a training step receives more than the rank's (V/m, d) rows of
  the table, no call of a prefill step as much (a table gathered over
  'model' would receive them), and no decode step as much in all.
- ``param_blocks`` cuts the tables as ``param_specs(..., serve=True)``.
- With serving's ZeRO forced (the width cut over 'data' too), the decode
  steps' and the prefill's logits within 1e-5 of one process's, and on
  2 × 2 against the reference's own ``build_serve_step`` and
  ``build_prefill_step`` under the mesh with its serving budget forced
  to 0 too (``tests/_jax_sharded_train_reference.py`` in a subprocess
  under eight forced host devices, beside the port's ranks): each rank's
  decode logits within 2e-4 and its prefill logits within 1e-4 of the
  largest logit, at the parity files' tolerances.
"""
from __future__ import annotations

import functools
import json

import numpy as np
import pytest

import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import LM, decode
from repro_torch.models.attention import _decode_bspec
from repro_torch.runtime import sharding

import _torch_sharded_train_ranks as sharded_ranks
import _torch_vocab_ranks as ranks
from _torch_sharded_ranks import _walk

ZERO3 = {"data": 2, "model": 2}
F32 = dict(param_dtype="float32", compute_dtype="float32")
# reduced gemma2-9b with serving's ZeRO forced on both sides: the tables cut ('model', 'data')
REFERENCE = {
    "zero3_prefill": dict(kind="prefill", arch="gemma2-9b", over=dict(F32, local_window=8), mesh=ZERO3, B=4, S=16,
                          seed=71, serve_zero3_budget=0),
    "zero3_serve": dict(kind="serve", arch="gemma2-9b", over=F32, mesh=ZERO3, B=4, max_len=64, steps=[0, 1, 2],
                        seed=72, serve_zero3_budget=0),
}
LOGITS_TOL = 1e-4                              # of the largest |logit| (tests/test_torch_sharded_train.py)
F32_TOL = 2e-4                                 # the reference's decode tolerance (tests/test_torch_sharded_ssm.py)
MESHES = {"1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4}}
CHUNKS = [f"chunk/{cap}/{z}" for cap in (0.0, 30.0) for z in (0.0, 1e-4)]
CASES = {"1x2": ["lookup/float32", "lookup/bfloat16", *CHUNKS, "specs"],
         "2x2": ["lookup/float32", "lookup/bfloat16", *CHUNKS, "specs", "traffic", "zero3"],
         "1x4": ["lookup/float32", "lookup/bfloat16", *CHUNKS, "specs"]}


@functools.cache
def _run(key: str) -> list:
    """Every case of mesh ``key`` on its ranks, run once."""
    return run_ranks(ranks.run, MESHES[key], backend="gloo", device_type="cpu", args=(CASES[key],), timeout=600)


def _each(key: str, case: str) -> list:
    return [(r["coords"], r[case]) for r in _run(key)]


def _cases(*names: str) -> list:
    return [(key, name) for key in MESHES for name in names if name in CASES[key]]


@pytest.mark.parametrize("key,case", _cases("lookup/float32", "lookup/bfloat16"))
def test_lookup_equals_the_whole_table(key, case):
    for coords, r in _each(key, case):
        ranks.assert_lookup(coords, r, case.split("/")[1])


@pytest.mark.parametrize("key,case", _cases(*CHUNKS))
def test_chunk_loss_and_gradients_equal_one_process(key, case):
    for coords, r in _each(key, case):
        ranks.assert_chunk(coords, r)


@pytest.mark.parametrize("key,case", _cases("traffic"))
def test_no_step_receives_a_whole_table(key, case):
    for coords, r in _each(key, case):
        assert r["train_spec"] == ("model", "data") and r["prefill_spec"] == r["decode_spec"] == ("model", None)
        rows = r["rows_bytes"]
        assert rows * 2 == r["table_bytes"]
        train = r["train"]
        assert 0 < train["largest"] <= rows, train        # the 'data' gather of the rank's rows, and its backward
        assert 0 < r["prefill"]["largest"] < rows, r["prefill"]      # its activations' sums may add up to more
        assert 0 < r["decode"]["largest"] <= r["decode"]["total"] < rows, r["decode"]


@pytest.mark.parametrize("key,case", _cases("specs"))
def test_param_blocks_cut_the_tables_as_serving_does(key, case):
    for coords, r in _each(key, case):
        for arch, specs in r.items():
            for name, (got, want) in specs.items():
                assert tuple(got) == tuple(want), (arch, name, got, want)
        assert tuple(r["gemma2-9b reduced"]["embed"][0]) == ("model", None)
        # published gemma2-9b: 2 · 9.24e9 / 'model' bytes over the 8 GiB budget at 'model' 2 (ZeRO over 'data')
        assert tuple(r["gemma2-9b"]["embed"][0]) == ("model", "data" if key == "2x2" else None)
        assert set(r["deepseek-v2-236b reduced"]) == {"embed", "unembed"}


@pytest.mark.parametrize("key,case", _cases("zero3"))
def test_serving_zero3_decode_and_prefill_equal_one_process(key, case):
    for coords, r in _each(key, case):
        ranks.assert_zero3(coords, r)


def _reference_inputs() -> dict:
    inp = {}
    for key, c in REFERENCE.items():
        cfg = get_config(c["arch"], reduced=True).replace(**c["over"])
        inp |= {f"{key}/params/{k}": v for k, v in sharded_ranks.reference_tree(cfg, c["seed"]).items()}
        rng = np.random.default_rng(c["seed"])
        if c["kind"] == "serve":
            for k, t in _walk(decode.init_cache(LM(cfg, device="meta"), c["B"], c["max_len"])):
                inp[f"{key}/cache/{k}"] = (rng.standard_normal(tuple(t.shape)) * 0.5).astype(np.float32)
            inp[f"{key}/tokens"] = rng.integers(0, cfg.vocab_size, (c["B"], len(c["steps"]))).astype(np.int32)
        else:
            b = sharded_ranks.batches(cfg, c["B"], c["S"], 1, c["seed"])[0]
            inp[f"{key}/tokens0"] = b["tokens"]
    return inp


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(the reference's outputs, the 2 × 2 ranks' results): the reference
    subprocess and the ranks run at the same time, one intra-op thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return sharded_ranks.run_with_reference(tmp_path_factory.mktemp("vocab_zero3"), REFERENCE,
                                                _reference_inputs(), {"2x2": ZERO3})
    finally:
        torch.set_num_threads(prev)


def _coords(r) -> dict:
    return dict(zip(ZERO3, (int(c) for c in r["coords"])))


@pytest.mark.parametrize("key", list(REFERENCE))
def test_serving_zero3_equals_the_reference(reference, key):
    """Each rank's logits rows with serving's ZeRO forced against the
    reference's own sharded step with its budget forced to 0 too: the
    decode steps within 2e-4, the prefill within 1e-4 of the largest
    logit; the tables cut ('model', 'data'), as the reference cuts them."""
    ref, port = reference
    c = REFERENCE[key]
    for r in port["2x2"]:
        coords = _coords(r)
        if c["kind"] == "serve":
            rows = (_decode_bspec(ZERO3, c["B"]), None, None)
            for pos in c["steps"]:
                want = sharded_ranks.cut(ref[f"serve/{key}/logits{pos}"], rows, ZERO3, coords)
                np.testing.assert_allclose(r[f"{key}/logits{pos}"], want, rtol=F32_TOL, atol=F32_TOL,
                                           err_msg=f"step {pos} at {coords}")
            spec = json.loads(str(r[f"{key}/param_specs"]))["embed"]
        else:
            want = ref[f"{key}/logits"]
            rows = (sharding.batch_specs(ZERO3, {"x": torch.empty(c["B"])})["x"][0], None, None)
            np.testing.assert_allclose(r[f"{key}/logits"], sharded_ranks.cut(want, rows, ZERO3, coords), rtol=0,
                                       atol=LOGITS_TOL * np.abs(want).max(), err_msg=str(coords))
            spec = json.loads(str(r[f"{key}/specs"]))["embed"]
        assert tuple(spec) == ("model", "data"), spec
    assert json.loads(str(ref[f"{key}/embed_spec"])) == ["model", "data"]
