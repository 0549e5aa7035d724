"""What each rank of ``tests/test_torch_vocab_parallel.py`` (and of its
card tests in ``tests/test_torch_cuda.py``) runs, spawned by
``launch.mesh.run_ranks``; it imports no JAX.

``run(mesh, cases)`` runs each named case on this rank and returns NumPy
arrays and flags under the case's name (``assert_lookup``,
``assert_chunk`` and ``assert_zero3`` hold them):

  ``lookup/<dtype>``  ``layers.vocab_embed`` on the rank's rows of a
                      seeded table against ``F.embedding`` on the whole
                      table, at every block's edges, ``padded_vocab − 1``
                      and repeated tokens; in float32 the gradients of the
                      rank's share (1/m of Σ x·g) against the whole table's
  ``chunk/<cap>/<z>`` ``LM._chunk_ce`` on the rank's rows of the table
                      (vocab-parallel) against the one process's on the
                      whole table, labels −1, ``vocab_size``, a padded id,
                      ``padded_vocab − 1`` and every block's edges; the
                      gradients to the hidden states (summed over 'model')
                      and to the table
  ``traffic``         reduced gemma2-9b's training, prefill and decode
                      steps: the bytes each received (``launch.mesh.received``:
                      in all, by kind, the most one call received)
  ``specs``           ``decode.param_blocks``' table specs beside
                      ``runtime.sharding.param_specs(..., serve=True)``'s
  ``zero3``           the decode and prefill steps with serving's ZeRO
                      forced (the width cut over 'data' too) against one
                      process
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.launch.mesh import all_reduce, received
from repro_torch.models import LM, decode
from repro_torch.models.layers import vocab_embed
from repro_torch.runtime import sharding
from repro_torch.runtime.pspec import logical_axis_rules
from repro_torch.runtime.serve import build_serve_step
from repro_torch.runtime.train import TrainConfig, build_prefill_step, build_train_step, init_opt_state, shard_batch

V, D = 512, 24                  # the lookup's table: padded_vocab, width
VOCAB = 500                     # the chunk's vocab_size: ids 500-511 are padding
CHUNK = dict(B=2, C=16)
TRAFFIC = dict(B=4, S=16, max_len=256, steps=(0, 1, 2))
TOL = 1e-6


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def _v0(mesh, n: int) -> int:
    return mesh.coords["model"] * n


def edge_tokens(m: int, n: int, V: int) -> list:
    """0, V − 1 and each block's first and last rows and the rows beside them."""
    out = {0, V - 1}
    for b in range(m):
        out |= {b * n, b * n + n - 1, max(b * n - 1, 0), min(b * n + n, V - 1)}
    return sorted(out)


def _lookup(mesh, dtype: str, dev) -> dict:
    m = mesh.get("model", 1)
    n = V // m
    gen = np.random.default_rng(1)
    whole = torch.from_numpy(gen.standard_normal((V, D), dtype=np.float32)).to(getattr(torch, dtype)).to(dev)
    edges = edge_tokens(m, n, V)
    rng = np.random.default_rng(10 + mesh.coords.get("data", 0))
    toks = np.array(edges + edges[:3] + list(rng.integers(0, V, 9 + len(edges) % 2))).reshape(2, -1)  # repeats
    tokens = torch.as_tensor(toks, device=dev)
    v0 = _v0(mesh, n)
    block = whole[v0:v0 + n].clone().requires_grad_(dtype == "float32")
    x = vocab_embed(tokens, block, v0, mesh)
    want = F.embedding(tokens, whole)
    out = {"equal": np.array(torch.equal(x, want)), "x": _np(x), "want": _np(want), "tokens": toks}
    if dtype == "float32":
        g = torch.from_numpy(np.random.default_rng(2).standard_normal(tuple(x.shape), dtype=np.float32)).to(dev)
        (torch.sum(x * g) / m).backward()                     # the rank's share: its rows are every 'model' rank's
        w = whole.clone().requires_grad_(True)
        torch.sum(F.embedding(tokens, w) * g).backward()
        out |= {"grad": _np(block.grad), "grad_want": _np(w.grad[v0:v0 + n])}
    return out


def chunk_lm(cap: float, dev) -> LM:
    """Reduced gemma2-9b, one layer, float32, vocab_size 500 (padded 512), a
    seeded final norm."""
    cfg = get_config("gemma2-9b", reduced=True).replace(
        num_layers=1, vocab_size=VOCAB, final_logit_softcap=cap, param_dtype="float32", compute_dtype="float32")
    lm = LM(cfg, device=dev)
    with torch.no_grad():
        lm.final_norm.copy_(torch.from_numpy(np.random.default_rng(3).uniform(-0.5, 0.5, cfg.d_model)
                                             .astype(np.float32)))
    return lm


def chunk_labels(m: int, n: int, cfg, rng) -> np.ndarray:
    """−1, vocab_size, a padded id, padded_vocab − 1, every block's edges,
    then seeded ids, (B, C)."""
    V = cfg.padded_vocab
    special = [-1, cfg.vocab_size, cfg.vocab_size + 5, V - 1]
    edges = sorted({e for b in range(m) for e in (b * n, b * n + n - 1)})
    fill = CHUNK["B"] * CHUNK["C"] - len(special) - len(edges)
    return np.array(special + edges + list(rng.integers(0, cfg.vocab_size, fill))).reshape(CHUNK["B"], CHUNK["C"])


def _chunk(mesh, cap: float, z: float, dev) -> dict:
    lm = chunk_lm(cap, dev)
    cfg = lm.cfg
    m = mesh.get("model", 1)
    n = cfg.padded_vocab // m
    v0 = _v0(mesh, n)
    rng = np.random.default_rng(20 + mesh.coords.get("data", 0))
    whole = torch.from_numpy(np.random.default_rng(4).standard_normal((cfg.padded_vocab, cfg.d_model),
                                                                      dtype=np.float32) * 0.3).to(dev)
    x0 = torch.from_numpy(rng.standard_normal((CHUNK["B"], CHUNK["C"], cfg.d_model), dtype=np.float32)).to(dev)
    labels = torch.as_tensor(chunk_labels(m, n, cfg, rng), device=dev)

    def run(table, *vocab):
        x = x0.clone().requires_grad_(True)
        nll, zsq, cnt = lm._chunk_ce(x, labels, table, *vocab)
        share = (nll + z * zsq) / cnt / (m if vocab else 1)
        share.backward()
        return [float(nll.detach()), float(zsq.detach()), int(cnt)], x.grad

    w = whole.clone().requires_grad_(True)
    want, gx_want = run(w)
    block = whole[v0:v0 + n].clone().requires_grad_(True)
    got, gx = run(block, v0, mesh)
    return {"got": np.array(got, dtype=np.float64), "want": np.array(want, dtype=np.float64), "labels": _np(labels),
            "grad_x": _np(all_reduce(gx, "model", mesh)), "grad_x_want": _np(gx_want),
            "grad_table": _np(block.grad), "grad_table_want": _np(w.grad[v0:v0 + n])}


def gemma_reduced(dev, dtype: str = "bfloat16") -> LM:
    cfg = get_config("gemma2-9b", reduced=True).replace(param_dtype=dtype, compute_dtype=dtype)
    return LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))


def _batch(cfg, B: int, S: int) -> dict:
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _traffic(mesh, dev) -> dict:
    """Each step's bytes received: in all, by kind, and the most one call received."""
    out = {}
    B, S = TRAFFIC["B"], TRAFFIC["S"]
    lm = gemma_reduced(dev)
    batch = _batch(lm.cfg, B, S)
    step, (psh, _) = build_train_step(lm, TrainConfig(), mesh=mesh)
    opt = init_opt_state(lm)
    b = shard_batch(batch, mesh)
    received.zero()
    step(opt, b)
    out["train"] = received.read()
    out["train_spec"] = psh["embed"]
    lm = gemma_reduced(dev)
    prefill, psh = build_prefill_step(lm, mesh=mesh)
    b = shard_batch({"tokens": batch["tokens"]}, mesh)
    received.zero()
    prefill(b)
    out["prefill"] = received.read()
    out["prefill_spec"] = psh["embed"]
    lm = gemma_reduced(dev)
    serve, (psh, _, tsh, _), _ = build_serve_step(lm, B, TRAFFIC["max_len"], mesh=mesh)
    with logical_axis_rules(mesh):
        cache = decode.init_cache(lm, B, TRAFFIC["max_len"])
    tok = sharding.local_block(torch.as_tensor(batch["tokens"][:, :1], device=dev), tsh, mesh)
    received.zero()
    serve(tok, cache, 0)
    out["decode"] = received.read()
    out["decode_spec"] = psh["embed"]
    out["rows_bytes"] = (lm.cfg.padded_vocab // mesh["model"]) * lm.cfg.d_model * lm.embed.element_size()
    out["table_bytes"] = lm.embed.numel() * lm.embed.element_size()
    return out


def _specs(mesh, dev) -> dict:
    """(param_blocks' table specs, param_specs(serve=True)'s) for reduced
    gemma2-9b (tied), reduced deepseek-v2-236b (untied) and published
    gemma2-9b (9.24 B parameters: serving's ZeRO where 'model' ≤ 2), on meta."""
    out = {}
    for arch, reduced in (("gemma2-9b", True), ("deepseek-v2-236b", True), ("gemma2-9b", False)):
        lm = LM(get_config(arch, reduced=reduced), device="meta")
        with logical_axis_rules(mesh):
            got = decode.param_blocks(lm)
        want = sharding.param_specs(mesh, lm, serve=True)
        key = f"{arch}{' reduced' if reduced else ''}"
        out[key] = {n: (got[n], want[n]) for n in ("embed", "unembed") if n in want}
    return out


def _zero3(mesh, dev) -> dict:
    """Serving's ZeRO forced (a budget of 0 bytes): the decode steps'
    logits rows and the prefill's against one process, float32."""
    B, max_len, steps = TRAFFIC["B"], TRAFFIC["max_len"], TRAFFIC["steps"]
    held = sharding._SERVE_ZERO3_BUDGET
    sharding._SERVE_ZERO3_BUDGET = 0
    try:
        lm = gemma_reduced(dev, "float32")
        toks = _batch(lm.cfg, B, len(steps))["tokens"]
        one = []
        cache = decode.init_cache(lm, B, max_len)
        for t in steps:
            logits, cache = decode.decode_step(lm, torch.as_tensor(toks[:, t:t + 1], device=dev), cache, t)
            one.append(logits)
        want_prefill = build_prefill_step(lm)({"tokens": toks})
        serve, (psh, _, tsh, _), _ = build_serve_step(lm, B, max_len, mesh=mesh)
        with logical_axis_rules(mesh):
            cache = decode.init_cache(lm, B, max_len)
        got, received_bytes = [], []
        for t in steps:
            received.zero()
            logits, cache = serve(sharding.local_block(torch.as_tensor(toks[:, t:t + 1], device=dev), tsh, mesh),
                                  cache, t)
            received_bytes.append(received.read())
            got.append(logits)
        rows = (tsh[0], None, None)
        out = {"spec": psh["embed"], "received": received_bytes,
               "rows_bytes": (lm.cfg.padded_vocab // mesh["model"]) * lm.cfg.d_model * lm.embed.element_size(),
               "got": np.stack([_np(x) for x in got]),
               "want": np.stack([_np(sharding.local_block(x, rows, mesh)) for x in one])}
        lm = gemma_reduced(dev, "float32")
        prefill, pre_sh = build_prefill_step(lm, mesh=mesh)
        out["prefill_spec"] = pre_sh["embed"]
        out["prefill"] = _np(prefill(shard_batch({"tokens": toks}, mesh)))
        out["prefill_want"] = _np(sharding.local_block(want_prefill, rows, mesh))
        return out
    finally:
        sharding._SERVE_ZERO3_BUDGET = held


def assert_lookup(coords, r: dict, dtype: str) -> None:
    """A rank's lookup equal to ``F.embedding`` on the whole table bit for
    bit; in float32 its block's gradient within 1e-6 of the largest."""
    assert bool(r["equal"]), (coords, np.abs(r["x"] - r["want"]).max())
    if dtype == "float32":
        np.testing.assert_allclose(r["grad"], r["grad_want"], rtol=0, atol=TOL * np.abs(r["grad_want"]).max(),
                                   err_msg=str(coords))


def assert_chunk(coords, r: dict) -> None:
    """A rank's chunk (Σ nll, Σ lse², count) within 1e-6 relative of one
    process's, the count that of the labels in [0, vocab_size), and its
    gradients within 1e-6 of the largest."""
    np.testing.assert_allclose(r["got"], r["want"], rtol=TOL, atol=0, err_msg=str(coords))
    labels = r["labels"]
    assert r["got"][2] == np.sum((labels >= 0) & (labels < VOCAB)) < labels.size - 3
    for g in ("grad_x", "grad_table"):
        want = r[f"{g}_want"]
        np.testing.assert_allclose(r[g], want, rtol=0, atol=TOL * np.abs(want).max(), err_msg=f"{g} {coords}")


def assert_zero3(coords, r: dict) -> None:
    """A rank's decode steps' and prefill's logits rows with serving's ZeRO
    forced within 1e-5 of one process's largest logit, the tables cut over
    ('model', 'data'), and no decode step receiving as many bytes as the
    rank's (V/m, d) rows of the table."""
    assert tuple(r["spec"]) == tuple(r["prefill_spec"]) == ("model", "data")
    np.testing.assert_allclose(r["got"], r["want"], rtol=0, atol=1e-5 * np.abs(r["want"]).max(), err_msg=str(coords))
    np.testing.assert_allclose(r["prefill"], r["prefill_want"], rtol=0, atol=1e-5 * np.abs(r["prefill_want"]).max(),
                               err_msg=str(coords))
    assert all(0 < step["total"] < r["rows_bytes"] for step in r["received"]), r["received"]


RUN = {"lookup": lambda mesh, dev, dtype: _lookup(mesh, dtype, dev),
       "chunk": lambda mesh, dev, cap, z: _chunk(mesh, float(cap), float(z), dev),
       "traffic": lambda mesh, dev: _traffic(mesh, dev),
       "specs": lambda mesh, dev: _specs(mesh, dev),
       "zero3": lambda mesh, dev: _zero3(mesh, dev)}


def run(mesh, cases: list) -> dict:
    """Each case ``name/arg/…`` of ``cases`` on this rank, on its device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"coords": dict(mesh.coords), "device": str(mesh.device)}
    for case in cases:
        name, *args = case.split("/")
        out[case] = RUN[name](mesh, mesh.device, *args)
    return out
