"""The port's side of ``tests/test_torch_sharded_train.py`` and
``tests/test_torch_sharded_families.py``: what each rank of an 8-rank gloo
mesh runs (spawned by ``launch.mesh.run_ranks``, so it
lives in a module the ranks import; it imports no JAX).

``run(mesh, workdir)`` reads the cases (``cases.json``) and the inputs
(``inputs.npz``) the test wrote, and for each case of this mesh's shape
builds the model from the reference's parameter tree
(``params_from_reference``), runs the sharded step on this rank's blocks
and rows, and returns NumPy arrays: each step's metrics, the rank's
parameter blocks (and adamw8 codes and scales) after the last step and
on the first rank the whole parameters gathered from them, the
prefill's logits rows, and the sharded layers each step ran (and
``rglru_sharded`` against ``rglru_forward``, ``mamba_sharded`` against
``mamba_forward`` where the width does not divide 'model'); a case's
``moe_impl`` is set while it runs, its ``serve_zero3_budget`` stands in
for ``runtime.sharding``'s serving budget (0: serving's ZeRO forced), and
a ``serve`` case runs
``_torch_sharded_ranks.serve`` (``build_serve_step`` under the mesh).
``cli`` runs the training CLI on a rank and returns its parameter blocks,
and
``card_step`` a rank of the card test's sharded step
(``tests/test_torch_cuda.py``). The helpers ``reference_tree``,
``batches``, ``TCFG`` and ``assert_within_change`` are shared with the
tests.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import LM, attention, mla, moe, params_from_reference, rglru, ssm
from repro_torch.models.interop import STACKED
from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import gather_blocks, local_block
from repro_torch.runtime.train import TrainConfig, build_prefill_step, build_train_step, init_opt_state, shard_batch

# 1e-3 at its peak, reached after one warmup step (step 0's learning rate is 0)
TCFG = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)

# A parameter against another step's (the reference's, the port's one
# process), in units of its leaf's largest change over the 3 steps, in two parts: the worst element within
# PARAM_TOL, and at most PARAM_SHARE of each block's elements beyond
# PARAM_TIGHT. AdamW's m/√v turns a gradient's last-place difference
# (another order of summation: the mesh's reductions) into an O(1)
# difference of the update where |g| is near that difference, on a few
# elements: measured, the worst 2.2e-3 of the change and at most 1 element
# of a block of 8,192 beyond 1e-3 (nemotron); adamw8 adds its codes (a
# moment at a rounding boundary takes the next code): the worst 3.9e-2,
# at most 2 elements of 8,192 beyond 1e-2. A fault that moves whole blocks
# moves most of their elements: weight decay skipped on the cut blocks
# puts 10-93% of every cut matrix's elements beyond those limits.
PARAM_TOL = {"adamw": 1e-2, "adamw8": 1e-1}
PARAM_TIGHT = {"adamw": 1e-3, "adamw8": 1e-2}
PARAM_SHARE = 1e-3


def assert_within_change(got: np.ndarray, want: np.ndarray, change: float, optimizer: str, what: str) -> None:
    """A parameter block against another in units of its leaf's largest
    change: every element within PARAM_TOL, at most PARAM_SHARE of them
    beyond PARAM_TIGHT."""
    d = np.abs(got - want) / change
    worst, share = float(d.max()), float((d > PARAM_TIGHT[optimizer]).mean())
    assert worst <= PARAM_TOL[optimizer] and share <= PARAM_SHARE, (
        f"{what}: {worst!r} of the change (limit {PARAM_TOL[optimizer]}), {share!r} of the elements beyond "
        f"{PARAM_TIGHT[optimizer]} (limit {PARAM_SHARE})")


def config(case: dict):
    return get_config(case["arch"], reduced=True).replace(**case["over"])


def tcfg_of(case: dict) -> TrainConfig:
    tc = case["tcfg"]
    return TrainConfig(peak_lr=tc["peak_lr"], warmup_steps=tc["warmup_steps"], total_steps=tc["total_steps"],
                       microbatches=tc["microbatches"], optimizer=tc["optimizer"])


def reference_tree(cfg, seed: int) -> dict:
    """The reference's parameter tree (flat '/' keys, NumPy leaves, a
    family's layers stacked) of a model the port initialises from ``seed``;
    its zero-initialised norm scales drawn N(0, 0.1) so that they count."""
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    groups: dict = {}
    for name, p in lm.named_parameters():
        a = p.detach().float().numpy().copy()
        if a.ndim <= 1 and not a.any():
            a = np.asarray(rng.standard_normal(a.shape) * 0.1, dtype=np.float32)
        parts = name.split(".")
        n = STACKED.get(parts[0], 0)
        key = "/".join([parts[0], *parts[1 + n:]])
        groups.setdefault(key, {})[tuple(int(i) for i in parts[1:1 + n])] = a
    out = {}
    for key, by_index in groups.items():
        idx = sorted(by_index)
        stack = tuple(max(i[d] for i in idx) + 1 for d in range(len(idx[0])))
        out[key] = np.stack([by_index[i] for i in idx]).reshape(stack + by_index[idx[0]].shape)
    return out


def batches(cfg, B: int, S: int, steps: int, seed: int) -> list[dict]:
    """``steps`` global batches: tokens, and labels masked unevenly by row
    (row r loses about r/(2B) of its labels, to −1 or past the vocabulary),
    so that a microbatch's count of unmasked labels depends on its rows;
    for the vlm family image embeddings (B, num_image_tokens, d), for
    encdec audio embeddings (B, encoder_seq_len, d), N(0, 1) float32."""
    rng = np.random.default_rng(seed)
    embeds = {"vlm": ("image_embeds", cfg.num_image_tokens), "encdec": ("audio_embeds", cfg.encoder_seq_len)}
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        drop = rng.random((B, S)) < (np.arange(B)[:, None] / (2.0 * B))
        labels[drop] = np.where(rng.random(int(drop.sum())) < 0.5, -1, cfg.vocab_size + 3)
        b = {"tokens": toks, "labels": labels}
        if cfg.family in embeds:
            name, n = embeds[cfg.family]
            b[name] = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def run_with_reference(work: Path, cases: dict, inp: dict, meshes: dict, timeout: float = 300) -> tuple:
    """Write ``cases`` and ``inp`` under ``work``, start the reference's
    script (``tests/_jax_sharded_train_reference.py``) on them in a
    subprocess under eight forced host devices and, at the same time, the
    port's ranks on each mesh of ``meshes`` (name → shape) in turn: (the
    reference's outputs, name → each rank's results)."""
    import os
    import subprocess
    import sys

    from repro_torch.launch.mesh import run_ranks

    repo = Path(__file__).resolve().parents[1]
    (work / "cases.json").write_text(json.dumps(cases))
    np.savez(work / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(repo / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref_proc = subprocess.Popen([sys.executable, str(repo / "tests" / "_jax_sharded_train_reference.py"), str(work)],
                                env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = {name: run_ranks(run, mesh, backend="gloo", device_type="cpu", args=(str(work),), timeout=timeout)
                for name, mesh in meshes.items()}
    finally:
        out, err = ref_proc.communicate(timeout=2 * timeout)
    assert ref_proc.returncode == 0 and "OK" in out, out + "\n" + err
    return dict(np.load(work / "reference.npz")), port


def cut(a: np.ndarray, spec, mesh: dict, coords: dict) -> np.ndarray:
    """The block of ``a`` the rank at ``coords`` holds under ``spec`` (as
    JSON gives it back: lists for tuples)."""
    spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
    return local_block(torch.from_numpy(np.array(a, order="C")), spec, mesh, coords).numpy()   # 0-d stays 0-d


def tree_of(inp, prefix: str) -> dict:
    """A flat '/'-keyed part of ``inp`` as a nested dict."""
    tree: dict = {}
    for k in inp:
        if not k.startswith(prefix):
            continue
        *path, last = k[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = inp[k]
    return tree


def model(cfg, inp, key: str) -> LM:
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, tree_of(inp, f"{key}/params/")))
    return lm


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy().copy()


BATCH_KEYS = ("tokens", "labels", "image_embeds", "audio_embeds")


def batch_of(inp, key: str, s: int) -> dict:
    """Step ``s``'s global batch of case ``key``: every key it has."""
    return {n: inp[f"{key}/{n}{s}"] for n in BATCH_KEYS if f"{key}/{n}{s}" in inp}


# the sharded layers' counters, in the order ``layer_calls`` reads them
LAYERS = ((attention, "attention_sharded"), (attention, "mlp_sharded"), (rglru, "rglru_sharded"),
          (mla, "mla_sharded"), (ssm, "mamba_sharded"), (moe, "moe_gather_sharded"), (moe, "moe_a2a_sharded"))


def layer_calls() -> np.ndarray:
    """Each sharded layer function's calls so far, this process (``LAYERS``)."""
    return np.asarray([getattr(mod, name).calls for mod, name in LAYERS])


def _train(mesh, key, case, inp, out):
    cfg, tcfg = config(case), tcfg_of(case)
    lm = model(cfg, inp, key)
    step, (psh, osh) = build_train_step(lm, tcfg, mesh=mesh)
    opt = init_opt_state(lm, tcfg.optimizer)
    metrics, calls = [], []
    for s in range(case["steps"]):
        before = layer_calls()
        m = step(opt, shard_batch(batch_of(inp, key, s), mesh))
        calls.append(layer_calls() - before)
        metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
    calls = np.asarray(calls)
    out[f"{key}/metrics"] = np.asarray(metrics, np.float64)
    out[f"{key}/calls"] = calls[:, :2]
    out[f"{key}/rglru_calls"] = calls[:, 2]
    out[f"{key}/layer_calls"] = calls
    for name, p in lm.named_parameters():
        out[f"{key}/params/{name}"] = _np(p)
    whole = gather_blocks(dict(lm.named_parameters()), psh, mesh, keep=not any(mesh.coords.values()))
    out[f"{key}/kept"] = np.asarray(whole is not None)
    for name, t in (whole or {}).items():
        out[f"{key}/whole/{name}"] = _np(t)
    if tcfg.optimizer == "adamw8":
        for mom in ("m", "v"):
            for name, st in opt[mom].items():
                for part in ("q", "scale"):
                    out[f"{key}/opt/{mom}/{name}/{part}"] = _np(st[part])
    out[f"{key}/specs"] = np.asarray(json.dumps({"params": psh, "opt": {m: osh[m] for m in ("m", "v")}}))


def _prefill(mesh, key, case, inp, out):
    cfg = config(case)
    step, psh = build_prefill_step(model(cfg, inp, key), mesh=mesh)
    before = layer_calls()
    out[f"{key}/logits"] = _np(step(shard_batch(batch_of(inp, key, 0), mesh)))
    calls = layer_calls() - before
    out[f"{key}/calls"] = np.asarray(calls[0])
    out[f"{key}/rglru_calls"] = np.asarray(calls[2])
    out[f"{key}/layer_calls"] = calls
    out[f"{key}/specs"] = np.asarray(json.dumps(psh))


def _refusals(mesh, key, case, inp, out):
    """What the sharded steps refuse, as messages (empty where the step
    builds): each listed family's train and prefill steps, and the
    compressed step (compress_pod_grads) across a pod axis."""
    msgs = []
    for arch in case["archs"]:
        for build in (lambda lm: build_train_step(lm, TrainConfig(), mesh=mesh),
                      lambda lm: build_prefill_step(lm, mesh=mesh)):
            msgs.append(_message(lambda: build(LM(get_config(arch, reduced=True), device="cpu"))))
    if mesh.get("pod", 1) > 1:
        cfg = get_config("gemma2-9b", reduced=True)
        msgs.append(_message(lambda: build_train_step(LM(cfg, device="cpu"), TrainConfig(compress_pod_grads=True),
                                                      mesh=mesh)))
    out[f"{key}/messages"] = np.asarray(msgs)


def _rglru_whole(mesh, key, case, inp, out):
    """``rglru_sharded`` on this rank's rows and blocks of a width that does
    not divide 'model', and ``rglru_forward`` of the whole block on the same
    rows: both outputs."""
    from repro_torch.runtime.sharding import param_specs

    cfg = config(case)
    p = {k: torch.from_numpy(np.ascontiguousarray(inp[f"{key}/mix/{k}"])) for k in rglru.init_rglru(cfg, "meta")}
    specs = param_specs(mesh, p, zero3=True)
    x = shard_batch({"x": inp[f"{key}/x"]}, mesh)["x"]
    before = rglru.rglru_sharded.calls
    got = rglru.rglru_sharded({k: local_block(t, specs[k], mesh) for k, t in p.items()}, x, cfg, mesh, specs)
    out[f"{key}/got"] = _np(got)
    out[f"{key}/want"] = _np(rglru.rglru_forward(p, x, cfg))
    out[f"{key}/calls"] = np.asarray(rglru.rglru_sharded.calls - before)
    out[f"{key}/specs"] = np.asarray(json.dumps(specs))


def _mamba_whole(mesh, key, case, inp, out):
    """``mamba_sharded`` on this rank's rows and blocks of a head count that
    does not divide 'model', and ``mamba_forward`` of the whole block on
    the same rows: both outputs."""
    from repro_torch.runtime.sharding import param_specs

    cfg = config(case)
    p = {k: torch.from_numpy(np.ascontiguousarray(inp[f"{key}/mix/{k}"])) for k in ssm.init_mamba(cfg, "meta")}
    specs = param_specs(mesh, p, zero3=True)
    x = shard_batch({"x": inp[f"{key}/x"]}, mesh)["x"]
    before = ssm.mamba_sharded.calls
    got = ssm.mamba_sharded({k: local_block(t, specs[k], mesh) for k, t in p.items()}, x, cfg, mesh, specs)
    out[f"{key}/got"] = _np(got)
    out[f"{key}/want"] = _np(ssm.mamba_forward(p, x, cfg))
    out[f"{key}/calls"] = np.asarray(ssm.mamba_sharded.calls - before)
    out[f"{key}/specs"] = np.asarray(json.dumps(specs))


def _serve(mesh, key, case, inp, out):
    from _torch_sharded_ranks import serve

    serve(mesh, key, case, inp, out)


def _message(fn) -> str:
    try:
        fn()
        return ""
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"


RUN = {"train": _train, "prefill": _prefill, "refusals": _refusals, "rglru_whole": _rglru_whole,
       "mamba_whole": _mamba_whole, "serve": _serve}


def run(mesh, workdir: str) -> dict:
    workdir = Path(workdir)
    cases = json.loads((workdir / "cases.json").read_text())
    inp = np.load(workdir / "inputs.npz")
    out = {"coords": np.array([mesh.coords[a] for a in mesh])}
    for key, case in cases.items():
        if case["mesh"] == dict(mesh):
            moe.set_moe_impl(case.get("moe_impl", "gather"))
            dropped = moe.moe_gather_sharded.dropped
            budget = sharding._SERVE_ZERO3_BUDGET
            sharding._SERVE_ZERO3_BUDGET = case.get("serve_zero3_budget", budget)
            try:
                RUN[case["kind"]](mesh, key, case, inp, out)
            finally:
                moe.set_moe_impl("gather")
                sharding._SERVE_ZERO3_BUDGET = budget
            out[f"{key}/dropped"] = np.asarray(moe.moe_gather_sharded.dropped - dropped)
    return out


def cli(mesh, argv: list) -> dict:
    """The training CLI on this rank (the process group is up): its
    parameter blocks after the run, and its mesh."""
    from repro_torch.launch import train

    lm, opt = train.main(argv)
    out = {name: _np(p) for name, p in lm.named_parameters()}
    out["step"] = np.asarray(int(opt["step"]))
    out["mesh"] = np.asarray(json.dumps(dict(lm.placement.mesh)))
    return out


# the card tests' reduced models: float32, remat, windows cut to 8, the vlm
# with a cross layer every 4 of 8 layers and 2 kv heads
CARD_CFG = {"gemma2-9b": dict(num_layers=4, local_window=8),
            "recurrentgemma-2b": dict(local_window=8),
            "llama-3.2-vision-11b": dict(num_layers=8, cross_attn_every=4, num_kv_heads=2),
            "whisper-base": {}}
CARD_GATE = 0.5       # the cross layers' tanh gates (the reference initialises 0: no gradient reaches them)


def sharded_layers(cfg) -> tuple[int, int, int]:
    """(attention blocks, MLPs, RG-LRU blocks) of one forward of ``cfg``'s
    model: self and cross attention, whisper's encoder too."""
    if cfg.family == "hybrid":
        n_p, rem = divmod(cfg.num_layers, 3)
        return n_p, cfg.num_layers, 2 * n_p + rem
    if cfg.family == "encdec":
        n = cfg.num_encoder_layers + 2 * cfg.num_layers
        return n, n, 0
    return cfg.num_layers, cfg.num_layers, 0


def card_step(mesh, arch: str = "gemma2-9b") -> dict:
    """3 train steps of ``arch`` reduced (``CARD_CFG``) built on the card
    from a seed, on one process (``mesh`` None: the whole parameters before
    and after) or on this rank of ``mesh`` (its blocks): metrics,
    parameters, the flash forward and backward launches."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(arch, reduced=True).replace(remat=True, param_dtype="float32", compute_dtype="float32",
                                                 **CARD_CFG[arch])
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        for blocks in (getattr(lm, "cross_blocks", ()), getattr(lm, "dec_cross", ())):
            for b in blocks:
                b.xgate.fill_(CARD_GATE)
    out = {"before": {k: _np(p) for k, p in lm.named_parameters()}} if mesh is None else {}
    tcfg = TrainConfig(**TCFG)
    if mesh is None:
        step = build_train_step(lm, tcfg)
    else:
        step, (psh, _) = build_train_step(lm, tcfg, mesh=mesh)
        out |= {"coords": np.array([mesh.coords[a] for a in mesh]), "specs": np.asarray(json.dumps(psh))}
    opt = init_opt_state(lm)
    before = fa_ops.flash_attention.launches, fa_ops.flash_attention_bwd.launches
    metrics = []
    for b in batches(cfg, 4, 48, 3, seed=7):
        m = step(opt, b if mesh is None else shard_batch(b, mesh))
        metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
    torch.cuda.synchronize()
    out |= {"metrics": np.asarray(metrics), "params": {k: _np(p) for k, p in lm.named_parameters()},
            "launches": np.asarray([fa_ops.flash_attention.launches - before[0],
                                    fa_ops.flash_attention_bwd.launches - before[1]])}
    return out


# card_layer's layers: (architecture, the layer's config overrides)
CARD_LAYERS = {"rglru": ("recurrentgemma-2b", {}), "cross": ("llama-3.2-vision-11b", {}),
               "mla": ("deepseek-v2-236b", {}), "mamba": ("mamba2-780m", {}),
               "moe_gather": ("deepseek-v2-236b", dict(num_experts=16))}


def _card_params(kind: str, cfg, dev, gen) -> dict:
    """The layer's whole parameters, flat (a moe layer's under 'moe.',
    the shared experts under 'moe.shared.', as ``param_specs`` reads them)."""
    from repro_torch.models.attention import init_attention, init_attention_

    if kind == "rglru":
        p = rglru.init_rglru(cfg, dev)
        rglru.init_rglru_(p, cfg, gen)
        p["conv_b"].normal_(generator=gen).mul_(0.1)
    elif kind == "cross":
        p = init_attention(cfg, dev)
        init_attention_(p, cfg, gen)
    elif kind == "mla":
        p = mla.init_mla(cfg, dev)
        mla.init_mla_(p, cfg, gen)
        for n in ("q_norm", "kv_norm"):
            p[n].normal_(generator=gen).mul_(0.1)
    elif kind == "mamba":
        p = ssm.init_mamba(cfg, dev)
        ssm.init_mamba_(p, cfg, gen)
        for n in ("norm", "conv_b", "dt_bias"):
            p[n].normal_(generator=gen).mul_(0.1)
    else:
        m = moe.MoEParams(cfg, dev)
        moe.init_moe_(m, cfg, gen)
        return {f"moe.{k}": t for k, t in m.named_parameters()}
    return dict(p.items())


def _nest(flat: dict) -> dict:
    """A moe layer's flat 'moe.'-prefixed leaves as the nested mapping its
    functions index ('shared' a dict); other layers' as they are."""
    out: dict = {}
    for k, t in flat.items():
        parts = k.split(".")[1:] if k.startswith("moe.") else [k]
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    return out


def card_layer(mesh, kind: str) -> dict:
    """One layer at a published width in float32 on the card, from a seed,
    on a B 2 × S 256 batch (512 for ``mamba``, two of its 256 chunks):
    ``rglru`` recurrentgemma-2b's RG-LRU block (2,560 channels), ``cross``
    llama-3.2-vision-11b's cross attention over 1,601 image tokens (32
    heads, 8 kv heads, D 128, non-causal), ``mla`` deepseek-v2-236b's MLA
    (128 heads, the (192, 128) instance, causal), ``mamba`` mamba2-780m's
    SSD block (48 heads), ``moe_gather`` deepseek-v2-236b's moe layer with
    16 of its experts on tokens that share a part (the gather dispatch,
    capacity factor 1.25, some experts overflowing). On one
    process (``mesh`` None) the output and every parameter's gradient of
    Σ y·g (+ aux) (g a seeded cotangent); on a rank of ``mesh`` its rows'
    output, its blocks' gradients of its share Σ y·g / m (+ aux / world)
    summed over the axes the block is replicated on, and the flash
    launches by instance; the (token, choice) pairs the dispatch dropped."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import all_reduce
    from repro_torch.models.attention import attention, attention_sharded
    from repro_torch.runtime.sharding import param_specs, spec_axes

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(5)
    arch, over = CARD_LAYERS[kind]
    cfg = get_config(arch).replace(param_dtype="float32", compute_dtype="float32", **over)
    p = _card_params(kind, cfg, dev, gen)
    B, S = 2, 512 if kind == "mamba" else 256
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    kv = torch.randn((B, cfg.num_image_tokens, cfg.d_model), generator=gen, device=dev)
    g = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    if kind == "moe_gather":        # a part every token shares: the router favours some experts, which overflow
        x = x + torch.randn((1, 1, cfg.d_model), generator=gen, device=dev)
    whole = {k: t.detach() for k, t in p.items()}
    dropped0 = moe.moe_gather_sharded.dropped
    if mesh is None:
        leaves = {k: t.clone().requires_grad_() for k, t in whole.items()}
        aux = 0.0
        if kind == "rglru":
            y = rglru.rglru_forward(leaves, x, cfg)
        elif kind == "cross":
            y = attention(leaves, x, cfg, causal=False, kv_x=kv)
        elif kind == "mla":
            y = mla.mla_attention(leaves, x, cfg)
        elif kind == "mamba":
            y = ssm.mamba_forward(leaves, x, cfg)
        else:
            y, aux = moe._moe_gather(_nest(leaves), x, cfg)
        dropped = 0
        if kind == "moe_gather":
            with torch.no_grad():
                _, idx, _ = moe._route(_nest(leaves), x.reshape(B * S, -1), cfg)
                C = max(8, int(B * S * cfg.top_k * cfg.capacity_factor / cfg.num_experts))
                dropped = int((moe._positions_in_expert(idx, cfg.num_experts) >= C).sum())
        ((y * g).sum() + aux).backward()
        return {"y": _np(y), "grads": {k: _np(t.grad) for k, t in leaves.items()}, "dropped": np.asarray(dropped)}
    specs = param_specs(mesh, whole, zero3=True)
    leaves = {k: local_block(t, specs[k], mesh).clone().requires_grad_() for k, t in whole.items()}
    rows = {k: shard_batch({k: t}, mesh)[k] for k, t in (("x", x), ("kv", kv), ("g", g))}
    fa_ops.flash_attention.by_pair, fa_ops.flash_attention_bwd.by_pair = {}, {}
    sub = {k.split(".", 1)[1] if k.startswith("moe.") else k: s for k, s in specs.items()}
    aux = 0.0
    if kind == "rglru":
        y = rglru.rglru_sharded(leaves, rows["x"], cfg, mesh, specs)
    elif kind == "cross":
        y = attention_sharded(leaves, rows["x"], cfg, mesh, specs, causal=False, kv_x=rows["kv"])
    elif kind == "mla":
        y = mla.mla_sharded(leaves, rows["x"], cfg, mesh, specs)
    elif kind == "mamba":
        y = ssm.mamba_sharded(leaves, rows["x"], cfg, mesh, specs)
    else:
        y, aux = moe.moe_sharded(_nest(leaves), rows["x"], cfg, mesh, sub)
        aux = aux / int(np.prod(list(mesh.values())))
    ((y * rows["g"]).sum().div(mesh["model"]) + aux).backward()
    grads = {}
    for k, t in leaves.items():
        gk = t.grad
        for ax in (a for a in mesh if a not in {a for e in specs[k] for a in spec_axes(e)}):
            gk = all_reduce(gk, ax, mesh)
        grads[k] = _np(gk)
    torch.cuda.synchronize()
    return {"coords": np.array([mesh.coords[a] for a in mesh]), "specs": np.asarray(json.dumps(specs)),
            "y": _np(y), "grads": grads, "dropped": np.asarray(moe.moe_gather_sharded.dropped - dropped0),
            "pairs": np.asarray(json.dumps({f"{d}x{dv}": n for (d, dv), n in fa_ops.flash_attention.by_pair.items()})),
            "bwd_pairs": np.asarray(json.dumps({f"{d}x{dv}": n
                                                for (d, dv), n in fa_ops.flash_attention_bwd.by_pair.items()}))}
