"""Training in the port (``LM.loss``, ``runtime.train``, ``launch.train``)
against the reference, on the CPU.

The same weights (the reference's ``LM.init`` carried across by
``params_from_reference``) and the same batches (NumPy, from a seed):
``LM.loss`` for every family within 1e-4 (float32, the reduced
configurations, as ``test_torch_families.py``); the gradients of the
dense family (gemma2, its local window cut to 8 so that it bites at 32
tokens) and the moe family (deepseek-v2, with its aux loss) against
``jax.grad`` of the reference's loss, each leaf within 1e-4 of its
largest |g|; remat on ≡ off; the port's train step over 3 steps against
the reference's composition of ``tests/launch/test_train_loop.py``
(value_and_grad, clip, the schedule, ``adamw_update``); then the
reference's own loop tests (loss falls, a checkpoint restart continues
bit for bit) and the CLI on ``--device cpu``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM, ModelConfig as RefModelConfig
from repro.optim.adamw8 import adamw8_init as r_adamw8_init, adamw8_update as r_adamw8_update
from repro_torch import optim as P
from repro_torch.optim import adamw8 as P8
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import train as train_cli
from repro_torch.models import LM, ModelConfig, params_from_reference
from repro_torch.models.interop import opt_state_from_reference
from repro_torch.models.lm import ce_chunks
from repro_torch.runtime import (TrainConfig, abstract_train_state, build_prefill_step, build_train_step,
                                 init_opt_state)

@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the reduced models gain little from more, and
    the suite's other workers (tests/test_torch_cpu_math.py forks children
    that time themselves) share the host's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


FAMILIES = ["gemma2-9b", "llama-3.2-vision-11b", "deepseek-v2-236b", "mamba2-780m", "recurrentgemma-2b",
            "whisper-base"]


def _kw(arch, **extra):
    kw = dict(remat=False, param_dtype="float32", compute_dtype="float32", local_window=8, ssm_chunk=8)
    if arch == "llama-3.2-vision-11b":
        kw["num_layers"] = 10              # two periods of cross_attn_every (test_torch_families.py)
    return {**kw, **extra}


def _pair(arch, seed=0, **extra):
    """(reference LM, its params, port LM with the same weights)."""
    ref_cfg = ref_get_config(arch, reduced=True).replace(**_kw(arch, **extra))
    cfg = get_config(arch, reduced=True).replace(**_kw(arch, **extra))
    params = RefLM(ref_cfg).init(jax.random.PRNGKey(seed))
    for key in ("cross_blocks", "dec_cross"):         # open the cross layers' tanh gates
        if key in params:
            n = params[key]["xgate"].shape[0]
            params[key] = dict(params[key], xgate=jnp.asarray(np.linspace(0.3, 0.9, n), jnp.float32))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return RefLM(ref_cfg), params, lm


def _batch(cfg, B, S, seed=0):
    """(reference batch, port batch): tokens, labels with masked entries
    (negative, and past the vocabulary in the padded range), embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, -2:] = -1
    labels[0, 1] = cfg.vocab_size + 3
    np_batch = {"tokens": toks, "labels": labels}
    if cfg.family == "vlm":
        np_batch["image_embeds"] = (rng.standard_normal((B, cfg.num_image_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "encdec":
        np_batch["audio_embeds"] = (rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model)) * 0.1).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in np_batch.items()}, {k: torch.from_numpy(v) for k, v in np_batch.items()})


def _close(port, ref, tol, what=""):
    np.testing.assert_allclose(np.asarray(port.detach().float()), np.asarray(ref, np.float32), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_matches_the_reference(arch):
    ref_lm, params, lm = _pair(arch)
    rb, pb = _batch(lm.cfg, 2, 32)
    (total, m), (rtotal, rm) = lm.loss(pb), ref_lm.loss(params, rb)
    assert total.dtype == torch.float32 and total.dim() == 0
    _close(total, rtotal, 1e-4, "total")
    for k in ("ce", "z_loss", "aux"):
        _close(m[k], rm[k], 1e-4, k)
    if arch == "deepseek-v2-236b":
        assert float(m["aux"]) > 0


def test_loss_chunks_follow_the_reference_rule(monkeypatch):
    """A small budget forces several chunks on both sides (B·S·V //
    budget = 16 → 16 chunks of 2 positions); the same sums."""
    ref_lm, params, lm = _pair("gemma2-9b")
    monkeypatch.setattr(type(ref_lm), "_CE_CHUNK_BUDGET", 2 * 32 * 512 // 16)
    monkeypatch.setattr(type(lm), "_CE_CHUNK_BUDGET", 2 * 32 * 512 // 16)
    rb, pb = _batch(lm.cfg, 2, 32, seed=3)
    _close(lm.loss(pb)[0], ref_lm.loss(params, rb)[0], 1e-5)
    assert ce_chunks(2, 32, 512, 2 * 32 * 512 // 16, LM._CE_MAX_CHUNKS) == 16


@pytest.mark.parametrize("B,S,V,want", [(1, 8192, 256_000, 1), (4, 8192, 256_000, 2), (8, 4096, 256_000, 2),
                                        (64, 8192, 256_000, 32), (256, 8192, 256_000, 128), (1, 7, 1 << 40, 7)])
def test_ce_chunk_count(B, S, V, want):
    n = ce_chunks(B, S, V, LM._CE_CHUNK_BUDGET, LM._CE_MAX_CHUNKS)
    target = max(1, min(B * S * V // 2 ** 31, 512, S))
    assert n == want and S % n == 0 and n <= target


def _grads_match(arch, B, S, **extra):
    ref_lm, params, lm = _pair(arch, **extra)
    rb, pb = _batch(lm.cfg, B, S, seed=1)
    rgrads = jax.grad(lambda p: ref_lm.loss(p, rb)[0])(params)
    lm.requires_grad_(True)
    total, _ = lm.loss(pb)
    total.backward()
    want = params_from_reference(lm.cfg, jax.tree.map(np.asarray, rgrads))
    got = dict(lm.named_parameters())
    assert want.keys() == got.keys()
    for name, g in want.items():
        big = float(np.abs(g.numpy()).max())
        err = float((got[name].grad - g).abs().max())
        assert err <= 1e-4 * max(big, 1e-12), f"{name}: {err} > 1e-4 · {big}"


def test_dense_gradients_match_jax_grad():
    _grads_match("gemma2-9b", 2, 32)


def test_moe_gradients_match_jax_grad():
    _grads_match("deepseek-v2-236b", 2, 16)


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b", "llama-3.2-vision-11b", "whisper-base"])
def test_other_families_gradients_match_jax_grad(arch):
    _grads_match(arch, 1, 16)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["gemma2-9b", "whisper-base", "deepseek-v2-236b"])
def test_remat_on_equals_off(arch, policy):
    _, _, lm = _pair(arch)
    _, pb = _batch(lm.cfg, 2, 16, seed=2)
    out = {}
    for remat in (False, True):
        lm.cfg = lm.cfg.replace(remat=remat, remat_policy=policy)
        lm.requires_grad_(True)
        lm.zero_grad(set_to_none=True)
        total, _ = lm.loss(pb)
        total.backward()
        out[remat] = (total.detach(), {k: p.grad.clone() for k, p in lm.named_parameters()})
    torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-6, atol=0)
    for k, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], g, rtol=1e-5, atol=1e-7 * float(g.abs().max()), msg=k)


# -- the train step against the reference's composition -----------------------------

TINY = dict(name="ci-tiny", num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=512,
            vocab_size=512, param_dtype="float32", compute_dtype="float32", remat=False, max_seq_len=128)


def _ref_step(ref_lm, tcfg):
    """The reference's composition (tests/launch/test_train_loop.py) with
    the trainer's schedule and microbatch average."""
    def grads_of(params, batch):
        n = tcfg.microbatches
        if n == 1:
            (loss, _), g = jax.value_and_grad(lambda p: ref_lm.loss(p, batch), has_aux=True)(params)
            return g, loss
        gsum = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        lsum = jnp.zeros((), jnp.float32)
        for i in range(n):
            mb = jax.tree.map(lambda x: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i], batch)
            (loss, _), g = jax.value_and_grad(lambda p: ref_lm.loss(p, mb), has_aux=True)(params)
            gsum = jax.tree.map(lambda a, b: a + b.astype(jnp.float32), gsum, g)
            lsum = lsum + loss
        return jax.tree.map(lambda g: g * (1.0 / n), gsum), lsum * (1.0 / n)

    @jax.jit
    def step(params, opt, batch):
        grads, loss = grads_of(params, batch)
        grads, gn = R.clip_by_global_norm(grads, tcfg.max_grad_norm)
        lr = R.linear_warmup_cosine(opt["step"], tcfg.warmup_steps, tcfg.total_steps, tcfg.peak_lr)
        params, opt = R.adamw_update(grads, opt, params, lr, R.AdamWConfig(weight_decay=tcfg.adamw.weight_decay))
        return params, opt, loss, gn, lr
    return step


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_the_reference_over_3_steps(microbatches):
    cfg, ref_cfg = ModelConfig(**TINY), RefModelConfig(**TINY)
    ref_lm, lm = RefLM(ref_cfg), LM(cfg, device="cpu")
    params = ref_lm.init(jax.random.PRNGKey(0))
    lm.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10, microbatches=microbatches)
    ref_step, step = _ref_step(ref_lm, tcfg), build_train_step(lm, tcfg)
    ropt, opt = R.adamw_init(params), init_opt_state(lm)
    ds = SyntheticLMDataset(cfg.vocab_size, 64, seed=3)
    for s in range(3):
        b = ds.batch(s, 4)
        params, ropt, rloss, rgn, rlr = ref_step(params, ropt, {k: jnp.asarray(v) for k, v in b.items()})
        m = step(opt, b)
        _close(m["loss"], rloss, 1e-5, "loss")
        _close(m["grad_norm"], rgn, 1e-5, "grad_norm")
        _close(m["lr"], rlr, 1e-7, "lr")
    want = params_from_reference(cfg, jax.tree.map(np.asarray, params))
    wm = params_from_reference(cfg, jax.tree.map(np.asarray, ropt["m"]))
    for k, p in lm.named_parameters():
        assert p.grad is None
        # each leaf within 1e-4 of its largest |p| (the norms, zero at
        # init, hold only the three updates; Adam's m/√v amplifies a
        # gradient's last-place difference where v is small)
        tol = 1e-4 * float(want[k].abs().max())
        torch.testing.assert_close(p.detach(), want[k], rtol=0, atol=tol, msg=k)
        torch.testing.assert_close(opt["m"][k], wm[k], rtol=1e-4, atol=1e-4 * float(wm[k].abs().max()), msg=k)
    assert int(opt["step"]) == int(ropt["step"]) == 3


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8"])
def test_resume_from_the_reference_state(optimizer):
    """The reference's parameters and optimizer state after two updates,
    carried across (``opt_state_from_reference``), then one more update in
    each package: the same parameters and state."""
    cfg, ref_cfg = ModelConfig(**TINY), RefModelConfig(**TINY)
    ref_lm = RefLM(ref_cfg)
    params = ref_lm.init(jax.random.PRNGKey(1))
    init, update = ((R.adamw_init, R.adamw_update) if optimizer == "adamw" else (r_adamw8_init, r_adamw8_update))
    ropt = init(params)
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * 0.01), params)
             for _ in range(3)]
    for g in grads[:2]:
        params, ropt = update(g, ropt, params, 1e-3)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    opt = opt_state_from_reference(cfg, jax.tree.map(np.asarray, ropt), optimizer)
    fresh = init_opt_state(lm, optimizer)
    assert int(opt["step"]) == 2 and opt["step"].dtype == torch.int64
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), opt["m"]) == \
        jax.tree.map(lambda t: (tuple(t.shape), t.dtype), fresh["m"])
    params, ropt = update(grads[2], ropt, params, 1e-3)
    pdict = dict(lm.named_parameters())
    port_update = P.adamw_update if optimizer == "adamw" else P8.adamw8_update
    port_update(params_from_reference(cfg, jax.tree.map(np.asarray, grads[2])), opt, pdict, 1e-3)
    want = params_from_reference(cfg, jax.tree.map(np.asarray, params))
    for k, p in pdict.items():
        # within 1e-4 of the leaf's largest |p|, as the 3-step test: here the
        # reference's float32 update (XLA on the CPU) is the one off the
        # float64 answer, by up to 7e-5 of a norm leaf
        torch.testing.assert_close(p.detach(), want[k], rtol=0, atol=1e-4 * float(want[k].abs().max()), msg=k)


def test_adamw8_state_of_a_stacked_scalar_is_requantized_per_layer():
    """The vlm family's cross-block tanh gates are one scalar a layer,
    stacked: the reference quantizes them together, the port one by one."""
    cfg = get_config("llama-3.2-vision-11b", reduced=True).replace(**_kw("llama-3.2-vision-11b"))
    ref_lm = RefLM(ref_get_config("llama-3.2-vision-11b", reduced=True).replace(**_kw("llama-3.2-vision-11b")))
    params = ref_lm.init(jax.random.PRNGKey(0))
    g = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, jnp.float32), params)
    g["cross_blocks"]["xgate"] = jnp.asarray([0.25, -1.0], jnp.float32)
    _, ropt = r_adamw8_update(g, r_adamw8_init(params), params, 1e-3)
    opt = opt_state_from_reference(cfg, jax.tree.map(np.asarray, ropt), "adamw8")
    for i, want in enumerate([0.25, -1.0]):
        st = opt["m"][f"cross_blocks.{i}.xgate"]
        assert tuple(st["q"].shape) == (1, 1)
        assert float(st["q"].float() * st["scale"]) == pytest.approx(0.1 * want, rel=1e-2)
    assert set(opt["m"]) == {k for k, _ in LM(cfg, device="meta").named_parameters()}


# -- the reference's loop tests (tests/launch/test_train_loop.py), on the port -------

def _train(steps, lm=None, opt=None, start=0, ckpt=None, ckpt_every=0):
    cfg = ModelConfig(**TINY)
    if lm is None:
        lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        opt = init_opt_state(lm)
    step = build_train_step(lm, TrainConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10 ** 9,
                                            adamw=P.AdamWConfig(weight_decay=0.0)))
    ds = SyntheticLMDataset(cfg.vocab_size, 64, seed=3)
    losses = []
    for s in range(start, steps):
        losses.append(float(step(opt, ds.batch(s, 4))["loss"]))
        if ckpt and ckpt_every and s and s % ckpt_every == 0:
            ckpt.save_async(s, (dict(lm.named_parameters()), opt))
    if ckpt:
        ckpt.wait()
    return lm, opt, losses


def test_loss_decreases():
    _, _, losses = _train(25)
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_checkpoint_restart_continues_identically(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2)
    lm_full, o_full, losses_full = _train(16, ckpt=ckpt, ckpt_every=6)
    lm = LM(ModelConfig(**TINY), device="cpu")
    opt = init_opt_state(lm)
    (params, opt), step = ckpt.restore((dict(lm.named_parameters()), opt))
    assert step == 12
    with torch.no_grad():
        for k, p in lm.named_parameters():
            p.copy_(params[k])
    lm_r, o_r, losses_resumed = _train(16, lm=lm, opt=opt, start=step + 1)
    assert losses_resumed == losses_full[step + 1:]
    for (k, a), (_, b) in zip(lm_full.named_parameters(), lm_r.named_parameters()):
        assert torch.equal(a, b), k
    for k in o_full["m"]:
        assert torch.equal(o_full["m"][k], o_r["m"][k]) and torch.equal(o_full["v"][k], o_r["v"][k])


# -- entry points -------------------------------------------------------------------

def test_cli_trains_on_the_host(capsys):
    lm, opt = train_cli.main(["--arch", "gemma2-9b", "--reduced", "--steps", "20", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "arch=gemma2-9b device=cpu devices=1"
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert out.rstrip().endswith("training complete") and int(opt["step"]) == 20


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-base"])
def test_cli_gives_vlm_and_encdec_zero_embeddings(arch, capsys):
    _, opt = train_cli.main(["--arch", arch, "--reduced", "--steps", "2", "--global-batch", "2", "--seq", "16",
                             "--device", "cpu"])
    assert int(opt["step"]) == 2 and "training complete" in capsys.readouterr().out


def test_cli_resumes_where_it_stopped(tmp_path, capsys):
    """A run cut after its step-5 checkpoint (the final one deleted)
    resumes there and ends where the unbroken run ends, bit for bit: a
    checkpoint's tag is the number of steps it holds (ROADMAP.md C5)."""
    args = ["--arch", "gemma2-9b", "--reduced", "--steps", "6", "--global-batch", "2", "--seq", "32",
            "--ckpt-every", "2", "--device", "cpu"]
    full, _ = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["step_00000005", "step_00000006"]
    import shutil
    shutil.rmtree(tmp_path / "a" / "step_00000006")
    capsys.readouterr()
    resumed, opt = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert "restored step 5" in capsys.readouterr().out
    assert int(opt["step"]) == 6
    for (k, a), (_, b) in zip(full.named_parameters(), resumed.named_parameters()):
        assert torch.equal(a, b), k


def test_prefill_step_is_the_last_position():
    _, _, lm = _pair("gemma2-9b")
    _, pb = _batch(lm.cfg, 2, 16)
    logits = build_prefill_step(lm)({"tokens": pb["tokens"].numpy()})
    assert logits.shape == (2, 1, lm.cfg.padded_vocab)
    torch.testing.assert_close(logits, lm.forward(pb["tokens"])[0][:, -1:])


def test_abstract_train_state_is_meta_and_full_size():
    params, opt = abstract_train_state(LM(get_config("gemma2-9b"), device="meta"))
    assert all(p.device.type == "meta" for p in params.values())
    assert sum(p.numel() for p in params.values()) == 9_241_404_928
    assert opt["m"].keys() == params.keys() and opt["m"]["embed"].dtype == torch.float32
    _, opt8 = abstract_train_state(LM(get_config("gemma2-9b"), device="meta"), optimizer="adamw8")
    assert opt8["m"]["embed"]["q"].dtype == torch.int8
    with pytest.raises(ValueError, match="optimizer"):
        abstract_train_state(LM(get_config("gemma2-9b"), device="meta"), optimizer="sgd")
