"""The port's optimizer substrate (``repro_torch.optim``) against the
reference's (``repro.optim``): the same inputs, made with NumPy from a
seed, through both. AdamW, clipping and the schedules agree within 1e-6
relative over 20 steps (float32 arithmetic in another order: a few
ulps); adamw8's parameters within 1e-5 relative, and its int8 codes off
by at most one in at most 0.1% of the elements (a value on a rounding
tie between two codes can land either side). Also the reference's own
behaviour tests (``tests/substrate/test_adamw8.py``, ``TestOptim``),
on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro.optim import adamw8 as R8
from repro_torch import optim as P
from repro_torch.optim import adamw8 as P8

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                      # offline CI: vendored shim
    from _hypothesis_compat import given, settings, strategies as st

SHAPES = {"w": (32, 48), "b": (48,), "e": (3, 16, 20), "s": ()}


def _np_tree(rng, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(port, ref, rtol, what):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(port, np.float64), ref, rtol=rtol, atol=rtol * np.abs(ref).max(),
                               err_msg=what)


@pytest.mark.parametrize("warmup,total,peak,floor", [(10, 100, 3e-4, 0.0), (1, 20, 1.0, 0.1), (0, 7, 2e-3, 0.0),
                                                     (100, 10_000, 3e-4, 0.0)])
def test_schedules_match_the_reference(warmup, total, peak, floor):
    steps = np.arange(0, total + 30, dtype=np.int32)
    ref = np.array([float(R.linear_warmup_cosine(jnp.asarray(s), warmup, total, peak, floor)) for s in steps])
    port = P.linear_warmup_cosine(torch.from_numpy(steps.astype(np.int64)), warmup, total, peak, floor)
    assert port.dtype == torch.float32
    _close(port.numpy(), ref, 1e-6, "linear_warmup_cosine")
    ref_cos = np.array([float(R.cosine_schedule(jnp.asarray(s), total, peak, floor)) for s in steps])
    _close(P.cosine_schedule(torch.from_numpy(steps.astype(np.int64)), total, peak, floor).numpy(), ref_cos, 1e-6,
           "cosine_schedule")


@pytest.mark.parametrize("max_norm", [1.0, 1e3, 0.05])
def test_clip_matches_the_reference(max_norm):
    g = _np_tree(np.random.default_rng(3))
    ref, ref_gn = R.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    port, gn = P.clip_by_global_norm(_to_torch(g), max_norm)
    assert gn.dtype == torch.float32
    _close(gn.numpy(), ref_gn, 1e-6, "global norm")
    for k in g:
        _close(port[k].numpy(), ref[k], 1e-6, k)


def _ref_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_matches_the_reference_over_20_steps(wd):
    rng = np.random.default_rng(11)
    p0 = _np_tree(rng)
    cfg_r, cfg_p = R.AdamWConfig(weight_decay=wd), P.AdamWConfig(weight_decay=wd)
    rp, ro = _ref_tree(p0), R.adamw_init(_ref_tree(p0))
    pp = _to_torch(p0)
    po = P.adamw_init(pp)
    for t in range(20):
        g = _np_tree(rng, 0.1)
        lr_r = R.linear_warmup_cosine(ro["step"], 3, 20, 1e-2)
        lr_p = P.linear_warmup_cosine(po["step"], 3, 20, 1e-2)
        rg, _ = R.clip_by_global_norm(_ref_tree(g), 1.0)
        pg, _ = P.clip_by_global_norm(_to_torch(g), 1.0)
        rp, ro = R.adamw_update(rg, ro, rp, lr_r, cfg_r)
        P.adamw_update(pg, po, pp, lr_p, cfg_p)
    assert int(po["step"]) == int(ro["step"]) == 20 and po["step"].dtype == torch.int64
    for k in p0:
        _close(pp[k].numpy(), rp[k], 1e-6, f"param {k}")
        _close(po["m"][k].numpy(), ro["m"][k], 1e-6, f"m {k}")
        _close(po["v"][k].numpy(), ro["v"][k], 1e-6, f"v {k}")


def test_adamw_bf16_params_round_like_the_reference():
    """bfloat16 parameters: the update in float32, rounded once to bf16;
    at most one bf16 ulp apart after 20 steps."""
    rng = np.random.default_rng(5)
    p0 = {k: v for k, v in _np_tree(rng).items() if v.ndim}
    rp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    pp = {k: torch.from_numpy(v).bfloat16() for k, v in p0.items()}
    ro, po = R.adamw_init(rp), P.adamw_init(pp)
    for _ in range(20):
        g = {k: v for k, v in _np_tree(rng, 0.1).items() if v.ndim}
        rp, ro = R.adamw_update({k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}, ro, rp, 1e-2)
        P.adamw_update({k: torch.from_numpy(v).bfloat16() for k, v in g.items()}, po, pp, 1e-2)
    for k in p0:
        assert pp[k].dtype == torch.bfloat16
        ref = np.asarray(rp[k], np.float32)
        np.testing.assert_allclose(pp[k].float().numpy(), ref, rtol=2 ** -7, atol=1e-30)


def test_adamw8_matches_the_reference_over_20_steps():
    rng = np.random.default_rng(21)
    p0 = _np_tree(rng)
    cfg_r, cfg_p = R.AdamWConfig(), P.AdamWConfig()
    rp, ro = _ref_tree(p0), R8.adamw8_init(_ref_tree(p0))
    pp = _to_torch(p0)
    po = P8.adamw8_init(pp)
    for k in p0:       # the same layout
        assert tuple(po["m"][k]["q"].shape) == ro["m"][k]["q"].shape
        assert tuple(po["m"][k]["scale"].shape) == ro["m"][k]["scale"].shape
    for _ in range(20):
        g = _np_tree(rng, 0.1)
        rp, ro = R8.adamw8_update(_ref_tree(g), ro, rp, 1e-2, cfg_r)
        P8.adamw8_update(_to_torch(g), po, pp, 1e-2, cfg_p)
    for k in p0:
        _close(pp[k].numpy(), rp[k], 1e-5, f"param {k}")
    off = total = 0
    for mom in ("m", "v"):
        for k in p0:
            q = po[mom][k]["q"].numpy().astype(np.int32)
            qr = np.asarray(ro[mom][k]["q"]).astype(np.int32)
            assert po[mom][k]["q"].dtype == torch.int8
            assert np.abs(q - qr).max() <= 1, f"{mom} {k}"
            off += int((q != qr).sum())
            total += q.size
            _close(po[mom][k]["scale"].numpy(), ro[mom][k]["scale"], 1e-5, f"{mom} {k} scale")
    print(f"adamw8 codes off by one: {off} of {total}")
    assert off <= total * 1e-3


@pytest.mark.parametrize("last", [1, 7, 48, 256, 1000, 1024, 3584, 14336, 4096 * 3])
def test_block_size_is_the_reference_rule(last):
    assert P8.block_size(last) == R8.block_size(last)


# -- the reference's behaviour tests, on the port (tests/substrate/test_adamw8.py)

def _params_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(32, 48)).astype(np.float32),
            "b": (rng.normal(size=(48,)) * 0.1).astype(np.float32)}


def test_adamw8_tracks_f32_adam_over_steps():
    cfg = P.AdamWConfig(weight_decay=0.0)
    p32, p8 = _to_torch(_params_np()), _to_torch(_params_np())
    o32, o8 = P.adamw_init(p32), P8.adamw8_init(p8)
    rng = np.random.default_rng(1)
    for _ in range(20):
        noise = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p32.items()}
        g = {k: torch.from_numpy(noise[k]) * 0.1 + 0.05 * p32[k] for k in p32}
        P.adamw_update(g, o32, p32, 1e-2, cfg)
        P8.adamw8_update({k: v.clone() for k, v in g.items()}, o8, p8, 1e-2, cfg)
    for k in p32:
        np.testing.assert_allclose(p32[k].numpy(), p8[k].numpy(), rtol=0.05, atol=0.02)


def test_adamw8_descends_a_quadratic():
    target = torch.from_numpy(np.linspace(-1, 1, 64).reshape(8, 8).astype(np.float32))
    p = {"w": torch.zeros((8, 8))}
    o = P8.adamw8_init(p)
    cfg = P.AdamWConfig(weight_decay=0.0)
    losses = []
    for _ in range(150):
        g = {"w": 2 * (p["w"] - target)}
        losses.append(float(torch.sum(torch.square(p["w"] - target))))
        P8.adamw8_update(g, o, p, 5e-2, cfg)
    assert losses[-1] < losses[0] * 0.05


def test_adamw8_state_is_actually_int8():
    p = _to_torch(_params_np())
    o = P8.adamw8_init(p)
    qs = [s["q"] for s in o["m"].values()]
    assert all(q.dtype == torch.int8 for q in qs)
    f32_bytes = sum(m.numel() * 4 for m in P.adamw_init(p)["m"].values())
    q_bytes = sum(q.numel() * q.element_size() for q in qs)
    assert q_bytes < f32_bytes * 0.35


# -- TestOptim (tests/substrate/test_data_optim.py), on the port

class TestOptim:
    def _params(self):
        return {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}

    def test_adamw_moves_params_against_gradient(self):
        p = self._params()
        opt = P.adamw_init(p)
        g = {k: torch.ones_like(v) for k, v in p.items()}
        P.adamw_update(g, opt, p, lr=0.1, cfg=P.AdamWConfig(weight_decay=0.0))
        assert int(opt["step"]) == 1
        assert float(p["w"][0, 0]) < 1.0
        assert float(p["b"][0]) < 0.0

    def test_weight_decay_only_on_matrices(self):
        p = self._params()
        opt = P.adamw_init(p)
        g = {k: torch.zeros_like(v) for k, v in p.items()}
        P.adamw_update(g, opt, p, lr=0.1, cfg=P.AdamWConfig(weight_decay=0.5))
        assert float(p["w"][0, 0]) < 1.0
        assert float(p["b"][0]) == 0.0

    def test_clip_by_global_norm(self):
        g = {"a": torch.full((10,), 10.0)}
        clipped, norm = P.clip_by_global_norm(g, 1.0)
        assert float(norm) == pytest.approx(np.sqrt(1000), rel=1e-5)
        assert float(torch.sqrt(torch.sum(torch.square(clipped["a"])))) == pytest.approx(1.0, rel=1e-4)

    def test_schedule_warmup_then_decay(self):
        lrs = [float(P.linear_warmup_cosine(torch.tensor(s), 10, 100, 1.0)) for s in range(0, 100, 5)]
        assert lrs[1] > lrs[0]
        assert lrs[-1] < max(lrs)
        assert max(lrs) <= 1.0 + 1e-6

    @given(st.integers(0, 2**31 - 1))
    @settings(max_examples=30, deadline=None)
    def test_int8_quant_roundtrip_bound(self, seed):
        x = torch.from_numpy(np.random.default_rng(seed).normal(size=(64,)).astype(np.float32))
        q, scale = P.quantize_int8(x)
        err = (P.dequantize_int8(q, scale) - x).abs()
        assert float(err.max()) <= float(scale) / 2 + 1e-6

    def test_ef_allreduce_single_device(self):
        g = torch.linspace(-1, 1, 32)
        out, new_e = P.ef_int8_allreduce(g, torch.zeros_like(g))
        np.testing.assert_allclose(out.numpy(), g.numpy(), atol=0.02)
        assert float(new_e.abs().max()) <= float(g.abs().max()) / 127 + 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_codec_and_ef_step_match_the_reference(seed):
    """quantize / dequantize and one EF step (the reference's psum over a
    pod axis of one, as jax.vmap names it) equal to the reference's."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(257,)).astype(np.float32)
    e = (rng.normal(size=(257,)) * 1e-3).astype(np.float32)
    q, scale = P.quantize_int8(torch.from_numpy(x))
    qr, sr = R.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    assert float(scale) == float(sr)
    np.testing.assert_array_equal(P.dequantize_int8(q, scale).numpy(), np.asarray(R.dequantize_int8(qr, sr)))
    ref = jax.vmap(lambda g, err: R.ef_int8_allreduce(g, err, "pod"), axis_name="pod")(
        jnp.asarray(x)[None], jnp.asarray(e)[None])
    out = P.ef_int8_allreduce(torch.from_numpy(x), torch.from_numpy(e))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[0], rtol=1e-6, atol=1e-7)


def test_ef_allreduce_over_a_process_group_of_one(tmp_path):
    """The group path (torch.distributed, gloo, one rank) gives the
    no-group answer."""
    import torch.distributed as dist

    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        g = torch.from_numpy(np.random.default_rng(4).normal(size=(100,)).astype(np.float32))
        e = torch.zeros_like(g)
        got = P.ef_int8_allreduce(g, e, group=dist.group.WORLD)
        want = P.ef_int8_allreduce(g, e)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
