"""The port's cell grid (``repro_torch.configs.shapes``), serve step
(``runtime.serve``) and the attention kernels' ``meta`` route, on the CPU.

``cells``, ``SHAPES`` and ``input_specs`` equal the reference's for all 10
architectures × 4 shapes, in shape and type; ``abstract_cache`` equals the
reference's ``jax.eval_shape`` tree for every family at full width and
reduced (the vlm and encdec cross caches run the cross projections and
whisper's encoder through the kernels' ``meta`` route); the serve step is
bit-equal to ``decode_step`` on the host. On ``meta`` both attention
wrappers return empty outputs of the kernel's shapes and types at every
instance and padded width, forward and backward, charge their work
(``ops.work``) to an active counter, and move no launch counter; a
``meta`` tensor handed to a launcher raises. ``visible_pairs``' closed
form equals the per-row count."""
import copy
import functools

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import shapes as R
from repro.models import LM as RefLM
from repro.runtime.serve import abstract_cache as ref_abstract_cache
from repro_torch.configs import get_config, list_archs
from repro_torch.configs import shapes as S
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.models import LM, decode
from repro_torch.runtime.serve import abstract_cache, build_serve_step

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover
    from _hypothesis_compat import given, settings, strategies as st


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as every CPU-heavy port test file (ROADMAP C3)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16, "float32": torch.float32}


def _ref_tree(tree):
    return {k: _ref_tree(v) if isinstance(v, dict) else (tuple(v.shape), _DTYPES[str(v.dtype)])
            for k, v in tree.items()}


def _port_tree(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _port_tree(v)
        else:
            assert v.device.type == "meta", k
            out[k] = (tuple(v.shape), v.dtype)
    return out


# -- configs.shapes -------------------------------------------------------------

def test_the_cell_grid_equals_the_reference():
    assert S.cells(list_archs()) == R.cells(list_archs())
    assert len(S.cells(list_archs())) == 40 and sum(ok for *_, ok in S.cells(list_archs())) == 34
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in S.SHAPES.items()} == \
        {k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in R.SHAPES.items()}
    assert S.WHISPER_DECODER_LEN == R.WHISPER_DECODER_LEN
    for a in list_archs():
        assert S.long_500k_applicable(a) == R.long_500k_applicable(a)


@pytest.mark.parametrize("shape", list(R.SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_equal_the_reference(arch, shape):
    got = S.input_specs(get_config(arch), shape)
    assert _port_tree(got) == _ref_tree(R.input_specs(ref_get_config(arch), shape))
    assert S.input_specs(get_config(arch), S.SHAPES[shape]).keys() == got.keys()


# -- runtime.serve ----------------------------------------------------------------

@functools.cache
def _ref_lm(arch, reduced):
    return RefLM(ref_get_config(arch, reduced=reduced))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", list_archs())
def test_abstract_cache_equals_the_reference(arch, reduced):
    batch, max_len = (2, 96) if reduced else (3, 64)
    want = _ref_tree(ref_abstract_cache(_ref_lm(arch, reduced), batch, max_len))
    got = abstract_cache(LM(get_config(arch, reduced=reduced), device="meta"), batch, max_len)
    assert _port_tree(got) == want


def _filled_cache(lm, B, max_len, seed):
    cache = decode.init_cache(lm, B, max_len)
    gen = torch.Generator().manual_seed(seed)
    for t in _leaves(cache):
        t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    return cache


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


@pytest.mark.parametrize("arch", ["gemma2-9b", "recurrentgemma-2b", "deepseek-v2-236b"])
def test_serve_step_is_decode_step(arch):
    """Steps 0–3 from an empty cache, then the last position of a cache
    filled from a seeded generator: the logits bit-equal to decode_step
    on a copy of the same cache, the caches too; ``cache_abs`` is
    init_cache's tree in shape and type."""
    cfg = get_config(arch, reduced=True).replace(param_dtype="float32", compute_dtype="float32")
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    B, max_len = 2, 32
    step, cache_abs = build_serve_step(lm, B, max_len)
    cache = decode.init_cache(lm, B, max_len)
    assert _port_tree(cache_abs) == {k: v for k, v in _port_tree(abstract_cache(lm, B, max_len)).items()}
    assert _port_tree(cache_abs) == _shapes(cache)
    twin = copy.deepcopy(cache)
    rng = np.random.default_rng(0)
    for pos in range(4):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32))
        got, cache = step(tok, cache, pos)
        want, twin = decode.decode_step(lm, tok, twin, pos)
        assert torch.equal(got, want)
    cache, twin = _filled_cache(lm, B, max_len, 1), _filled_cache(lm, B, max_len, 1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32))
    got, cache = step(tok, cache, max_len - 1)
    want, twin = decode.decode_step(lm, tok, twin, max_len - 1)
    assert torch.equal(got, want) and got.shape == (B, 1, cfg.padded_vocab) and got.dtype == torch.float32
    for a, b in zip(_leaves(cache), _leaves(twin)):
        assert torch.equal(a, b)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else (tuple(v.shape), v.dtype) for k, v in tree.items()}


# -- the attention kernels' meta route -----------------------------------------------

def _counts():
    return (fa_ops.flash_attention.launches, dict(fa_ops.flash_attention.by_pair), fa_ops.flash_attention.padded,
            fa_ops.flash_attention_bwd.launches, dict(fa_ops.flash_attention_bwd.by_pair),
            fa_ops.flash_attention_bwd.padded, da_ops.decode_attention.launches, da_ops.decode_attention.padded)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


WIDTHS = list(fa_ops.PAIRS) + [(48, 32), (80, 80), (192, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("D,Dv", WIDTHS)
def test_flash_meta_route(D, Dv, dtype):
    B, Sq, Sk, H, KV = 2, 77, 200, 6, 3
    before = _counts()
    kv = _meta(B, Sk, KV, D + Dv, dtype=dtype)      # k and v two column ranges of one buffer, as MLA's
    q, k, v = _meta(B, Sq, H, D, dtype=dtype), kv[..., :D], kv[..., D:]
    pair = fa_ops.instance(D, Dv)
    with OpAnalysis() as mode:
        o = fa_ops.flash_attention(q, k, v, causal=False, window=0, softcap=30.0)
        o2, lse = fa_ops.flash_attention(q, k, v, window=64, return_lse=True)
        dq, dk, dv = fa_ops.flash_attention_bwd(q, k, v, o2, o2, window=64, lse=lse)
    for t, shape in ((o, (B, Sq, H, Dv)), (o2, (B, Sq, H, Dv)), (dq, q.shape), (dk, k.shape), (dv, v.shape)):
        assert t.device.type == "meta" and t.shape == shape and t.dtype == dtype
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32 and lse.device.type == "meta"
    assert _counts() == before
    it = torch.empty((), dtype=dtype).element_size()
    f1 = fa_ops.work(B, Sq, Sk, H, KV, *pair, causal=False, itemsize=it)
    f2 = fa_ops.work(B, Sq, Sk, H, KV, *pair, window=64, itemsize=it, lse=True)
    f3 = fa_ops.bwd_work(B, Sq, Sk, H, KV, *pair, window=64, itemsize=it)
    k_ = mode.cost.by_kernel
    assert k_["flash_attention"] == {"calls": 2, "flops": f1[0] + f2[0], "bytes": f1[1] + f2[1]}
    assert k_["flash_attention_bwd"] == {"calls": 1, "flops": f3[0], "bytes": f3[1]}


def test_flash_meta_route_through_autograd():
    B, S_, H, KV, D = 1, 130, 4, 2, 64
    q, k, v = (_meta(*s).requires_grad_() for s in ((B, S_, H, D), (B, S_, KV, D), (B, S_, KV, D)))
    before = _counts()
    with OpAnalysis() as mode:
        o = fa_ops.flash_attention(q, k, v, window=32, softcap=50.0)
        o.sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape and v.grad.shape == v.shape
    assert _counts() == before
    assert mode.cost.by_kernel["flash_attention"]["calls"] == 1
    assert mode.cost.by_kernel["flash_attention_bwd"]["calls"] == 1


@pytest.mark.parametrize("D", [32, 48, 64, 80, 128, 256])
def test_decode_meta_route(D):
    B, S_, H, KV, pos = 3, 300, 8, 2, 250
    before = _counts()
    q, k, v = _meta(B, H, D), _meta(B, S_, KV, D), _meta(B, S_, KV, D)
    with OpAnalysis() as mode:
        o = da_ops.decode_attention(q, k, v, pos, window=100, softcap=50.0)
    assert o.device.type == "meta" and o.shape == (B, H, D) and o.dtype == torch.bfloat16
    assert _counts() == before
    flops, nbytes = da_ops.work(B, H, KV, da_ops.instance(D), pos, window=100)
    assert mode.cost.by_kernel["decode_attention"] == {"calls": 1, "flops": flops, "bytes": nbytes}


def test_meta_route_keeps_the_kernels_refusals():
    with pytest.raises(ValueError, match="D, Dv up to an instance"):
        fa_ops.flash_attention(_meta(1, 8, 2, 320), _meta(1, 8, 2, 320), _meta(1, 8, 2, 320))
    with pytest.raises(ValueError, match="lse must be"):
        q = _meta(1, 8, 2, 64)
        fa_ops.flash_attention_bwd(q, q, q, q, q)
    with pytest.raises(ValueError, match="at most 16 query heads"):
        da_ops.decode_attention(_meta(1, 34, 64), _meta(1, 8, 2, 64), _meta(1, 8, 2, 64), 3)
    with pytest.raises(ValueError, match="several devices"):
        t = _meta(1, 8, 2, 64)
        fa_ops.flash_attention(t, t, torch.ones((1, 8, 2, 64), dtype=torch.bfloat16))


def test_a_meta_tensor_never_reaches_a_launch():
    q, k = _meta(1, 8, 2, 64), _meta(1, 8, 2, 64)
    with pytest.raises(ValueError, match="launches only on CUDA tensors"):
        fa_ops.launcher(q, k, k, q)
    with pytest.raises(ValueError, match="launches only on CUDA tensors"):
        fa_ops.bwd_launcher(q, k, k, q, q, q, k, k, lse=_meta(1, 2, 8, dtype=torch.float32))
    with pytest.raises(ValueError, match="launches only on CUDA tensors"):
        da_ops.launcher(_meta(1, 2, 64), k, k, _meta(1, 2, 64), 3)
    host = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="launches only on CUDA tensors"):
        fa_ops.launcher(host, host, host, host)


# -- visible_pairs ------------------------------------------------------------------

def _pairs_by_row(Sq, Sk, causal, window):
    total = 0
    for qp in range(Sq):
        hi = min(qp, Sk - 1) if causal else Sk - 1
        lo = max(0, qp - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 3, 64, 4096])
@pytest.mark.parametrize("Sq,Sk", [(1, 1), (77, 200), (200, 77), (1000, 1000), (8192, 8192), (2048, 1601),
                                   (1500, 1500), (16, 4096)])
def test_visible_pairs_closed_form(Sq, Sk, causal, window):
    if window > 0 and Sq > Sk + window - 1:
        return
    assert fa_ops.visible_pairs(Sq, Sk, causal, window) == _pairs_by_row(Sq, Sk, causal, window)


@given(st.integers(1, 400), st.integers(1, 400), st.booleans(), st.integers(0, 500))
@settings(max_examples=200, deadline=None)
def test_visible_pairs_closed_form_on_a_sweep(Sq, Sk, causal, window):
    assert fa_ops.visible_pairs(Sq, Sk, causal, window) == _pairs_by_row(Sq, Sk, causal, window)
