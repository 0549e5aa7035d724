"""The decode kernel's split of the cache, on the CPU.

``ops.split_size`` chooses how many keys a block of the split pass
takes, and ``ops.workspace_floats`` sizes the float32 workspace from it;
the kernel's blocks cover [sp·split, min(S, sp·split + split)) for
sp < ceil(S / split). Here every key must lie in exactly one split, the
grid must fit one wave where (batch, kv head) pairs divide ``WAVE``, and
the workspace must hold m, l and D accumulator values per split and head.
Then the split pass's arithmetic, emulated in float32 PyTorch (chunks of
``CHUNK`` keys, the exp2 domain, the combine's 2^(m_split − m) weights),
is held against the JAX Pallas kernel in interpret mode at the JAX
kernel tests' float32 tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import decode_attention_pallas
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import NEG_INF

LOG2E = 1.4426950408889634


@pytest.mark.parametrize("B,KV", [(1, 1), (4, 8), (2, 16), (4, 1)])
@pytest.mark.parametrize("S", [1, 63, 64, 1500, 1601, 2048, 4096, 8192, 8193])
def test_every_key_lies_in_exactly_one_split(S, B, KV):
    split = da_ops.split_size(B, KV, S)
    assert split >= da_ops.CHUNK and split % da_ops.CHUNK == 0
    nsplit = -(-S // split)
    cover = np.zeros(S, np.int64)
    for sp in range(nsplit):
        cover[sp * split: min(S, sp * split + split)] += 1
    assert (cover == 1).all()
    if da_ops.WAVE % (B * KV) == 0:   # then whole waves are one wave of more splits
        assert B * KV * nsplit <= da_ops.WAVE
    for rep, D in ((1, 32), (2, 256), (16, 128)):
        assert da_ops.workspace_floats(B, KV, rep, S, D, split) == B * KV * nsplit * rep * (D + 2)


def test_serving_shapes_fill_one_wave():
    """gemma2-9b's 4-slot decode over an 8192 cache and a 4096 ring: 8
    splits a (slot, kv head), 256 blocks, one wave of two blocks an SM."""
    for S in (8192, 4096):
        split = da_ops.split_size(4, 8, S)
        assert split == S // 8 and 4 * 8 * -(-S // split) == 256 <= da_ops.WAVE


def split_pass(q, k, v, pos, window, cap):
    """The kernel's split pass and combine, in float32 PyTorch."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    rep = H // KV
    split = da_ops.split_size(B, KV, S)
    qg = q.float().reshape(B, KV, rep, D)
    lo = max(0, pos - window + 1) if window > 0 else 0
    states = []
    for sp in range(-(-S // split)):
        a, e = max(sp * split, lo), min(min(S, sp * split + split) - 1, pos)
        m = torch.full((B, KV, rep), NEG_INF)
        l = torch.zeros((B, KV, rep))
        acc = torch.zeros((B, KV, rep, D))
        for c0 in range(a, e + 1, da_ops.CHUNK):
            c1 = min(e + 1, c0 + da_ops.CHUNK)
            dot = torch.einsum("bgrd,bngd->bgrn", qg, k[:, c0:c1].float())
            t = (torch.tanh(dot * (D ** -0.5 / cap)) * (cap * LOG2E) if cap > 0
                 else dot * (D ** -0.5 * LOG2E))
            m_new = torch.maximum(m, t.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(t - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrn,bngd->bgrd", p.to(v.dtype).float(), v[:, c0:c1].float())
            m = m_new
        states.append((m, l, acc))
    M = torch.stack([s[0] for s in states]).amax(0)
    w = [torch.exp2(s[0] - M) for s in states]
    L = sum(s[1] * wi for s, wi in zip(states, w))
    A = sum(s[2] * wi[..., None] for s, wi in zip(states, w))
    return (A / L.clamp_min(1e-30)[..., None]).reshape(B, H, D).to(q.dtype)


SPLIT_CASES = [
    # (B, S, H, KV, D, pos, window, softcap); S a multiple of the Pallas block
    (2, 1024, 8, 2, 64, 1000, 0, 50.0),
    (1, 1152, 8, 4, 128, 700, 300, 0.0),
    (3, 77, 16, 1, 32, 40, 0, 50.0),
    (1, 640, 4, 4, 256, 5, 0, 0.0),
    # recurrentgemma's rep 10 over one kv head, a vision cross layer read
    # to its last image token
    (2, 1536, 10, 1, 256, 1499, 0, 0.0),
    (1, 1664, 32, 8, 128, 1600, 0, 0.0),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_pass_matches_pallas_kernel(case):
    B, S, H, KV, D, pos, window, cap = case
    rng = np.random.default_rng(S + pos)
    q = rng.standard_normal((B, H, D)).astype(np.float32) * 1.5
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32) * 1.5
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    rep = H // KV
    out_k = decode_attention_pallas(
        jnp.asarray(q).reshape(B, KV, rep, D), jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3), pos, window=window, softcap=cap, blk_s=128,
        interpret=True,
    ).reshape(B, H, D)
    out_e = split_pass(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos, window, cap)
    np.testing.assert_allclose(out_e.numpy(), np.asarray(out_k), rtol=2e-5, atol=2e-5)
