"""Flash attention's backward in the port, on the CPU.

``flash_attention_bwd_ref`` (the plain version of the backward kernel
``csrc/flash_attention_bwd.cu``) against ``jax.vjp`` of the reference's
oracle ``repro.kernels.flash_attention.ref.flash_attention_ref`` and
against torch autograd through the port's forward plain version, over
every (D, Dv) instance, causal / window / soft-cap / GQA / Sq ≠ Sk, the
same inputs from a NumPy seed: max |diff| ≤ 2e-5 · max |reference| in
float32, 2e-2 in bf16 (the bf16 oracle rounds its scores and P to bf16
before its products; the port's backward sums in float32 throughout).
Then ``FlashAttentionFn``'s plumbing on the host, the wrapper's checks,
and the kernels' walks over tiles (kernel A's key tiles a query tile
sees, kernel B's query tiles a key tile is seen by; the float32 kernels'
32-row tiles and the bf16 kernels' 128-row blocks of two 64-row
warpgroups and 64-key blocks, with the tiles that skip the mask test),
written out as the kernels write them and held against the mask: the
card alone can run the kernels (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref

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


TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (B, Sq, Sk, H, KV, D, Dv, causal, window, cap)
CASES = [
    (1, 77, 77, 4, 2, 32, 32, True, 0, 0.0),
    (2, 40, 40, 6, 2, 64, 64, True, 9, 50.0),
    (1, 33, 33, 3, 1, 128, 128, True, 0, 30.0),
    (1, 20, 20, 10, 1, 256, 256, True, 7, 50.0),
    (1, 24, 24, 16, 16, 192, 128, True, 0, 0.0),
    (1, 12, 50, 4, 1, 64, 64, False, 0, 0.0),        # cross: Sq < Sk
    (2, 50, 30, 4, 2, 32, 32, False, 0, 50.0),       # Sq > Sk, non-causal
    (1, 64, 64, 2, 2, 32, 32, True, 1, 0.0),         # each row sees only itself
]
IDS = [f"B{c[0]}-{c[1]}x{c[2]}-H{c[3]}/{c[4]}-D{c[5]}/{c[6]}-{'c' if c[7] else 'nc'}-w{c[8]}-cap{c[9]:g}"
       for c in CASES]


def _inputs(case, seed=0):
    B, Sq, Sk, H, KV, D, Dv, *_ = case
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(B, Sq, H, D)) * 1.5).astype(np.float32),
            (rng.normal(size=(B, Sk, KV, D)) * 1.5).astype(np.float32),
            rng.normal(size=(B, Sk, KV, Dv)).astype(np.float32),
            rng.normal(size=(B, Sq, H, Dv)).astype(np.float32))


def _within(port, ref, tol, what, floor=0.0):
    """max |port − ref| ≤ tol · max(max |ref|, floor); ``floor`` is a tenth
    of the call's largest gradient (``_floor``), for a gradient that is
    zero in exact arithmetic (a window of 1: P is one-hot, so dq = dk =
    0 but for the rounding of dP − Δ)."""
    port = port.float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    err, big = float(np.abs(port - ref).max()), max(float(np.abs(ref).max()), floor)
    assert err <= tol * big, f"{what}: max |diff| {err} > {tol} · {big}"


def _floor(grads):
    return 0.1 * max(float(np.abs(np.asarray(g, np.float32)).max()) for g in grads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case, dtype):
    *_, causal, window, cap = case
    q, k, v, do = _inputs(case)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    o, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, causal=causal, window=window, softcap=cap), jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    to = torch.from_numpy(np.array(o, np.float32)).to(tdt)
    got = flash_attention_bwd_ref(tq, tk, tv, to, tdo, causal=causal, window=window, softcap=cap)
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (tq, tk, tv)):
        assert g.dtype == tdt and g.shape == t.shape
        _within(g, w, TOL[dtype], name, _floor(want))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_autograd_of_the_plain_forward(case):
    *_, causal, window, cap = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case, seed=1))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention_ref(*leaves, causal=causal, window=window, softcap=cap)
    o.backward(do)
    got = flash_attention_bwd_ref(q, k, v, o.detach(), do, causal=causal, window=window, softcap=cap)
    for name, g, t in zip(("dq", "dk", "dv"), got, leaves):
        _within(g, t.grad, 2e-5, name, _floor([x.grad for x in leaves]))


def test_function_on_the_host_runs_the_plain_versions_uncounted():
    case = CASES[1]
    *_, causal, window, cap = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case, seed=2))
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=causal, window=window, softcap=cap)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert torch.equal(o.detach(), flash_attention_ref(q, k, v, causal=causal, window=window, softcap=cap))
    o.backward(do)
    want = flash_attention_bwd_ref(q, k, v, o.detach(), do, causal=causal, window=window, softcap=cap)
    for g, t in zip(want, leaves):
        assert torch.equal(t.grad, g)
    assert (ops.flash_attention.launches, ops.flash_attention_bwd.launches) == before


def test_no_graph_without_grad():
    q, k, v, _ = (torch.from_numpy(a).requires_grad_() for a in _inputs(CASES[0]))
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    assert ops.flash_attention(q.detach(), k.detach(), v.detach()).grad_fn is None


def test_only_the_inputs_that_need_grad_get_one():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(CASES[2]))
    kk = k.clone().requires_grad_()
    ops.flash_attention(q, kk, v, softcap=30.0).backward(do)
    want = flash_attention_bwd_ref(q, k, v, flash_attention_ref(q, k, v, softcap=30.0), do, softcap=30.0)[1]
    assert torch.equal(kk.grad, want)


def test_backward_wrapper_checks_o_and_do():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(CASES[0]))
    o = flash_attention_ref(q, k, v)
    with pytest.raises(ValueError, match="do must be"):
        ops.flash_attention_bwd(q, k, v, o, do[:, :-1])
    with pytest.raises(ValueError, match="o must be"):
        ops.flash_attention_bwd(q, k, v, o.reshape(-1), do)
    with pytest.raises(ValueError, match="sees no key"):
        ops.flash_attention_bwd(q[:, :10], k[:, :2], v[:, :2], o[:, :10], do[:, :10], window=2)


# -- the kernels' walks over tiles (csrc/flash_attention_bwd.cu)

BQ = BK = 32


def visible(qp, kp, Sq, Sk, causal, window):
    return (qp < Sq) & (kp < Sk) & ((not causal) | (kp <= qp)) & ((window <= 0) | (qp - kp < window))


def key_tiles(Sq, Sk, causal, window, q0):
    """Kernel A (flash_bwd_dq_kernel): the key tiles of query tile q0."""
    q_last = min(q0 + BQ, Sq) - 1
    end = min(Sk, q_last + 1) if causal else Sk
    begin = max(0, q0 - window + 1) // BK * BK if window > 0 else 0
    return range(begin, end, BK)


def query_tiles(Sq, Sk, causal, window, k0):
    """Kernel B (flash_bwd_dkv_kernel): the query tiles of key tile k0."""
    k_last = min(k0 + BK, Sk) - 1
    begin = k0 // BQ * BQ if causal else 0
    end = min(Sq, k_last + window) if window > 0 else Sq
    return range(begin, end, BQ)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (77, 77, True, 0), (200, 200, True, 100), (1000, 1000, True, 333), (77, 200, False, 0),
    (200, 77, False, 0), (130, 130, True, 64), (1000, 1000, True, 1), (256, 256, True, 32),
    (8192, 8192, True, 4096), (4096, 4096, True, 2048), (2048, 1601, False, 0), (448, 1500, False, 0),
])
def test_both_walks_cover_every_visible_pair(Sq, Sk, causal, window):
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    want = visible(qp, kp, Sq, Sk, causal, window)
    seen_a = np.zeros((Sq, Sk), bool)
    for q0 in range(0, Sq, BQ):
        for k0 in key_tiles(Sq, Sk, causal, window, q0):
            seen_a[q0:q0 + BQ, k0:k0 + BK] = True
    seen_b = np.zeros((Sq, Sk), bool)
    for k0 in range(0, Sk, BK):
        for q0 in query_tiles(Sq, Sk, causal, window, k0):
            seen_b[q0:q0 + BQ, k0:k0 + BK] = True
    assert not (want & ~seen_a).any(), "kernel A skips a visible pair"
    assert not (want & ~seen_b).any(), "kernel B skips a visible pair"
    # and a causal walk visits no tile that holds no visible pair
    if causal:
        for seen in (seen_a, seen_b):
            for q0 in range(0, Sq, BQ):
                for k0 in range(0, Sk, BK):
                    assert not seen[q0, k0] or want[q0:q0 + BQ, k0:k0 + BK].any(), (q0, k0)


# -- the bf16 kernels' walks (csrc/flash_attention_bwd.cu: flash_bwd_dq_bf16_kernel,
# flash_bwd_dkv_bf16_kernel), written out as the kernels write them

BF16_SHAPES = [
    (77, 77, True, 0), (200, 200, True, 100), (1000, 1000, True, 333), (77, 200, False, 0),
    (200, 77, False, 0), (130, 130, True, 45), (1000, 1000, True, 1), (64, 64, True, 1),
    (256, 256, True, 64), (8192, 8192, True, 4096), (2048, 1601, False, 0), (200, 200, False, 50),
]


def dq_tiles(Sq, Sk, causal, window, qw0, q0):
    """Kernel A: the key tiles of 64 of the block at q0 (128 rows) and the
    visible ones [t_lo, t_hi) of its warpgroup at qw0 (64 rows)."""
    bq, bk = 128, 64
    ke = min(Sk, min(q0 + bq, Sq)) if causal else Sk
    kb = max(0, q0 - window + 1) // bk * bk if window > 0 else 0
    nt = (ke - kb + bk - 1) // bk
    t_lo = t_hi = 0
    if qw0 < Sq:
        t_hi = min(nt, (qw0 + 63 - kb) // bk + 1) if causal else nt
        x = qw0 - window + 2 - bk - kb
        if window > 0 and x > 0:
            t_lo = min(t_hi, (x + bk - 1) // bk)
    return kb, t_lo, t_hi


@pytest.mark.parametrize("Sq,Sk,causal,window", BF16_SHAPES)
def test_bf16_dq_walk_covers_every_visible_pair(Sq, Sk, causal, window):
    """Every visible pair lies in a tile its warpgroup reads; a tile it
    skips holds none; a tile it reads without the mask test (not an edge)
    holds only visible pairs."""
    qp, kp = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    want = visible(qp, kp, Sq, Sk, causal, window)
    seen = np.zeros((Sq, Sk), bool)
    for q0 in range(0, Sq, 128):
        for qw0 in (q0, q0 + 64):
            kb, t_lo, t_hi = dq_tiles(Sq, Sk, causal, window, qw0, q0)
            rows = np.arange(qw0, qw0 + 64)[:, None]
            for t in range(t_lo, t_hi):
                k0 = kb + 64 * t
                keys = np.arange(k0, k0 + 64)[None, :]
                ok = visible(rows, keys, Sq, Sk, causal, window)
                edge = (k0 + 64 > Sk or qw0 + 63 >= Sq or (causal and k0 + 63 > qw0)
                        or (window > 0 and k0 <= qw0 + 63 - window))
                assert edge or ok.all(), (qw0, k0)
                r, c = np.nonzero(ok)
                seen[rows[r, 0], keys[0, c]] = True
    np.testing.assert_array_equal(seen, want)


@pytest.mark.parametrize("Sq,Sk,causal,window", BF16_SHAPES)
def test_bf16_dkv_walk_covers_every_visible_pair(Sq, Sk, causal, window):
    """Kernel B: a block of 64 keys walks the query tiles of 64 rows from
    q_begin to q_end; every visible pair lies in one, and a tile without the
    mask test (not an edge) holds only visible pairs."""
    qp, kp = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    want = visible(qp, kp, Sq, Sk, causal, window)
    seen = np.zeros((Sq, Sk), bool)
    for k0 in range(0, Sk, 64):
        k_last = min(k0 + 64, Sk) - 1
        q_begin = k0 if causal else 0
        q_end = min(Sq, k_last + window) if window > 0 else Sq
        keys = np.arange(k0, k0 + 64)[None, :]
        for q0 in range(q_begin, q_end, 64):
            rows = np.arange(q0, q0 + 64)[:, None]
            ok = visible(rows, keys, Sq, Sk, causal, window)
            edge = (q0 + 64 > Sq or k0 + 64 > Sk or (causal and k0 + 63 > q0)
                    or (window > 0 and q0 + 63 - k0 >= window))
            assert edge or ok.all(), (k0, q0)
            r, c = np.nonzero(ok)
            seen[rows[r, 0], keys[0, c]] = True
    np.testing.assert_array_equal(seen, want)
