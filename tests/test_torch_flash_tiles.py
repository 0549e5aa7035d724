"""The bf16 flash kernel's walk over key tiles, on the CPU.

The kernel (``csrc/flash_attention.cu``, ``flash_bf16_kernel``) gives a
block 128 query rows, two consumer warpgroups of 64 rows each, and loads
the key tiles of 64 from ``key_range``'s begin to its end. A warpgroup
reads only the tiles [t_lo, t_hi) (a window hides a prefix of them, the
diagonal a suffix) and releases the others unread, and it runs the
per-score mask test only on an *edge* tile. Those conditions are written
out here as the kernel writes them and held against the mask itself:
every visible (query, key) pair lies in a tile the warpgroup reads, and
no interior tile holds a masked pair.
"""
import numpy as np
import pytest

BQ, BK = 128, 64


def key_range(Sq, Sk, causal, window, q0):
    q_last = min(q0 + BQ, Sq) - 1
    end = min(Sk, q_last + 1) if causal else Sk
    begin = max(0, q0 - window + 1) if window > 0 else 0
    return begin // BK * BK, end


def visible(qp, kp, Sk, causal, window):
    return (kp < Sk) & ((not causal) | (kp <= qp)) & ((window <= 0) | (qp - kp < window))


def visible_tiles(Sq, causal, window, qw0, kb, nt):
    """[t_lo, t_hi): the tiles a warpgroup of rows qw0 … qw0 + 63 reads."""
    t_lo, t_hi = 0, 0
    if qw0 < Sq:
        t_hi = min(nt, (qw0 + 63 - kb) // BK + 1) if causal else nt
        x = qw0 - window + 2 - BK - kb
        if window > 0 and x > 0:
            t_lo = min(t_hi, (x + BK - 1) // BK)
    return t_lo, t_hi


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (77, 77, True, 0), (200, 200, True, 100), (1000, 1000, True, 333), (77, 200, False, 0),
    (200, 1000, False, 0), (2304, 2304, True, 1000), (8192, 8192, True, 4096), (130, 130, True, 64),
    (1000, 1000, True, 1), (256, 256, True, 64),
    # the hybrid, vision and whisper families' (chip_smoke.py phase 8)
    (4096, 4096, True, 2048), (2048, 1601, False, 0), (1500, 1500, False, 0), (448, 1500, False, 0),
])
def test_hidden_and_interior_tiles_agree_with_the_mask(Sq, Sk, causal, window):
    seen = np.zeros((Sq, Sk), bool)
    for q0 in range(0, Sq, BQ):
        kb, ke = key_range(Sq, Sk, causal, window, q0)
        for c in range(2):
            qw0 = q0 + 64 * c
            rows = np.arange(qw0, min(qw0 + 64, Sq))[:, None]
            t_lo, t_hi = visible_tiles(Sq, causal, window, qw0, kb, (ke - kb + BK - 1) // BK)
            for t, k0 in enumerate(range(kb, ke, BK)):
                keys = np.arange(k0, k0 + BK)[None, :]
                ok = visible(rows, keys, Sk, causal, window)
                hidden = not t_lo <= t < t_hi
                edge = (k0 + BK > Sk or (causal and k0 + BK - 1 > qw0)
                        or (window > 0 and k0 <= qw0 + 63 - window))
                if hidden:
                    assert not ok.any()
                    continue
                if not edge:
                    assert ok.all()
                r, kk = np.nonzero(ok)
                seen[rows[r, 0], keys[0, kk]] = True
    qp, kp = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    np.testing.assert_array_equal(seen, visible(qp, kp, Sk, causal, window))
