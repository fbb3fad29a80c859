"""The tile walk of the bf16 flash-attention backward kernels, on the CPU.

``bwd_tile_walk`` mirrors the bounds that the wgmma kernels of
``csrc/flash_attention_bwd.cu`` walk (the card's test
``test_flash_bwd_walk_matches_library`` holds the mirror to the library's
own count). Here the walk is held to the mask it must cover: every
visible (query, key) pair lies in a tile pair that a dK/dV CTA and a dQ
CTA both walk, every row that sees no key is walked by every dK/dV CTA
(such a row adds dO / sk to every key's dV), and no tile pair is walked
twice. The shapes: ``tests/test_torch_train_kernels.py``'s CASES,
gemma2-2b's training shape (global and window 4,096), zamba2-2.7b's,
and the edges of the kernels' tiles (64 rows a tile; 128 keys or rows a
CTA, 64 at head dim 256), windows that end inside a tile, ``q_offset``
and rows that see no key, at every head dim the kernels take."""
import numpy as np
import pytest

from repro_torch.kernels import flash_attention as FA
from test_torch_train_kernels import CASES

# (sq, sk, causal, window, q_offset)
SHAPES = sorted({c[3:5] + (c[6], c[7], c[9]) for c in CASES} | {
    (8192, 8192, True, 0, 0),        # gemma2-2b, global (and zamba2-2.7b)
    (8192, 8192, True, 4096, 0),     # gemma2-2b, window 4,096
    (4608, 4608, True, 4096, 0),     # a window crossed at gemma2's width
    (63, 63, True, 0, 0), (64, 64, True, 0, 0), (65, 65, True, 0, 0),
    (127, 129, True, 0, 0), (128, 128, False, 0, 0), (129, 127, True, 0, 0),
    (65, 193, False, 37, 0),         # a window edge inside a tile
    (200, 300, True, 37, 100),       # q_offset, window inside a tile
    (16, 16, True, 4, 8),            # rows that see no key
    (70, 50, False, 6, 60),          # the same, more than a tile of them
    (1, 700, True, 0, 699),          # one row at the end
})


def _key_bounds(sq, sk, causal, window, q_offset):
    """Each row's visible keys [lo, hi), and whether it sees none."""
    q = q_offset + np.arange(sq)
    hi = np.minimum(sk, q + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(sq, int)
    blind = q >= sk + window - 1 if window > 0 else np.zeros(sq, bool)
    return lo, np.maximum(hi, lo), blind


@pytest.mark.parametrize("hd", FA.BWD_TC_HEAD_DIMS)
@pytest.mark.parametrize("sq,sk,causal,window,q_offset", SHAPES)
def test_walk_covers_the_mask_once(sq, sk, causal, window, q_offset, hd):
    walk = FA.bwd_tile_walk(sq, sk, hd, causal=causal, window=window,
                            q_offset=q_offset)
    t, cta = walk.tile, walk.cta
    assert (t, cta) == (64, 64 if hd == 256 else 128)
    lo, hi, blind = _key_bounds(sq, sk, causal, window, q_offset)
    seen = hi > lo
    assert int((hi - lo)[seen].sum()) == FA.visible_pairs(
        sq, sk, causal, window, q_offset)
    rows = np.arange(sq)

    # dK/dV: a CTA's keys [k0, k0 + cta) need every row that sees one of
    # them, and every row that sees none
    assert [k0 for k0, _, _ in walk.dkdv] == list(range(0, sk, cta))
    pairs = []
    for k0, r_lo, r_hi in walk.dkdv:
        assert r_lo % t == 0
        need = (seen & (lo < k0 + cta) & (hi > k0)) | blind
        assert np.all((rows[need] >= r_lo) & (rows[need] < r_hi)), (k0,)
        pairs += [(q0, k0) for q0 in range(r_lo, r_hi, t)]
    assert len(pairs) == len(set(pairs))
    assert len(pairs) == walk.steps("dkdv")

    # dQ: a CTA's rows [q0, q0 + cta) need every key one of them sees
    assert [q0 for q0, _, _ in walk.dq] == list(range(0, sq, cta))
    pairs = []
    for q0, k_lo, k_hi in walk.dq:
        assert k_lo % t == 0
        mine = seen[q0:q0 + cta]
        if mine.any():
            assert k_lo <= lo[q0:q0 + cta][mine].min(), (q0,)
            assert hi[q0:q0 + cta][mine].max() <= k_hi, (q0,)
        pairs += [(q0, k0) for k0 in range(k_lo, k_hi, t)]
    assert len(pairs) == len(set(pairs))
    assert len(pairs) == walk.steps("dq")


def test_walk_refuses_the_simt_head_dims():
    for hd in (8, 16):
        with pytest.raises(ValueError):
            FA.bwd_tile_walk(64, 64, hd)
