"""The port's attention kernels' plain versions and its paged island
against the JAX reference on the CPU.

The same seeded numpy inputs go through the reference's Pallas kernels
(``repro.kernels.flash_attention`` / ``paged_attention`` in interpret
mode, as tests/test_kernels.py runs them) and through the port's
wrappers, which take their plain PyTorch versions for CPU tensors, at the
parameter grids of tests/test_kernels.py and with its tolerances (fp32
2e-5: summation order; bf16 2e-2: one bf16 rounding of the output). The
CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_gpu.py, chip_smoke.py)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref as JR
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.paged_attention import paged_attention as j_paged
from repro.models.layers.attention import chunked_attention
from repro.serving import paged as JP
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import paged_attention as TP
from repro_torch.kernels import ref as TR
from repro_torch.serving import paged as TPG

TOLS = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dt: str):
    """One fp32 numpy array as a (jax, torch) pair of dtype ``dt`` holding
    the same values (bf16 rounding happens once, in torch)."""
    t = torch.from_numpy(a.astype(np.float32)).to(TDT[dt])
    return jnp.asarray(t.float().numpy(), JDT[dt]), t


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------- flash
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,kh,sq,sk,hd,causal,window,softcap",
    [
        (2, 4, 4, 128, 128, 64, True, 0, 0.0),
        (1, 8, 2, 256, 256, 64, True, 0, 0.0),      # GQA g=4
        (2, 4, 2, 128, 256, 32, False, 0, 0.0),     # cross (sq != sk)
        (1, 4, 4, 256, 256, 64, True, 96, 0.0),     # sliding window
        (1, 4, 4, 128, 128, 64, True, 0, 50.0),     # softcap (gemma2)
        (2, 2, 2, 64, 64, 128, True, 48, 30.0),     # window+softcap
        (1, 32, 32, 128, 128, 80, True, 0, 0.0),    # zamba2's shared block
        (2, 4, 4, 64, 64, 80, True, 16, 0.0),       # head dim 80 + window
    ])
def test_flash_plain_matches_pallas_interpret(b, h, kh, sq, sk, hd, causal,
                                              window, softcap, dt):
    rng = np.random.default_rng(b * 1000 + sq + hd)
    jq, tq = _pair(rng.standard_normal((b, h, sq, hd)), dt)
    jk, tk = _pair(rng.standard_normal((b, kh, sk, hd)), dt)
    jv, tv = _pair(rng.standard_normal((b, kh, sk, hd)), dt)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap)
    want = j_flash(jq, jk, jv, block_q=64, block_kv=64, interpret=True, **kw)
    got = TF.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == TDT[dt] and got.shape == (b, h, sq, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOLS[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,s", [(1, 4, 4, 80), (2, 8, 2, 48)])
def test_flash_takes_prefill_transposed_views(b, h, kh, s, dt):
    """attention_prefill passes [b, s, h, hd] projections transposed to
    [b, h, s, hd] (no copy): the wrapper's CPU path gives the contiguous
    call's output, and the Pallas kernel's (interpret mode), at hd 80 and
    s not a multiple of 64."""
    hd = 80
    rng = np.random.default_rng(s + h)
    jq, tq = _pair(rng.standard_normal((b, s, h, hd)), dt)
    jk, tk = _pair(rng.standard_normal((b, s, kh, hd)), dt)
    jv, tv = _pair(rng.standard_normal((b, s, kh, hd)), dt)
    views = [t.transpose(1, 2) for t in (tq, tk, tv)]
    assert not views[0].is_contiguous()
    kw = dict(scale=hd ** -0.5, causal=True, window=0, softcap=0.0)
    got = TF.flash_attention(*views, **kw)
    assert got.shape == (b, h, s, hd) and got.dtype == TDT[dt]
    want = TF.flash_attention(*(v.contiguous() for v in views), **kw)
    assert torch.equal(got, want)
    jt = [jnp.swapaxes(x, 1, 2) for x in (jq, jk, jv)]
    pallas = j_flash(*jt, block_q=16, block_kv=16, interpret=True, **kw)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOLS[dt])


@pytest.mark.parametrize(
    "s,h,kh,hd,window,softcap,q_offset",
    [
        (13, 8, 4, 8, 0, 0.0, 0),       # the smoke model's prompts
        (21, 32, 4, 16, 0, 0.0, 0),     # yi-6b's GQA at a ragged length
        (9, 4, 2, 32, 5, 20.0, 0),      # window + softcap
        (7, 4, 4, 16, 0, 0.0, 11),      # q_offset: a chunk of a longer kv
    ])
def test_flash_plain_takes_ragged_lengths(s, h, kh, hd, window, softcap,
                                          q_offset):
    """Any sq / sk (the TPU wrapper needs sq % block_q == 0): the plain
    version against the reference oracle and, where q_offset is 0, against
    the serving path's chunked jnp attention ([b, s, h, hd] layout)."""
    rng = np.random.default_rng(s)
    sk = s + q_offset
    q = rng.standard_normal((2, h, s, hd)).astype(np.float32)
    k = rng.standard_normal((2, kh, sk, hd)).astype(np.float32)
    v = rng.standard_normal((2, kh, sk, hd)).astype(np.float32)
    kw = dict(scale=hd ** -0.5, causal=True, window=window, softcap=softcap)
    got = TR.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), q_offset=q_offset, **kw)
    want = JR.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), q_offset=q_offset, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOLS["float32"])
    if q_offset == 0:
        tr = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731
        chunked = chunked_attention(tr(q), tr(k), tr(v), q_block=16,
                                    kv_block=16, **kw)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(chunked).transpose(0, 2, 1, 3),
                                   **TOLS["float32"])


@pytest.mark.parametrize("q_offset,window", [(40, 8), (20, 8), (8, 4)])
def test_flash_plain_rows_that_see_no_key_match_reference(q_offset, window):
    """Causal, a window, and query rows past sk + window - 1, which see no
    key: the plain version, the reference oracle and the Pallas kernel (in
    interpret mode) all give the mean of V over the sk keys there. The
    card's kernels are held to the plain version on such rows in
    tests/test_torch_gpu.py."""
    rng = np.random.default_rng(q_offset + window)
    b, h, kh, sq, sk, hd = 1, 4, 2, 16, 16, 32
    q = rng.standard_normal((b, h, sq, hd)).astype(np.float32)
    k = rng.standard_normal((b, kh, sk, hd)).astype(np.float32)
    v = rng.standard_normal((b, kh, sk, hd)).astype(np.float32)
    kw = dict(scale=hd ** -0.5, causal=True, window=window, softcap=0.0,
              q_offset=q_offset)
    got = TR.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **kw).numpy()
    want = JR.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    pallas = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     block_q=16, block_kv=16, interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(want), **TOLS["float32"])
    np.testing.assert_allclose(got, np.asarray(pallas), **TOLS["float32"])
    blind = q_offset + np.arange(sq) >= sk + window - 1
    assert blind.any()
    mean_v = np.repeat(v, h // kh, axis=1).mean(axis=2)     # [b, h, hd]
    np.testing.assert_allclose(
        got[:, :, blind], np.broadcast_to(mean_v[:, :, None],
                                          got[:, :, blind].shape),
        **TOLS["float32"])


# ------------------------------------------------------------------- paged
def _paged_case(rng, b, h, kh, hd, block, nblk):
    """tests/test_kernels.py's construction: random rows per sequence,
    the rest of the page table missing (-1), ragged lengths."""
    cap = b * nblk + 4
    pages = np.full((b, nblk), -1, np.int32)
    lengths = np.zeros((b,), np.int32)
    perm = rng.permutation(cap)
    pi = 0
    for i in range(b):
        n = int(rng.integers(1, nblk + 1))
        pages[i, :n] = perm[pi:pi + n]
        pi += n
        lengths[i] = (n - 1) * block + int(rng.integers(1, block + 1))
    q = rng.standard_normal((b, h, hd))
    arena = rng.standard_normal((cap, 2, block, kh, hd))
    return q, arena, pages, lengths


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,kh,hd,block,nblk,window,softcap",
    [
        (2, 4, 4, 64, 16, 4, 0, 0.0),
        (3, 8, 2, 64, 16, 6, 0, 0.0),       # GQA g=4
        (2, 4, 4, 128, 32, 3, 0, 50.0),     # softcap
        (2, 4, 2, 64, 16, 8, 40, 0.0),      # sliding window
        (4, 32, 32, 80, 16, 4, 0, 0.0),     # zamba2's shared block decode
    ])
def test_paged_plain_matches_pallas_interpret(b, h, kh, hd, block, nblk,
                                              window, softcap, dt):
    rng = np.random.default_rng(b * 100 + nblk)
    q, arena, pages, lengths = _paged_case(rng, b, h, kh, hd, block, nblk)
    jq, tq = _pair(q, dt)
    ja, ta = _pair(arena, dt)
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    want = j_paged(jq, ja, jnp.asarray(pages), jnp.asarray(lengths),
                   interpret=True, **kw)
    got = TP.paged_attention(tq, ta, torch.from_numpy(pages),
                             torch.from_numpy(lengths), **kw)
    assert got.dtype == TDT[dt] and got.shape == (b, h, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOLS[dt])


def test_paged_plain_gives_zero_where_nothing_is_visible():
    """A sequence with no visible position (no pages, or length 0) gives
    0; the others are unaffected."""
    rng = np.random.default_rng(3)
    q, arena, pages, lengths = _paged_case(rng, 3, 4, 2, 16, 8, 3)
    pages[1] = -1
    lengths[2] = 0
    args = (torch.from_numpy(q).float(), torch.from_numpy(arena).float(),
            torch.from_numpy(pages), torch.from_numpy(lengths))
    got = TP.paged_attention(*args, scale=0.25)
    assert torch.count_nonzero(got[1:]) == 0
    want = JR.paged_attention_ref(jnp.asarray(q[:1], jnp.float32),
                                  jnp.asarray(arena, jnp.float32),
                                  jnp.asarray(pages[:1]),
                                  jnp.asarray(lengths[:1]), scale=0.25)
    np.testing.assert_allclose(got[:1].numpy(), np.asarray(want),
                               **TOLS["float32"])


SPLIT_POSITIONS = 64  # positions of one split (csrc/paged_attention.cuh)


def _split_merge(q, arena, pages, lengths, *, scale, softcap, window, pps):
    """The CUDA kernel's algebra in plain PyTorch: each split of ``pps``
    pages gives (o unnormalised, m, l) over its visible positions; splits
    that see nothing are left out; the rest merge by their log-sum-exp; a
    sequence with no split that sees anything gives 0."""
    b, h, hd = q.shape
    cap, _, block, kh, _ = arena.shape
    g = h // kh
    nblk = pages.shape[1]
    out = torch.zeros((b, h, hd), dtype=torch.float32)
    for i in range(b):
        n = int(lengths[i])
        lo = max(0, n - window + 1) if window > 0 else 0
        parts = []
        for j0 in range(0, nblk, pps):
            pos, ks, vs = [], [], []
            for j in range(j0, min(j0 + pps, nblk)):
                row = int(pages[i, j])
                for t in range(block):
                    p = j * block + t
                    if 0 <= row < cap and lo <= p < n:
                        pos.append(p)
                        ks.append(arena[row, 0, t].float())
                        vs.append(arena[row, 1, t].float())
            if not pos:
                continue
            k, v = torch.stack(ks), torch.stack(vs)      # [np, kh, hd]
            qg = q[i].float().reshape(kh, g, hd) * scale
            sc = torch.einsum("kgd,tkd->kgt", qg, k)
            if softcap > 0:
                sc = torch.tanh(sc / softcap) * softcap
            m = sc.amax(dim=-1)                          # [kh, g]
            e = torch.exp(sc - m[..., None])
            parts.append((torch.einsum("kgt,tkd->kgd", e, v), m,
                          e.sum(dim=-1)))
        if not parts:
            continue
        mx = torch.stack([m for _, m, _ in parts]).amax(dim=0)
        o = sum(torch.exp(m - mx)[..., None] * o for o, m, _ in parts)
        lsum = sum(torch.exp(m - mx) * l for _, m, l in parts)
        out[i] = (o / lsum[..., None]).reshape(h, hd)
    return out


@pytest.mark.parametrize(
    "b,h,kh,hd,block,nblk,lengths,window,softcap,holes",
    [
        (3, 8, 2, 16, 16, 12, [64, 65, 63], 0, 0.0, ()),     # split edges
        (3, 4, 4, 16, 16, 16, [200, 0, 1], 0, 0.0, ()),      # empty, 1 token
        (2, 8, 2, 16, 8, 24, [190, 70], 40, 0.0, ()),        # window drops splits
        (2, 4, 2, 32, 8, 16, [120, 90], 0, 30.0, ((0, 9), (1, 2))),  # holes
        (2, 4, 4, 8, 16, 12, [180, 100], 0, 0.0,
         ((0, 4), (0, 5), (0, 6), (0, 7))),                 # a split all missing
        (1, 4, 2, 16, 16, 4, [0], 0, 0.0, ()),               # nothing visible
    ])
def test_split_merge_of_partials_equals_plain(b, h, kh, hd, block, nblk,
                                              lengths, window, softcap,
                                              holes):
    """The split kernel's partial (o, m, l) per split, merged by their
    log-sum-exp, equals the plain version, including splits that see
    nothing and a sequence that sees nothing."""
    rng = np.random.default_rng(b * 7 + nblk)
    cap = b * nblk + 4
    pages = np.full((b, nblk), -1, np.int32)
    perm = rng.permutation(cap)
    pi = 0
    for i, n in enumerate(lengths):
        k = -(-n // block)
        pages[i, :k] = perm[pi:pi + k]
        pi += k
    for i, j in holes:
        pages[i, j] = -1
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    arena = torch.from_numpy(rng.standard_normal(
        (cap, 2, block, kh, hd)).astype(np.float32))
    pt, ln = torch.from_numpy(pages), torch.tensor(lengths, dtype=torch.int32)
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    got = _split_merge(q, arena, pt, ln, pps=max(1, SPLIT_POSITIONS // block),
                       **kw)
    want = TP.paged_attention_ref(q, arena, pt, ln, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    for i, n in enumerate(lengths):
        if n == 0:
            assert not got[i].any()


def test_cpu_tensors_take_the_plain_versions():
    _build.reset_launches()
    q = torch.randn(1, 4, 5, 32)
    k = torch.randn(1, 2, 5, 32)
    out = TF.flash_attention(q, k, k, scale=0.2)
    assert torch.equal(out, TF.flash_attention_ref(q, k, k, scale=0.2))
    arena = torch.randn(3, 2, 4, 2, 32)
    pages = torch.tensor([[0, 2]], dtype=torch.int32)
    lengths = torch.tensor([6], dtype=torch.int32)
    out = TP.paged_attention(q[:, :, 0], arena, pages, lengths, scale=0.2)
    assert torch.equal(out, TP.paged_attention_ref(q[:, :, 0], arena, pages,
                                                   lengths, scale=0.2))
    assert _build.launches["flash_attention"] == 0
    assert _build.launches["paged_attention"] == 0


def test_wrappers_refuse_mismatched_inputs():
    q = torch.randn(1, 4, 5, 32)
    with pytest.raises(TypeError):
        TF.flash_attention(q, torch.randn(1, 3, 5, 32),
                           torch.randn(1, 3, 5, 32), scale=1.0)  # 4 % 3
    with pytest.raises(TypeError):
        TF.flash_attention(q, q.to(torch.bfloat16), q, scale=1.0)
    arena = torch.randn(3, 2, 4, 2, 32)
    with pytest.raises(TypeError):
        TP.paged_attention(q[:, :, 0], arena, torch.zeros((1, 2)),
                           torch.zeros(1, dtype=torch.int32), scale=1.0)


# ------------------------------------------------------------ paged island
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 0.0), (5, 30.0),
                                            (1, 0.0)])
def test_island_matches_reference(window, softcap):
    """The port's island (write the new token first, then the kernel over
    ``lengths + 1`` and ``window + 1``) against the reference island
    (pool part plus a separate self term): one slot mid-block, one at a
    block boundary (its new row just allocated), one without a request
    (``write_rows`` -1). Outputs and the written arena must agree; the
    slot without a request writes nothing and gives 0 in the port (the
    reference's masked softmax leaves a mean of masked rows there, which
    the engine never reads)."""
    rng = np.random.default_rng(window * 10 + int(softcap))
    b, h, kh, hd, block, nblk = 3, 8, 4, 16, 8, 4
    geom_j = JP.plan_geometry(batch=b, seq_len=nblk * block, kv_heads=kh,
                              head_dim=hd, q_heads=h, block=block)
    geom_t = TPG.plan_geometry(batch=b, seq_len=nblk * block, kv_heads=kh,
                               head_dim=hd, q_heads=h, block=block)
    assert geom_t.nblk == geom_j.nblk and geom_t.cap == geom_j.cap
    cap = geom_j.cap
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kn = rng.standard_normal((b, kh, hd)).astype(np.float32)
    vn = rng.standard_normal((b, kh, hd)).astype(np.float32)
    arena = rng.standard_normal((cap, 2, block, kh, hd)).astype(np.float32)
    pt = np.full((b, 1, nblk), -1, np.int32)
    pt[0, 0, :2] = [5, 2]
    pt[1, 0, :3] = [0, 9, 7]
    lengths = np.array([13, 16, 0], np.int32)
    write_rows = np.array([[2], [7], [-1]], np.int32)
    write_off = lengths % block
    bs = JP.build_blk_start(geom_j)
    np.testing.assert_array_equal(bs, TPG.build_blk_start(geom_t))
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)

    j_out, j_arena = JP.make_paged_island(geom_j, None, **kw)(
        *map(jnp.asarray, (q, kn, vn, arena, pt, bs, lengths, write_rows,
                           write_off)))
    t_arena = torch.from_numpy(np.concatenate(
        [arena, np.zeros((1,) + arena.shape[1:], np.float32)]))
    t_out, t_arena2 = TPG.make_paged_island(geom_t, None, **kw)(
        *map(torch.from_numpy, (q, kn, vn)), t_arena,
        *map(torch.from_numpy, (pt, bs, lengths, write_rows, write_off)))
    assert t_arena2 is t_arena  # written in place
    np.testing.assert_allclose(t_out[:2].numpy(), np.asarray(j_out)[:2],
                               **TOLS["float32"])
    assert torch.count_nonzero(t_out[2]) == 0
    np.testing.assert_array_equal(t_arena[:cap].numpy(), np.asarray(j_arena))


def test_island_refuses_what_is_not_ported():
    from repro_torch.launch.mesh import make_production_mesh
    geom = TPG.plan_geometry(batch=2, seq_len=32, kv_heads=2, head_dim=8,
                             q_heads=4, block=8)
    # the int8 arena (tests/test_torch_kv_quant.py) and a device mesh
    # (tests/test_torch_serve_mesh.py) are ported; refused: a mesh that is
    # not a launch.mesh.Mesh, with or without the int8 arena, and a step
    # over the production mesh, which is a plan on the meta device
    assert callable(TPG.make_paged_island(geom, None, scale=1.0, quant=True))
    prod = make_production_mesh()
    planned = TPG.plan_geometry(batch=16, seq_len=4096, kv_heads=4,
                                head_dim=128, q_heads=32, mesh=prod)
    for quant in (False, True):
        with pytest.raises(TypeError):
            TPG.make_paged_island(geom, object(), scale=1.0, quant=quant)
        with pytest.raises(RuntimeError, match="plan"):
            TPG.make_paged_island(planned, prod, scale=1.0, quant=quant)
    with pytest.raises(TypeError):
        TPG.plan_geometry(batch=2, seq_len=32, kv_heads=2, head_dim=8,
                          q_heads=4, mesh=object())
