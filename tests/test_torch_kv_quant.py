"""The port's int8 KV arena against the JAX reference on the CPU.

* The paged island with ``quant=True`` (``serving/paged.py``) against the
  reference's ``make_paged_island(quant=True)`` on the inputs of
  tests/test_kv_quant.py (b 2, h 4 / kh 2, hd 32, block 8, 4 blocks),
  drawn from a seeded numpy generator: the written int8 arena and its
  scales EQUAL, the output within 1e-4 (fp32: the port's one softmax
  against the reference's chunked online one).
* The int8 ``ServeEngine`` (yi-6b's SMOKE config, and zamba2's, whose
  shared block's arena is int8) against the reference's: 8 decode rounds
  of equal greedy tokens; int8 arenas equal but for values one step off
  where the two packages' fp32 K/V (a few ulp apart) sat on a rounding
  boundary (at most 1 in 1,000), scales within 1e-5 (relative).
* ``paged_attention_ref`` with scales against dequantize-then-attend, and
  its self term against writing the token and attending one more
  position: the plain version the card's kernel is held against.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import transformer as JTF
from repro.models.params import split
from repro.serving import engine as JE
from repro.serving import paged as JP
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.kernels import paged_attention as TPA
from repro_torch.serving import engine as TE
from repro_torch.serving import paged as TP

OUT_ATOL = 1e-4


def _island_inputs(seed: int):
    b, h, kh, hd, block, nblk = 2, 4, 2, 32, 8, 4
    rng = np.random.default_rng(seed)
    cap = b * nblk
    arena_fp = rng.standard_normal((cap, 2, block, kh, hd)).astype(np.float32)
    amax = np.abs(arena_fp).max(axis=-1)
    sc = (np.maximum(amax, 1e-8) / 127.0).astype(np.float32)
    arena_q = np.clip(np.round(arena_fp / sc[..., None]), -127, 127
                      ).astype(np.int8)
    return dict(
        geom=dict(b=b, h=h, kh=kh, hd=hd, block=block, nblk=nblk, cap=cap),
        q=rng.standard_normal((b, h, hd)).astype(np.float32),
        kn=rng.standard_normal((b, kh, hd)).astype(np.float32),
        vn=rng.standard_normal((b, kh, hd)).astype(np.float32),
        arena=arena_q, scales=sc,
        pages=np.asarray([[0, 1, 2, 3], [4, 5, 6, -1]], np.int32),
        lengths=np.asarray([4 * block - 2, 3 * block - 1], np.int32),
        wrows=np.asarray([[3], [6]], np.int32))


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 0), (0.0, 11),
                                            (20.0, 5)])
def test_int8_island_matches_reference(softcap, window):
    x = _island_inputs(3)
    g = x["geom"]
    b, block, nblk, cap = g["b"], g["block"], g["nblk"], g["cap"]
    woff = x["lengths"] % block
    bs = np.broadcast_to(np.arange(nblk)[None, None] * block,
                         (b, 1, nblk)).astype(np.int32)
    jgeom = JP.plan_geometry(batch=b, seq_len=block * nblk, kv_heads=g["kh"],
                             head_dim=g["hd"], q_heads=g["h"], mesh=None,
                             block=block)
    j_isl = JP.make_paged_island(jgeom, None, scale=g["hd"] ** -0.5,
                                 softcap=softcap, window=window, quant=True)
    j_out, j_arena, j_sc = j_isl(
        jnp.asarray(x["q"]), jnp.asarray(x["kn"]), jnp.asarray(x["vn"]),
        jnp.asarray(x["arena"]), jnp.asarray(x["pages"][:, None]),
        jnp.asarray(bs), jnp.asarray(x["lengths"]), jnp.asarray(x["wrows"]),
        jnp.asarray(woff), jnp.asarray(x["scales"]))

    tgeom = TP.plan_geometry(batch=b, seq_len=block * nblk, kv_heads=g["kh"],
                             head_dim=g["hd"], q_heads=g["h"], block=block)
    t_isl = TP.make_paged_island(tgeom, scale=g["hd"] ** -0.5,
                                 softcap=softcap, window=window, quant=True)
    # the port's arena and scales carry the scratch row of dropped writes
    arena = torch.cat([torch.from_numpy(x["arena"]),
                       torch.zeros((1,) + x["arena"].shape[1:], dtype=torch.int8)])
    scl = torch.cat([torch.from_numpy(x["scales"]),
                     torch.zeros((1,) + x["scales"].shape[1:])])
    out, arena2, scl2 = t_isl(
        torch.from_numpy(x["q"]), torch.from_numpy(x["kn"]),
        torch.from_numpy(x["vn"]), arena, torch.from_numpy(x["pages"][:, None]),
        torch.from_numpy(bs.copy()), torch.from_numpy(x["lengths"]),
        torch.from_numpy(x["wrows"]), torch.from_numpy(woff), scl)
    assert arena2 is arena and scl2 is scl   # written in place
    np.testing.assert_array_equal(arena[:cap].numpy(), np.asarray(j_arena))
    np.testing.assert_array_equal(scl[:cap].numpy(), np.asarray(j_sc))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0,
                               atol=OUT_ATOL)


def test_int8_island_slot_without_request_gives_zero_and_writes_nothing():
    x = _island_inputs(4)
    g = x["geom"]
    b, block, nblk, cap = g["b"], g["block"], g["nblk"], g["cap"]
    tgeom = TP.plan_geometry(batch=b, seq_len=block * nblk, kv_heads=g["kh"],
                             head_dim=g["hd"], q_heads=g["h"], block=block)
    t_isl = TP.make_paged_island(tgeom, scale=0.2, quant=True)
    arena = torch.cat([torch.from_numpy(x["arena"]),
                       torch.zeros((1,) + x["arena"].shape[1:], dtype=torch.int8)])
    scl = torch.cat([torch.from_numpy(x["scales"]),
                     torch.zeros((1,) + x["scales"].shape[1:])])
    before = arena[:cap].clone(), scl[:cap].clone()
    wrows = torch.tensor([[-1], [6]], dtype=torch.int32)
    lengths = torch.from_numpy(x["lengths"])
    out, _, _ = t_isl(
        torch.from_numpy(x["q"]), torch.from_numpy(x["kn"]),
        torch.from_numpy(x["vn"]), arena,
        torch.from_numpy(x["pages"][:, None]),
        torch.zeros((b, 1, nblk), dtype=torch.int32), lengths, wrows,
        lengths % block, scl)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.equal(arena[:6], before[0][:6])   # only row 6 was written
    assert torch.equal(scl[:6], before[1][:6])
    assert not torch.equal(arena[6], before[0][6])


def test_quantize_kv_is_the_reference_rule():
    rng = np.random.default_rng(9)
    kv = rng.standard_normal((5, 2, 3, 16)).astype(np.float32)
    kv[0, 0, 0] = 0.0                         # amax 0: the 1e-8 floor
    kv[1, 1, 2, :4] = [127.0, -63.5, 0.5, -0.5]   # halves round to even
    amax = jnp.max(jnp.abs(jnp.asarray(kv)), axis=-1)
    jsc = jnp.maximum(amax, 1e-8) / 127.0
    jq = jnp.clip(jnp.round(jnp.asarray(kv) / jsc[..., None]), -127, 127
                  ).astype(jnp.int8)
    q, sc = TP.quantize_kv(torch.from_numpy(kv))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (25.0, 7)])
def test_paged_ref_with_scales_is_dequantize_then_attend(dt, softcap, window):
    x = _island_inputs(5)
    q = torch.from_numpy(x["q"]).to(dt)
    arena = torch.from_numpy(x["arena"])
    scl = torch.from_numpy(x["scales"])
    pages = torch.from_numpy(x["pages"])
    lengths = torch.from_numpy(x["lengths"])
    got = TPA.paged_attention_ref(q, arena, pages, lengths, scale=0.17,
                                  softcap=softcap, window=window, scales=scl)
    deq = arena.float() * scl[..., None]
    want = TPA.paged_attention_ref(q.float(), deq, pages, lengths, scale=0.17,
                                   softcap=softcap, window=window)
    np.testing.assert_allclose(got.float().numpy(), want.to(dt).float().numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("window", [0, 6])
def test_paged_ref_self_term_is_one_more_position(window):
    """The self term equals writing the token at position ``lengths`` and
    attending ``lengths + 1`` positions (window + 1)."""
    x = _island_inputs(6)
    g = x["geom"]
    arena = torch.from_numpy(x["arena"].astype(np.float32))
    q = torch.from_numpy(x["q"])
    kn, vn = torch.from_numpy(x["kn"]), torch.from_numpy(x["vn"])
    pages = torch.from_numpy(x["pages"])
    lengths = torch.from_numpy(x["lengths"])
    got = TPA.paged_attention_ref(q, arena, pages, lengths, scale=0.1,
                                  window=window, kv_self=(kn, vn))
    written = arena.clone()
    rows = torch.from_numpy(x["wrows"][:, 0]).long()
    off = (lengths % g["block"]).long()
    written[rows, 0, off] = kn
    written[rows, 1, off] = vn
    want = TPA.paged_attention_ref(q, written, pages, lengths + 1, scale=0.1,
                                   window=window + 1 if window else 0)
    # fp32 summation order only (the int8 values reach |75|)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    none = TPA.paged_attention_ref(q, arena, pages, torch.full_like(lengths, -1),
                                   scale=0.1, kv_self=(kn, vn))
    assert torch.equal(none, torch.zeros_like(none))
    alone = TPA.paged_attention_ref(q, arena, pages, torch.zeros_like(lengths),
                                    scale=0.1, kv_self=(kn, vn))
    np.testing.assert_allclose(
        alone.numpy(), vn.repeat_interleave(g["h"] // g["kh"], dim=1).numpy(),
        rtol=0, atol=1e-6)


def test_paged_ref_refuses_int8_without_scales_and_scales_without_int8():
    x = _island_inputs(7)
    args = (torch.from_numpy(x["q"]), torch.from_numpy(x["arena"]),
            torch.from_numpy(x["pages"]), torch.from_numpy(x["lengths"]))
    with pytest.raises(TypeError, match="scales"):
        TPA.paged_attention_ref(*args, scale=1.0)
    with pytest.raises(TypeError, match="int8"):
        TPA.paged_attention_ref(args[0], args[1].float(), *args[2:], scale=1.0,
                                scales=torch.from_numpy(x["scales"]))


# ------------------------------------------------------------------ engine

@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jp = split(JTF.init_model(jax.random.PRNGKey(0), jcfg))[0]
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch,arenas", [
    ("yi-6b", ("arena",)), ("zamba2-2.7b", ("shared_arena",))])
def test_int8_engine_matches_reference_engine(arch, arenas):
    jcfg, tcfg, jp, tp = _weights(arch)
    jcfg = dataclasses.replace(jcfg, kv_quant_int8=True)
    tcfg = dataclasses.replace(tcfg, kv_quant_int8=True)
    kw = dict(max_slots=2, max_seq=64, block=8)
    ref = JE.ServeEngine(jcfg, jp, **kw)
    eng = TE.ServeEngine(tcfg, tp, device="cpu", **kw)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (12, 7)]
    for i, p in enumerate(prompts):
        assert ref.add_request(p, user_id=i) == eng.add_request(p, user_id=i)
    for name in arenas:
        assert eng.state[name].dtype == torch.int8
        assert eng.state[name + "_scale"].dtype == torch.float32
    for _ in range(8):
        assert ref.decode_round() == eng.decode_round()
    for name in arenas:
        cap = ref.state[name].shape[1]
        # the K/V the two packages quantize are fp32 in another summation
        # order (a few ulp apart): an int8 value equals the reference's
        # except where the fp32 value sat on a rounding boundary, one step
        # off (1 of 40,960 in zamba2's shared arena); a scale (amax / 127)
        # equal to a few ulp
        got = eng.state[name][:, :cap].numpy().astype(np.int32)
        want = np.asarray(ref.state[name]).astype(np.int32)
        assert np.abs(got - want).max() <= 1
        assert np.count_nonzero(got != want) <= got.size // 1000
        np.testing.assert_allclose(eng.state[name + "_scale"][:, :cap].numpy(),
                                   np.asarray(ref.state[name + "_scale"]),
                                   rtol=1e-5, atol=0)
