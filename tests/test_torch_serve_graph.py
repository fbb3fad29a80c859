"""The port's decode round over static buffers (``ServeGraph``,
``serve_input_specs``, ``lower_serve_step``) against the JAX reference on
the CPU, for yi-6b's and zamba2's SMOKE configs.

The engine runs every round on the same static buffers that the card
captures in a CUDA graph (on the CPU the round's body runs eagerly): its
page table, tail rows, staged inputs and state keep their addresses over a
stream of admissions into freed slots, block-boundary rounds,
``finish_request``, ``evict_user``, ``flush`` and re-admission, while its
greedy tokens equal the reference engine's and its logits agree within
1e-4 (fp32; summation order and the port's write-then-attend island). The
input specs equal the reference's ShapeDtypeStructs without a mesh, and
``lower_serve_step`` reports the reference's paged geometry."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.shapes import ShapeSpec
from repro.models import transformer as JTF
from repro.models.params import split
from repro.serving import engine as JE
from repro.serving.paged import plan_geometry as j_plan
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.serving import engine as TE
from repro_torch.serving.paged import plan_geometry as t_plan

LOGIT_ATOL = 1e-4
ARCHS = ["yi-6b", "zamba2-2.7b"]


@functools.lru_cache(maxsize=None)
def weights(arch):
    """SMOKE weights drawn by the reference and carried across (zamba2's
    A_log, D and dt_bias made nonzero)."""
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jp = split(JTF.init_model(jax.random.PRNGKey(0), jcfg))[0]
    if "mamba" in jp["layers"]:
        rng = np.random.default_rng(5)
        for name in ("A_log", "D", "dt_bias"):
            leaf = jp["layers"]["mamba"][name]
            jp["layers"]["mamba"][name] = jnp.asarray(
                rng.standard_normal(leaf.shape) * 0.5, jnp.float32)
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _addresses(eng):
    leaves = [eng._pt, eng.tail_row, eng._step.vec]
    for v in eng.state.values():
        leaves += list(v.values()) if isinstance(v, dict) else [v]
    return [t.data_ptr() for t in leaves]


@pytest.mark.parametrize("arch", ARCHS)
def test_static_buffer_engine_matches_reference_engine(arch):
    jcfg, tcfg, jp, tp = weights(arch)
    kw = dict(max_slots=4, max_seq=64, block=8)
    ref = JE.ServeEngine(jcfg, jp, **kw)
    eng = TE.ServeEngine(tcfg, tp, device="cpu", **kw)
    ref_logits = []
    step = ref._step

    def keep_logits(*a):  # the reference's decode_round drops its logits
        out = step(*a)
        ref_logits.append(np.asarray(out[2]))
        return out
    ref._step = keep_logits
    addresses = _addresses(eng)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (7, 12, 16, 5, 9)]

    def add(i, user):
        assert (eng.add_request(prompts[i], user_id=user)
                == ref.add_request(prompts[i], user_id=user))

    def rounds(n):
        for _ in range(n):
            assert eng.decode_round() == ref.decode_round()
            live = sorted(eng.requests)
            np.testing.assert_allclose(eng.logits.numpy()[live],
                                       ref_logits[-1][live], atol=LOGIT_ATOL)
            np.testing.assert_array_equal(eng._pt.numpy(),
                                          np.asarray(ref._pt))
            np.testing.assert_array_equal(eng.tail_row.numpy(),
                                          np.asarray(ref.tail_row))
            assert eng.live_blocks() == ref.live_blocks()

    add(0, 1)
    add(1, 2)
    add(2, 1)           # 16 tokens: its first round opens a block
    rounds(2)           # the 7-token prompt crosses into its second block
    kept = eng.logits
    before = kept.clone()
    rounds(1)
    assert torch.equal(kept, before)   # a round's logits outlive the next
    assert eng.finish_request(1) == ref.finish_request(1)
    add(3, 3)           # into the freed slot
    rounds(2)
    assert eng.evict_user(1) == ref.evict_user(1)
    add(4, 3)           # into a slot the eviction freed
    rounds(1)
    assert eng.flush() == ref.flush()
    assert eng.live_blocks() == 0 and not eng.requests
    add(0, 4)           # re-admission after the flush
    add(1, 4)
    rounds(2)
    assert _addresses(eng) == addresses


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch,seq_len,block", [(4, 64, 8), (3, 100, 16),
                                                 (1, 512, 256)])
def test_serve_input_specs_match_reference(arch, batch, seq_len, block):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    geo = dict(batch=batch, seq_len=seq_len, kv_heads=tcfg.n_kv_heads,
               head_dim=tcfg.head_dim, q_heads=tcfg.n_heads, block=block)
    want, _ = JE.serve_input_specs(jcfg, j_plan(mesh=None, **geo), None)
    got = TE.serve_input_specs(tcfg, t_plan(**geo))
    assert set(got) == set(want)
    for name, sds in want.items():
        shape, dtype = got[name]
        assert shape == sds.shape, name
        assert torch.empty(0, dtype=dtype).numpy().dtype == sds.dtype, name
    # a mesh is ported (tests/test_torch_serve_mesh.py): only a Mesh
    with pytest.raises(TypeError):
        TE.serve_input_specs(tcfg, t_plan(**geo), mesh=object())


@pytest.mark.parametrize("arch", ARCHS)
def test_lower_serve_step_on_the_cpu(arch):
    """The reference's dry-run geometry (its ``lower_serve_step`` reports
    ``plan_geometry``'s without a mesh); the CPU step runs its body on
    zeroed state and idle slots."""
    jcfg, tcfg, _, tp = weights(arch)
    shape = ShapeSpec("decode_small", 512, 3, "decode")
    with pytest.raises(TypeError):   # a mesh must be a launch.mesh.Mesh
        TE.lower_serve_step(tcfg, shape, tp, mesh=object(), device="cpu")
    step, extra = TE.lower_serve_step(tcfg, shape, tp, device="cpu")
    g = j_plan(batch=shape.global_batch, seq_len=shape.seq_len,
               kv_heads=jcfg.n_kv_heads, head_dim=jcfg.head_dim,
               q_heads=jcfg.n_heads, mesh=None)
    assert extra["paged_geom"] == {
        "block": g.block, "nblk": g.nblk, "cap": g.cap,
        "batch_axes": g.batch_axes, "head_axes": g.head_axes,
        "stripe_axes": g.stripe_axes}
    specs = TE.serve_input_specs(tcfg, t_plan(
        batch=3, seq_len=512, kv_heads=tcfg.n_kv_heads,
        head_dim=tcfg.head_dim, q_heads=tcfg.n_heads))
    assert {k: (tuple(v.shape), v.dtype)
            for k, v in step.inputs.items()} == specs
    nxt, logits = step(np.zeros((3, 3), np.int32))
    assert nxt.shape == (3,) and logits.shape == (3, tcfg.padded_vocab)
    assert bool(torch.isfinite(logits[:, :tcfg.vocab]).all())
