"""The port's vision-frontend decoder (internvl2-1b: precomputed patch
embeddings placed before the prompt, 14 / 2 heads) against the JAX
reference on the CPU.

internvl2's SMOKE weights are drawn by the reference and carried across;
the same seeded numpy embeddings and tokens go through both packages.
fp32: the prefill's logits and KV over frontend + prompt positions within
1e-5, and the prompt alone (no ``frontend`` in the batch) too. Then 8
rounds of both serving engines in lockstep with a ``frontend`` on every
request (as the reference's ``test_serving_engine.py`` draws them, × 0.02):
equal greedy tokens, logits within 1e-4, equal block counts, page tables
and sequence lengths (frontend_len + prompt), and the ``kv`` table's
``pos_block`` and ``prefix_hash`` columns equal row by row: the reference
hashes the prompt's tokens alone, zero-padded to the blocks of the whole
sequence, and only for a prompt of a block or more."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import Pair, check_config, check_layout, smoke_weights
from repro.models import transformer as JTF
from repro_torch.launch import serve as TSERVE
from repro_torch.models import transformer as TTF

ARCH = "internvl2-1b"
ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def weights():
    return smoke_weights(ARCH)


def _frontend(cfg, rng, b=None):
    shape = ((b,) if b else ()) + (cfg.frontend_len, cfg.d_model)
    return rng.standard_normal(shape).astype(np.float32) * 0.02


def test_config_matches_reference():
    check_config(ARCH)
    check_layout(weights(), TTF.init_model)


@pytest.mark.parametrize("with_frontend", [True, False])
def test_prefill_matches_reference(with_frontend):
    """Prefill of 10 tokens after 8 frontend positions (or without them):
    logits, and the KV of every position."""
    jcfg, tcfg, jp, tp = weights()
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab, (2, 10)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if with_frontend:
        fe = _frontend(tcfg, rng, 2)
        jb["frontend"], tb["frontend"] = jnp.asarray(fe), torch.from_numpy(fe)
    jl, jc = jax.jit(JTF.prefill, static_argnums=1)(jp, jcfg, jb)
    tl, tc = TTF.prefill(tp, tcfg, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    total = 10 + (tcfg.frontend_len if with_frontend else 0)
    for nm in ("k", "v"):
        assert tc[nm].shape[2] == total
        np.testing.assert_allclose(tc[nm].numpy(), np.asarray(jc[nm]),
                                   atol=ATOL)


def test_engine_matches_reference_engine():
    """Prompts of 9, 15, 16 and 7 tokens, each after 8 frontend positions
    (17, 23, 24 and 15 positions: blocks of 8 cross within the frontend
    and the prompt), 8 rounds, finish_request, evict_user and flush, with
    the ``kv`` table's columns compared after each admission and at the
    end: the prompts of 9, 15 and 16 tokens carry prefix hashes over 3
    blocks of the padded prompt, the one of 7 none."""
    w = weights()
    cfg = w[1]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (9, 15, 16, 7)]
    fes = [_frontend(cfg, rng) for _ in prompts]
    pr = Pair(w, max_slots=4, max_seq=64, block=8)
    cols = ("slot", "seq_id", "user_id", "pos_block", "prefix_hash")
    slots = []
    for i, (p, fe) in enumerate(zip(prompts, fes)):
        slots.append(pr.add(p, i % 2, {"frontend": fe}))
        assert pr.t.lengths[slots[-1]] == cfg.frontend_len + len(p)
        pr.check_columns(*cols)
    hashes = pr.t.daemon.table_state("kv")["cols"]["prefix_hash"]
    assert int((hashes != 0).sum()) == 9
    pr.rounds(8)
    pr.check_arena()
    pr.check_columns(*cols)
    assert pr.t.finish_request(slots[1]) == pr.j.finish_request(slots[1]) \
        == 4   # 23 + 8 positions
    pr.check_columns(*cols)
    pr.add(prompts[0], 3, {"frontend": fes[0]})
    pr.rounds(2)
    assert pr.t.evict_user(0) == pr.j.evict_user(0)
    pr.check_columns(*cols)
    assert pr.t.flush() == pr.j.flush()
    pr.check_columns(*cols)


def test_launcher_serves_text_prompts():
    """The launcher's default traffic, text prompts with no frontend, as
    the reference's launcher sends them (6 requests of 16 tokens)."""
    TSERVE.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
