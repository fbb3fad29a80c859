"""The port's training loss and its gradients against the reference's on
the CPU.

For the SMOKE config of every trained family (yi-6b, gemma2-2b with its
window and softcaps, granite-moe-1b with its router aux term,
seamless-m4t-v2's encoder-decoder, internvl2-1b with a frontend,
falcon-mamba-7b's Mamba1 stack and zamba2's Mamba2 + shared block) the
reference draws the weights, ``convert.params_from_numpy`` carries them
across, and the same ``make_batch`` batch goes through the reference's
``jax.value_and_grad`` of ``train_loss`` and the port's ``train_loss``
under ``torch.autograd`` (``tests/_torch_train.py``; internvl2,
falcon-mamba and zamba2 are in ``test_torch_train_archs.py``). Both compute in fp32: the loss agrees within
1e-5 and each gradient leaf within 1e-4 of its own largest entry (the
order of the fp32 sums, over a backward through every layer). The remat
policies and the blocked ``lm_loss`` change memory, not numbers."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import (LOSS_TOL, check_loss_and_grads, port_grads,
                          setup)
from repro.models import transformer as JTF
from repro_torch.models import transformer as TTF


@pytest.mark.parametrize("arch", ["yi-6b", "gemma2-2b",
                                  "granite-moe-1b-a400m",
                                  "seamless-m4t-large-v2"])
def test_train_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-1b-a400m"])
def test_remat_changes_no_number(arch):
    """remat "dots" and "full" give remat "none"'s loss and gradients
    (the recompute runs the same fp32 ops)."""
    _, tcfg, _, tp, _, tb = setup(arch)
    loss0, _, g0 = port_grads(tcfg, tp, tb)
    for remat in ("dots", "full"):
        loss, _, g = port_grads(tcfg, tp, tb, remat=remat)
        assert torch.equal(loss, loss0), remat
        for k in g0:
            assert torch.allclose(g[k], g0[k], rtol=0, atol=1e-6), (remat, k)


@pytest.mark.parametrize("block", [4, 16, 64])
def test_lm_loss_matches_reference_in_blocks(block):
    """The blocked cross entropy (softcap 30, padded vocab masked, a
    partial loss mask) for loss blocks that split the sequence 4, 1 and 1
    ways (64 halves to 16 as in the reference)."""
    jcfg, tcfg, jp, tp, _, _ = setup("gemma2-2b")
    jcfg = dataclasses.replace(jcfg, loss_block=block)
    tcfg = dataclasses.replace(tcfg, loss_block=block)
    rng = np.random.default_rng(block)
    h = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    y = rng.integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
    m = (rng.random((2, 16)) < 0.7).astype(np.float32)
    want = JTF.lm_loss(jp, jcfg, jnp.asarray(h), jnp.asarray(y),
                       jnp.asarray(m))
    got = TTF.lm_loss(tp, tcfg, torch.tensor(h), torch.tensor(y),
                      torch.tensor(m))
    assert abs(float(got) - float(want)) <= LOSS_TOL


@pytest.mark.parametrize("case", ["masked_out_of_range", "in_range"])
def test_lm_loss_takes_out_of_range_labels_as_the_reference(case):
    """yi-6b SMOKE, b 2, s 16: labels -1, -100 and ``padded_vocab`` under
    a zero mask give the reference's loss (its masked sum over the vocab
    ids takes 0 for an id outside it) instead of an out-of-bounds gather;
    in-range labels under a partial mask are unchanged."""
    jcfg, tcfg, jp, tp, _, _ = setup("yi-6b")
    rng = np.random.default_rng(26)
    h = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    y = rng.integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
    m = np.ones((2, 16), np.float32)
    if case == "masked_out_of_range":
        for (i, j), lab in zip([(0, 3), (0, 9), (1, 0), (1, 15)],
                               [-1, -100, tcfg.padded_vocab, -1]):
            y[i, j], m[i, j] = lab, 0.0
    else:
        m[rng.random((2, 16)) < 0.3] = 0.0
    want = JTF.lm_loss(jp, jcfg, jnp.asarray(h), jnp.asarray(y),
                       jnp.asarray(m))
    got = TTF.lm_loss(tp, tcfg, torch.tensor(h), torch.tensor(y),
                      torch.tensor(m))
    assert np.isfinite(float(got))
    assert abs(float(got) - float(want)) <= LOSS_TOL
