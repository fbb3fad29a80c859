"""Shared set-up of the port's training parity tests: the reference's
SMOKE weights carried across, one ``make_batch`` batch in both packages,
and the port's loss and gradients under autograd."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as JC
from repro.data.synthetic import make_batch
from repro.models import transformer as JTF
from repro.models.params import split
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import transformer as TTF
from repro_torch.optim.adamw import tree_leaves

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def setup(arch, batch=2, seq=16, seed=5):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jp = split(JTF.init_model(jax.random.PRNGKey(1), jcfg))[0]
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    nb = make_batch(jcfg, batch, seq, seed=seed, step=3)
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    return jcfg, tcfg, jp, tp, nb, tb


def port_grads(tcfg, tp, tb, remat="none"):
    flat = tree_leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = TTF.train_loss(tp, tcfg, tb, remat=remat)
    grads = torch.autograd.grad(loss, flat)
    for p in flat:
        p.requires_grad_(False)
    named = dict(zip(leaves(tp), grads))
    return loss.detach(), metrics, named




def check_loss_and_grads(arch):
    """The port's train_loss and every gradient leaf against the
    reference's ``jax.value_and_grad`` on one batch."""
    jcfg, tcfg, jp, tp, nb, tb = setup(arch)

    def f(p, b):
        return JTF.train_loss(p, jcfg, b)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jp, jax.tree.map(jnp.asarray, nb))
    loss, metrics, grads = port_grads(tcfg, tp, tb)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    assert abs(float(metrics["ce"].detach()) - float(jm["ce"])) <= LOSS_TOL
    if tcfg.is_moe:
        assert abs(float(metrics["aux"].detach()) - float(jm["aux"])) \
            <= LOSS_TOL
    want = leaves(jax.tree.map(np.asarray, jg))
    assert sorted(want) == sorted(grads)
    for name, w in want.items():
        g = grads[name].float().numpy()
        top = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g - w).max()) <= GRAD_TOL * top, name
