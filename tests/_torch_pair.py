"""Helpers of the port's model parity tests (``test_torch_moe.py``,
``test_torch_encdec.py``, ``test_torch_internvl2.py``): the reference's
SMOKE weights carried across, the config check, and a reference engine
and a port engine driven in lockstep. Not a test module itself."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as JC
from repro.models import transformer as JTF
from repro.models.params import split
from repro.serving.engine import ServeEngine as JEngine
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.serving.engine import ServeEngine as TEngine

LOGIT_ATOL = 1e-4


def smoke_weights(arch):
    """(reference cfg, port cfg, reference params, port params): the
    reference's SMOKE weights from ``init_model(PRNGKey(0))``, carried
    across with ``convert.params_from_numpy``."""
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jp = split(JTF.init_model(jax.random.PRNGKey(0), jcfg))[0]
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def check_config(arch):
    """The port's CONFIG and SMOKE equal the reference's field for field
    (the dtype by name), and the arch is served."""
    mod = TC.ARCHS[arch]
    for name in ("CONFIG", "SMOKE"):
        j = getattr(__import__(f"repro.configs.{mod}", fromlist=[name]), name)
        t = getattr(__import__(f"repro_torch.configs.{mod}",
                               fromlist=[name]), name)
        for f in dataclasses.fields(j):
            if f.name != "dtype":
                assert getattr(j, f.name) == getattr(t, f.name), f.name
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name
        for f in ("padded_vocab", "attn_layer_ids", "is_moe", "is_encdec"):
            assert getattr(j, f) == getattr(t, f), f
        assert j.param_count() == t.param_count()
    assert arch in TC.PORTED


def check_layout(w, init_model):
    """The port's seeded init has the reference's leaves, shapes and
    dtypes."""
    jcfg, tcfg, jp, _ = w
    ours = leaves(init_model(torch.Generator().manual_seed(0), tcfg, "cpu"))
    theirs = leaves(jp)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert tuple(ours[k].shape) == tuple(v.shape), k
        assert ours[k].dtype == tcfg.dtype, k
    return ours


class Pair:
    """A reference engine and a port engine driven in lockstep; the
    reference's round logits are captured from its step. Every admission
    and round must give equal tokens, logits within ``LOGIT_ATOL`` and
    equal block counts, page tables and tail rows."""

    def __init__(self, w, **kw):
        jcfg, tcfg, jp, tp = w
        self.j = JEngine(jcfg, jp, **kw)
        self.t = TEngine(tcfg, tp, device="cpu", **kw)
        self.j_logits = []
        step = self.j._step

        def capture(*a):
            out = step(*a)
            self.j_logits.append(np.asarray(out[2]))
            return out
        self.j._step = capture

    def check_tables(self):
        assert self.t.live_blocks() == self.j.live_blocks()
        np.testing.assert_array_equal(self.t._pt.numpy(),
                                      np.asarray(self.j._pt))
        np.testing.assert_array_equal(self.t.tail_row.numpy(),
                                      np.asarray(self.j.tail_row))

    def check_columns(self, *names):
        """The ``kv`` table's columns ``names`` and validity, row by row."""
        ts, js = (e.daemon.table_state("kv") for e in (self.t, self.j))
        np.testing.assert_array_equal(ts["valid"].numpy(),
                                      np.asarray(js["valid"]))
        for n in names:
            np.testing.assert_array_equal(ts["cols"][n].numpy(),
                                          np.asarray(js["cols"][n]), n)

    def add(self, prompt, user_id, extras=None):
        sj = self.j.add_request(prompt, user_id=user_id, extras=extras)
        st = self.t.add_request(prompt, user_id=user_id, extras=extras)
        assert sj == st
        assert self.t.requests[st].generated == self.j.requests[sj].generated
        assert self.t.lengths[st] == self.j.lengths[sj]
        self.check_tables()
        return st

    def rounds(self, n):
        for _ in range(n):
            assert self.t.decode_round() == self.j.decode_round()
            live = sorted(self.t.requests)
            np.testing.assert_allclose(self.t.logits.numpy()[live],
                                       self.j_logits[-1][live],
                                       atol=LOGIT_ATOL)
            self.check_tables()

    def check_arena(self):
        """The arena's live rows: the roped K and the V each engine
        wrote."""
        pt = self.t._pt.numpy()
        rows = np.unique(pt[pt < self.t.cap])
        np.testing.assert_allclose(self.t.state["arena"][:, rows].numpy(),
                                   np.asarray(self.j.state["arena"])[:, rows],
                                   atol=LOGIT_ATOL)


def engine_stream(w, extras=None, **kw):
    """Both engines through one stream: two prompts, 8 rounds (both
    cross a block boundary of 8), finish_request, a third prompt (of the
    first one's length: no new shape for the reference to compile) into
    the freed rows, 2 rounds, evict_user, re-admission, 1 round, flush;
    equal counts throughout (``pair.counts``: the blocks freed by each of
    the three). ``extras(i)``: the i-th admission's extras. Returns the
    pair."""
    rng = np.random.default_rng(3)
    p1, p2, p3 = (rng.integers(0, w[0].vocab, size=n).astype(np.int32)
                  for n in (9, 15, 9))
    ex = extras or (lambda i: None)
    pr = Pair(w, max_slots=4, max_seq=kw.pop("max_seq", 64), block=8, **kw)
    s1 = pr.add(p1, 1, ex(0))
    pr.add(p2, 2, ex(1))
    pr.rounds(8)
    pr.check_arena()
    n1 = pr.t.finish_request(s1)
    assert n1 == pr.j.finish_request(s1)
    pr.check_tables()
    pr.add(p3, 2, ex(2))
    pr.rounds(2)
    n2 = pr.t.evict_user(2)
    assert n2 == pr.j.evict_user(2)
    assert not pr.t.requests and pr.t.live_blocks() == 0
    pr.check_tables()
    pr.add(p1, 4, ex(3))
    pr.rounds(1)
    n3 = pr.t.flush()
    assert n3 == pr.j.flush()
    assert pr.t.live_blocks() == 0
    pr.check_tables()
    pr.counts = (n1, n2, n3)   # blocks freed by finish, evict and flush
    return pr
