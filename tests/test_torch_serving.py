"""The port's paged serving engine against the JAX reference's on the CPU.

Both engines get yi-6b's SMOKE weights (drawn by the reference, carried
across with ``convert.params_from_numpy``) and the same prompts; the
port's kernels take their plain versions on CPU tensors. Greedy tokens
must be equal and logits agree within 1e-4 (fp32; summation order and the
port's write-then-attend island against the reference's self term). The
SQL side must agree exactly: freed-block counts, live blocks and the page
table after every statement."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core import kvpool as JKV
from repro.models import transformer as JTF
from repro.models.params import split
from repro.serving.engine import ServeEngine as JEngine
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.core import kvpool as TKV
from repro_torch.models import transformer as TTF
from repro_torch.serving.engine import ServeEngine as TEngine

LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = JC.get_smoke("yi-6b"), TC.get_smoke("yi-6b")
    jp = split(JTF.init_model(jax.random.PRNGKey(0), jcfg))[0]
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


class Pair:
    """A reference engine and a port engine driven in lockstep."""

    def __init__(self, smoke, **kw):
        jcfg, tcfg, jp, tp = smoke
        self.j = JEngine(jcfg, jp, **kw)
        self.t = TEngine(tcfg, tp, device="cpu", **kw)
        self.j_logits = []
        step = self.j._step

        def capture(*a):  # the reference's decode_round drops its logits
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

    def check_state(self):
        """The arenas' live rows (those the page table names) and the SSM
        states of the slots with a request. Slots without one are not
        compared: the port's island gives 0 there where the reference's
        gives a masked mean, so their (never read) SSM states drift."""
        pt = self.t._pt.numpy()
        rows = np.unique(pt[pt < self.t.cap])
        for name in ("arena", "shared_arena"):
            if name in self.t.state:
                np.testing.assert_allclose(
                    self.t.state[name][:, rows].numpy(),
                    np.asarray(self.j.state[name])[:, rows], atol=LOGIT_ATOL)
        live = sorted(self.t.requests)
        for name, t in self.t.state.get("ssm", {}).items():
            np.testing.assert_allclose(
                t[:, live].numpy(), np.asarray(self.j.state["ssm"][name])
                [:, live], atol=LOGIT_ATOL)

    def add(self, prompt, user_id):
        sj = self.j.add_request(prompt, user_id=user_id)
        st = self.t.add_request(prompt, user_id=user_id)
        assert sj == st
        assert self.t.requests[st].generated == self.j.requests[sj].generated
        self.check_tables()
        return st

    def rounds(self, n):
        for _ in range(n):
            oj = self.j.decode_round()
            ot = self.t.decode_round()
            assert ot == oj
            live = sorted(self.t.requests)
            np.testing.assert_allclose(self.t.logits.numpy()[live],
                                       self.j_logits[-1][live],
                                       atol=LOGIT_ATOL)
            self.check_tables()


def test_engine_matches_reference_engine(smoke):
    jcfg = smoke[0]
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, jcfg.vocab, size=9).astype(np.int32)
    p2 = rng.integers(0, jcfg.vocab, size=15).astype(np.int32)
    p3 = rng.integers(0, jcfg.vocab, size=16).astype(np.int32)
    pr = Pair(smoke, max_slots=4, max_seq=64, block=8)
    s1 = pr.add(p1, 1)
    s2 = pr.add(p2, 2)
    pr.rounds(8)            # both slots cross a block boundary
    assert pr.t.lengths[s1] == 17 and pr.t.lengths[s2] == 23
    # single page: only this request's blocks go
    before = pr.t.live_blocks()
    n = pr.t.finish_request(s1)
    assert n == pr.j.finish_request(s1) == 3
    assert pr.t.live_blocks() == before - n
    pr.check_tables()
    # a new request reuses the freed rows; then the user's session ends
    s3 = pr.add(p3, 2)
    pr.rounds(2)
    n2 = pr.t.evict_user(2)
    assert n2 == pr.j.evict_user(2) == 4 + 3   # 25 and 18 tokens
    assert not pr.t.requests and pr.t.live_blocks() == 0
    pr.check_tables()
    assert s3 not in pr.t.requests
    # flush: the memcached way
    pr.add(p1, 4)
    pr.add(p2, 5)
    pr.rounds(1)
    n3 = pr.t.flush()
    assert n3 == pr.j.flush() == 2 + 2
    assert pr.t.live_blocks() == 0 and not pr.t.requests
    pr.check_tables()


def test_prefill_logits_match_reference(smoke):
    jcfg, tcfg, jp, tp = smoke
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab, 11).astype(
        np.int32)
    eng = TEngine(tcfg, tp, max_slots=2, max_seq=32, block=8, device="cpu")
    eng.add_request(prompt)
    want, _ = JTF.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt[None])})
    np.testing.assert_allclose(eng.prefill_logits.numpy(),
                               np.asarray(want)[0], atol=1e-5)


def test_paged_engine_matches_its_own_dense_decode(smoke):
    """As tests/test_serving_engine.py does for the reference: the paged
    decode generates the dense-cache path's tokens."""
    _, tcfg, _, tp = smoke
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab, 13).astype(
        np.int32)
    n_new = 6
    logits, cache = TTF.prefill(tp, tcfg,
                                {"tokens": torch.from_numpy(prompt[None])})
    dc = TTF.init_cache(tcfg, 1, 13 + n_new + 8, "cpu")
    dc["k"][:, :, :13] = cache["k"]
    dc["v"][:, :, :13] = cache["v"]
    toks = [int(torch.argmax(logits[0]))]
    lengths = torch.tensor([13])
    for _ in range(n_new - 1):
        lg, dc = TTF.decode_step(tp, tcfg, torch.tensor([toks[-1]]), dc,
                                 lengths)
        toks.append(int(torch.argmax(lg[0])))
        lengths = lengths + 1
    eng = TEngine(tcfg, tp, max_slots=4, max_seq=64, block=8, device="cpu")
    slot = eng.add_request(prompt, user_id=7)
    for _ in range(n_new - 1):
        eng.decode_round()
    assert eng.requests[slot].generated == toks


@pytest.mark.parametrize("block", [1, 4, 16])
def test_rolling_prefix_hashes_wrap_like_uint32(block):
    rng = np.random.default_rng(block)
    toks = np.concatenate([
        np.array([2**31 - 1, -2**31, 2**31 - 2, -1, 0, 2**31 - 7], np.int32),
        rng.integers(-2**31, 2**31, 42, dtype=np.int64).astype(np.int32)])
    want = np.asarray(JKV.rolling_prefix_hashes(jnp.asarray(toks), block))
    got = TKV.rolling_prefix_hashes(torch.from_numpy(toks), block)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_page_table_rebuild_and_increments_match_reference(smoke):
    """The port's page-table maintenance against the reference's on the
    same table contents: a bulk build, an incremental insert and the
    rebuild after an evicting insert."""
    from repro.core.daemon import SQLCached as JDB
    from repro_torch.core.daemon import SQLCached as TDB
    sql = ("CREATE TABLE kv (slot INT, seq_id INT, user_id INT, pos_block "
           "INT, prefix_hash INT) CAPACITY 12 MAX_SELECT 16")
    ins = ("INSERT INTO kv (slot, seq_id, user_id, pos_block, prefix_hash) "
           "VALUES (?, ?, ?, ?, ?)")
    jdb, tdb = JDB(), TDB(device="cpu")
    jdb.execute(sql)
    tdb.execute(sql)
    kw = dict(max_slots=3, max_blocks=4)
    jpt = jnp.full((3, 4), 12, jnp.int32)
    tpt = torch.full((3, 4), 12, dtype=torch.int32)
    batches = [[(0, 1, 1, b, 0) for b in range(3)],
               [(1, 2, 1, b, 0) for b in range(4)] + [(2, 3, 2, 0, 0)],
               [(2, 3, 2, b, 0) for b in range(1, 4)],
               [(0, 4, 3, 3, 0), (1, 5, 3, 0, 0)]]      # 13 rows in 12
    for rows in batches:
        rj, rt = jdb.executemany(ins, rows), tdb.executemany(ins, rows)
        n = len(rows)
        jpt = JKV.page_table_insert(jdb.schema("kv"), jdb.table_state("kv"),
                                    jpt, rj.row_ids_device[:n],
                                    rj.value_device, **kw)
        tpt = TKV.page_table_insert(tdb.schema("kv"), tdb.table_state("kv"),
                                    tpt, rt.row_ids_device[:n],
                                    rt.value_device, **kw)
        np.testing.assert_array_equal(tpt.numpy(), np.asarray(jpt))
    assert int(rt.value) == 1  # the last batch evicted a live row
    full = TKV.page_table(tdb.schema("kv"), tdb.table_state("kv"), **kw)
    np.testing.assert_array_equal(full.numpy(), tpt.numpy())


def test_engine_admits_a_prompt_whose_block_bucket_exceeds_capacity(smoke):
    """One slot of max_seq 160 at block 16 gives the kv table CAPACITY 12;
    a 150-token prompt takes 10 blocks (bucket 16). The port admits it and
    generates what the reference engine generates with two slots (whose
    table, CAPACITY 25, fits the bucket)."""
    jcfg, tcfg, jp, tp = smoke
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab, 150).astype(
        np.int32)
    eng = TEngine(tcfg, tp, max_slots=1, max_seq=160, block=16, device="cpu")
    assert eng.cap == 12
    ref = JEngine(jcfg, jp, max_slots=2, max_seq=160, block=16)
    slot = eng.add_request(prompt, user_id=1)
    rslot = ref.add_request(prompt, user_id=1)
    assert eng.live_blocks() == ref.live_blocks() == 10
    for _ in range(3):
        eng.decode_round()
        ref.decode_round()
    assert eng.requests[slot].generated == ref.requests[rslot].generated
    assert eng.live_blocks() == ref.live_blocks() == 10
    assert eng.finish_request(slot) == 10 and eng.live_blocks() == 0


@pytest.fixture(scope="module")
def zamba():
    """zamba2 SMOKE, drawn by the reference and carried across, with
    A_log, D and dt_bias made nonzero."""
    jcfg, tcfg = JC.get_smoke("zamba2-2.7b"), TC.get_smoke("zamba2-2.7b")
    jp = split(JTF.init_model(jax.random.PRNGKey(0), jcfg))[0]
    rng = np.random.default_rng(5)
    for name in ("A_log", "D", "dt_bias"):
        leaf = jp["layers"]["mamba"][name]
        jp["layers"]["mamba"][name] = jnp.asarray(
            rng.standard_normal(leaf.shape) * 0.5, jnp.float32)
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def test_zamba2_engine_matches_reference_engine(zamba):
    """The hybrid through both engines in lockstep: Mamba2 states in the
    slots, the shared block's KV in the shared arena. Two prompts are
    longer than ssm_chunk = 8."""
    jcfg = zamba[0]
    rng = np.random.default_rng(3)
    p1, p2, p3 = (rng.integers(0, jcfg.vocab, size=n).astype(np.int32)
                  for n in (9, 21, 6))
    pr = Pair(zamba, max_slots=4, max_seq=64, block=8)
    s1 = pr.add(p1, 1)
    s2 = pr.add(p2, 2)
    pr.check_state()
    pr.rounds(8)            # both slots cross a block boundary
    pr.check_state()
    assert pr.t.lengths[s1] == 17 and pr.t.lengths[s2] == 29
    n = pr.t.finish_request(s1)
    assert n == pr.j.finish_request(s1) == 3
    pr.check_tables()
    s3 = pr.add(p3, 2)
    pr.rounds(3)
    pr.check_state()
    n2 = pr.t.evict_user(2)
    assert n2 == pr.j.evict_user(2) == 4 + 2   # 32 and 9 tokens
    assert not pr.t.requests and pr.t.live_blocks() == 0
    pr.check_tables()
    assert s3 not in pr.t.requests
    pr.add(p2, 4)
    pr.rounds(1)
    pr.check_state()
    n3 = pr.t.flush()
    assert n3 == pr.j.flush() == 3
    assert pr.t.live_blocks() == 0 and not pr.t.requests
    pr.check_tables()


def test_engine_defaults_to_the_card(zamba):
    """``device=None`` means the CUDA card: without one the engine raises
    (no fall-back to the CPU)."""
    tcfg, tp = zamba[1], zamba[3]
    if torch.cuda.is_available():
        eng = TEngine(tcfg, _to(tp, "cuda"), max_slots=2, max_seq=32,
                      block=8)
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TEngine(tcfg, tp, max_slots=2, max_seq=32, block=8)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
