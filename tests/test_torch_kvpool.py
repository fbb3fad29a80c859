"""The port's KV-block pool (``repro_torch.core.kvpool``) against the
reference's, on the CPU: one case for each test of
``tests/test_core_kvpool.py``, plus one on a pool with hash indexes.

Each case is a list of operations that runs through both packages from
the same seeded numpy inputs (KV payloads drawn from a generator). After
every operation the outputs must be equal: row ids, eviction counts,
DELETE counts and reported ids, page tables and length vectors (kept
incrementally and rebuilt), gathered blocks, ``find_prefix`` results,
rolling hashes, and the whole pool state. Index lanes compare as
per-bucket entry sets (the batched upkeep may place entries in other
lanes); every other leaf exactly. The port's incremental page table and
lengths must also equal its own rebuilds, as the reference's tests ask of
the reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvpool as JKV
from repro.core import predicate as JP
from repro.core import table as JT
from repro.kernels import hashidx as JH
from repro_torch import convert as CV
from repro_torch.core import kvpool as TKV
from repro_torch.core import predicate as TP
from repro_torch.core import table as TT
from repro_torch.kernels import hashidx as TH

LAYERS, BLOCK, KVH, HD = 2, 4, 2, 8
SLOTS, NBLK = 4, 8


class Side:
    """One package's pool, with its incremental page table and lengths."""

    def __init__(self, jax_side: bool, capacity: int, indexes: tuple):
        self.j = jax_side
        self.KV = JKV if jax_side else TKV
        kw = dict(layers=LAYERS, block_size=BLOCK, kv_heads=KVH,
                  head_dim=HD, capacity=capacity, indexes=indexes)
        if jax_side:
            self.sch = JKV.kv_schema(dtype=jnp.float32, **kw)
            self.state = JKV.init_pool(self.sch)
        else:
            self.sch = TKV.kv_schema(dtype=torch.float32, **kw)
            self.state = TKV.init_pool(self.sch, "cpu")
        self.pt = self.arr(np.full((SLOTS, NBLK), capacity, np.int32))
        self.lens = self.arr(np.zeros(SLOTS, np.int32))

    def arr(self, a: np.ndarray):
        return jnp.asarray(a) if self.j else torch.from_numpy(a.copy())

    def rebuilt(self):
        return (self.KV.page_table(self.sch, self.state, max_slots=SLOTS,
                                   max_blocks=NBLK),
                self.KV.seq_lengths(self.sch, self.state, max_slots=SLOTS,
                                    block_size=BLOCK))

    def run(self, op):
        """Apply one operation; returns what it observed (host values)."""
        kind, a = op[0], op[1:]
        KV, sch = self.KV, self.sch
        grid = dict(max_slots=SLOTS, max_blocks=NBLK)
        lens_kw = dict(block_size=BLOCK, max_slots=SLOTS)
        if kind == "append":
            cols, kv, row_mask, ttl = a
            self.state, rows, ev = KV.append_blocks(
                sch, self.state, **{k: self.arr(v) for k, v in cols.items()},
                kv=self.arr(kv),
                row_mask=None if row_mask is None else self.arr(row_mask),
                ttl=ttl)
            self.pt = KV.page_table_insert(sch, self.state, self.pt, rows,
                                           ev, **grid)
            self.lens = KV.seq_lengths_insert(sch, self.state, self.lens,
                                              rows, ev, **lens_kw)
            return {"rows": rows, "evicted": ev, "pt": self.pt,
                    "lens": self.lens, "rebuilt": self.rebuilt()}
        if kind in ("delete_seq", "delete_user"):
            self.state, n = getattr(KV, kind)(sch, self.state, a[0])
            return {"n": n, "rebuilt": self.rebuilt()}
        if kind == "delete_returning":
            P, T = (JP, JT) if self.j else (TP, TT)
            self.state, n, ids, present = T.delete_returning(
                sch, self.state, P.BinOp("=", P.Col(a[0]), P.Param(0)),
                (a[1],))
            self.pt = KV.page_table_delete(sch, self.state, self.pt, ids,
                                           present, **grid)
            self.lens = KV.seq_lengths_delete(sch, self.state, self.lens,
                                              ids, present, **lens_kw)
            return {"n": n, "ids": ids, "present": present, "pt": self.pt,
                    "lens": self.lens, "rebuilt": self.rebuilt()}
        if kind == "page_table":
            return KV.page_table(sch, self.state, max_slots=a[0],
                                 max_blocks=a[1])
        if kind == "gather":
            pt = KV.page_table(sch, self.state, max_slots=a[0],
                               max_blocks=a[1])
            return KV.gather_blocks(self.state, pt)
        if kind == "find_prefix":
            self.state, res = KV.find_prefix(sch, self.state, a[0],
                                             limit=a[1])
            return res
        if kind == "live":
            return (JT if self.j else TT).live_count(self.state)
        if kind == "hashes":
            return KV.rolling_prefix_hashes(self.arr(a[0]), BLOCK)
        raise ValueError(kind)


def host(tree):
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def assert_same(want, got, path="", valid=None):
    """Equal trees; an index's lanes as per-bucket live entry sets."""
    if isinstance(want, dict):
        assert set(want) == set(got), path
        if path.startswith("/indexes/") and "rid" in want:
            for b, (rj, kj, rt, kt) in enumerate(zip(
                    want["rid"], want["key"], got["rid"], got["key"])):
                sj = {(r, k) for r, k in zip(rj, kj)
                      if r != JH.EMPTY and valid[r]}
                st = {(r, k) for r, k in zip(rt, kt)
                      if r != TH.EMPTY and valid[r]}
                assert sj == st, f"{path} bucket {b}"
            np.testing.assert_array_equal(want["stale"], got["stale"],
                                          err_msg=path)
            return
        for k in want:
            assert_same(want[k], got[k], f"{path}/{k}", valid)
    elif isinstance(want, list):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_same(w, g, f"{path}[{i}]", valid)
    else:
        np.testing.assert_array_equal(want, got, err_msg=path)


def append(rng, slot, seq, user, pos, hashes=None, row_mask=None, ttl=0):
    """An append of len(slot) blocks with seeded KV payloads; ``seq`` and
    ``user`` are one value or one a block."""
    n = len(slot)
    c = {"slot": slot, "seq_id": np.broadcast_to(seq, (n,)),
         "user_id": np.broadcast_to(user, (n,)), "pos_block": pos,
         "prefix_hash": np.zeros(n) if hashes is None else hashes}
    kv = rng.standard_normal((n, LAYERS, 2, BLOCK, KVH, HD)).astype(
        np.float32)
    return ("append", {k: np.array(v, np.int32) for k, v in c.items()}, kv,
            row_mask, ttl)


def _hashes(toks):
    return np.asarray(JKV.rolling_prefix_hashes(jnp.asarray(toks), BLOCK))


def _case(name, rng):
    """The operations of one case (``tests/test_core_kvpool.py``'s test of
    the same name, or the indexed pool)."""
    a = lambda *x, **k: append(rng, *x, **k)  # noqa: E731
    if name == "page_table_layout":
        return [a([0, 0, 0], 100, 7, [0, 1, 2]), a([2], 200, 8, [0]),
                ("page_table", 4, 8)]
    if name == "seq_lengths":
        return [a([0, 0, 1], 1, 1, [0, 1, 0])]
    if name == "gather_masks_sentinel":   # every row filled, the last too
        return [a([0], 1, 1, [0]), a([0, 1], 1, 1, [1, 0]), a([3], 2, 2, [0]),
                ("gather", 2, 2), ("gather", 4, 8)]
    if name == "delete_seq_fine_grained":
        return [a([0, 0], 100, 7, [0, 1]), a([1, 1], 200, 7, [0, 1]),
                ("delete_seq", 100), ("page_table", 2, 4)]
    if name == "delete_user_fine_grained":
        return [a([0], 100, 7, [0]), a([1], 200, 7, [0]),
                a([2], 300, 9, [0]), ("delete_user", 7), ("live",)]
    if name == "prefix_hash_deterministic_and_prefix_stable":
        toks = np.arange(16, dtype=np.int32)
        toks2 = toks.copy()
        toks2[10] = 999
        return [("hashes", toks), ("hashes", toks), ("hashes", toks2)]
    if name == "find_prefix_lookup":
        h = _hashes(np.arange(8, dtype=np.int32))
        return [a([0, 0], 1, 1, [0, 1], h), ("find_prefix", int(h[1]), 64),
                ("find_prefix", int(h[0]), 1), ("find_prefix", 12345, 64)]
    if name == "page_table_insert_incremental_matches_rebuild":
        return [a([0, 0], 100, 7, [0, 1]), a([2], 200, 7, [0]),
                a([0], 100, 7, [2])]
    if name == "page_table_insert_eviction_triggers_rebuild":
        return [a([0, 0, 0, 0], 1, 1, [0, 1, 2, 3]), a([1, 1], 1, 1, [0, 1])]
    if name == "page_table_delete_incremental_matches_rebuild":
        return [a([0, 0, 1, 2], [100, 100, 200, 300], [7, 7, 7, 9],
                  [0, 1, 0, 0]),
                ("delete_returning", "seq_id", 100)]
    if name == "indexed_pool":
        toks = rng.integers(0, 50, 16).astype(np.int32)
        h = _hashes(toks)
        return [a([0, 0, 0, 0], 10, 3, [0, 1, 2, 3], h),
                a([1, 1, 2], [11, 11, 12], [3, 3, 4], [0, 1, 0], h[:3],
                  row_mask=np.array([True, False, True]), ttl=5),
                ("find_prefix", int(h[1]), 64), ("delete_seq", 11),
                ("delete_returning", "user_id", 4), ("delete_user", 3),
                a([3], 13, 5, [0], h[:1]), ("find_prefix", int(h[0]), 64),
                ("live",)]
    raise ValueError(name)


CASES = {  # name: (capacity, indexes)
    "page_table_layout": (32, ()),
    "seq_lengths": (32, ()),
    "gather_masks_sentinel": (4, ()),
    "delete_seq_fine_grained": (32, ()),
    "delete_user_fine_grained": (32, ()),
    "prefix_hash_deterministic_and_prefix_stable": (32, ()),
    "find_prefix_lookup": (32, ()),
    "page_table_insert_incremental_matches_rebuild": (32, ()),
    "page_table_insert_eviction_triggers_rebuild": (4, ()),
    "page_table_delete_incremental_matches_rebuild": (32, ()),
    "indexed_pool": (48, ("seq_id", "user_id", "prefix_hash")),
}


@pytest.mark.parametrize("name", list(CASES))
def test_kvpool_matches_reference(name):
    capacity, indexes = CASES[name]
    sides = [Side(True, capacity, indexes), Side(False, capacity, indexes)]
    ops = _case(name, np.random.default_rng(sorted(CASES).index(name)))
    # an append with a row mask reports rows it did not write (in both
    # packages), so the incremental tables no longer equal the rebuilds
    masked = any(op[0] == "append" and op[3] is not None for op in ops)
    evicted = 0
    for op in ops:
        want, got = (host(s.run(op)) for s in sides)
        assert_same(want, got, op[0])
        if op[0] in ("append", "delete_returning") and not masked:
            # incremental = rebuilt, in each package
            for obs in (want, got):
                np.testing.assert_array_equal(obs["pt"], obs["rebuilt"][0])
                np.testing.assert_array_equal(obs["lens"], obs["rebuilt"][1])
        if op[0] == "append":
            evicted += int(got["evicted"])
        valid = CV.state_to_numpy(sides[1].state)["valid"]
        assert_same(jax.tree.map(np.asarray, sides[0].state),
                    CV.state_to_numpy(sides[1].state), valid=valid)
    if name == "page_table_insert_eviction_triggers_rebuild":
        assert evicted > 0   # the rebuild branch ran
