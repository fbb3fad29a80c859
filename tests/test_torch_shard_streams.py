"""Seeded statement streams through the port's sharded tables and the
reference's (tests/test_shard_parity.py's streams): pruned and fan-out
SELECT / UPDATE / DELETE / aggregates, ORDER BY at small limits, the
executemany family with and without ``per_statement``, TTL and
OPS_INTERVAL expiry with deferred lane replays, indexed on the partition
column, off it and not at all. Every result is compared exactly (float
aggregates within rtol=1e-5, as tests/test_torch_daemon.py does), then
each shard's whole state (helpers in tests/test_torch_shards.py)."""
import numpy as np
import pytest

from repro_torch.core import shards as TSH

from test_torch_shards import (TEMPLATES, insert_batch, make_t, pair, run,
                               same_shards)


@pytest.mark.parametrize("shards,index,seed", [
    (2, "", 0), (4, "", 1), (3, "k", 2), (4, "w", 3)])
def test_random_stream_parity(shards, index, seed):
    """Pruned and fan-out statements, indexed on the partition column,
    off it and not at all: every result and then each shard's state."""
    rng = np.random.default_rng(seed + 100 * shards)
    dbs = pair()
    make_t(dbs, shards, index)
    insert_batch(dbs, rng)
    for _ in range(14):
        if rng.integers(0, 5) == 0:
            insert_batch(dbs, rng)
            continue
        sql, mkp = TEMPLATES[int(rng.integers(0, len(TEMPLATES)))]
        run(dbs, "execute", sql, mkp(rng))
    same_shards(dbs, "t")


@pytest.mark.parametrize("index", ["", "k", "w"])
def test_batched_paths_parity(index):
    """executemany: pruned batches on one lane and across lanes (stacked),
    fan-out batches, per-statement DML counts, the batched UPDATE."""
    rng = np.random.default_rng(7)
    dbs = pair()
    make_t(dbs, 4, index)
    insert_batch(dbs, rng)
    insert_batch(dbs, rng)
    k0 = next(k for k in range(12) if TSH.shard_of_host(k, 4) == 0)
    k0b = next(k for k in range(k0 + 1, 40) if TSH.shard_of_host(k, 4) == 0)
    for qs in ([(0,), (3,), (9,), (42,)], [(k0,), (k0b,)]):
        for sql in ("SELECT w FROM t WHERE k = ?",
                    "SELECT w, v FROM t WHERE w = ?",
                    "SELECT k, v FROM t WHERE k = ? ORDER BY v DESC LIMIT 2",
                    "SELECT AVG(v) FROM t WHERE w = ?"):
            run(dbs, "executemany", sql, qs)
    for ps in (True, False):
        run(dbs, "executemany", "UPDATE t SET w = w + 100 WHERE k = ?",
            [(1,), (3,), (77,)], per_statement=ps)
        run(dbs, "executemany", "UPDATE t SET v = ? WHERE w = ?",
            [(9, 4), (8, 104)], per_statement=ps)
        run(dbs, "executemany", "DELETE FROM t WHERE k = ?",
            [(0,), (3,), (0,)], per_statement=ps)
        run(dbs, "executemany",
            "DELETE FROM t WHERE w > ? AND v = ?" if ps else
            "DELETE FROM t WHERE w = ?", [(50, 1), (20, -2)] if ps
            else [(5,), (6,)], per_statement=ps)
        insert_batch(dbs, rng)
    run(dbs, "executemany", "DELETE FROM t WHERE k = ?", [(k0,), (k0b,)])
    same_shards(dbs, "t")


def test_ttl_expire_parity():
    rng = np.random.default_rng(2)
    dbs = pair()
    make_t(dbs, 4, extra=" TTL 6")
    for _ in range(3):
        insert_batch(dbs, rng, ttl=True)
    for db in dbs:
        db.advance_clock(4, "t")
    run(dbs, "execute", "EXPIRE t")
    run(dbs, "execute", "SELECT k, w FROM t WHERE k = ?", (3,))
    for db in dbs:
        db.advance_clock(9)
    run(dbs, "execute", "SELECT COUNT(*) FROM t")
    run(dbs, "execute", "EXPIRE t")
    same_shards(dbs, "t")


def test_ops_interval_stream_parity():
    """OPS_INTERVAL under lane execution: a lane that missed a table-wide
    expiry replays it on its next dispatch, statement for statement as
    in the reference, deferrals and all."""
    rng = np.random.default_rng(23)
    dbs = pair()
    make_t(dbs, 4, "k", extra=" TTL 30 OPS_INTERVAL 8")
    insert_batch(dbs, rng)
    deferred = 0
    for i in range(24):
        run(dbs, "execute", "SELECT k, w FROM t WHERE k = ?",
            (int(rng.integers(0, 12)),))
        deferred += any(d is not None for d in dbs[1].tables["t"].expire_due)
        if i % 10 == 9:
            insert_batch(dbs, rng)
        if i % 13 == 12:
            run(dbs, "execute", "SELECT COUNT(*) FROM t WHERE w < ?", (20,))
            same_shards(dbs, "t")
    assert deferred
    same_shards(dbs, "t")
    run(dbs, "execute", "EXPIRE t")
    run(dbs, "execute", "SELECT k, w, v FROM t")
    same_shards(dbs, "t")


@pytest.mark.parametrize("limit", [1, 3, 7])
def test_order_by_merge_parity_at_small_limits(limit):
    rng = np.random.default_rng(17)
    dbs = pair()
    make_t(dbs, 4)
    rows = [(int(rng.integers(0, 12)), int(w), int(rng.integers(-5, 5)))
            for w in rng.permutation(64)[:40]]
    run(dbs, "executemany", "INSERT INTO t (k, w, v) VALUES (?, ?, ?)", rows)
    for sql in (f"SELECT k, w FROM t ORDER BY w DESC LIMIT {limit}",
                f"SELECT k, w, v FROM t ORDER BY w ASC LIMIT {limit}",
                f"SELECT w FROM t WHERE v >= 0 ORDER BY v DESC "
                f"LIMIT {limit}"):
        run(dbs, "execute", sql)
    same_shards(dbs, "t")
