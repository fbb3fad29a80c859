"""The port's snapshot statements against the reference's: ALTER TABLE ...
RETAIN SLOTS ... OF m, CHECKPOINT t TO 'dir' and RESTORE t FROM 'dir'.

The same statement streams run through ``repro.core.SQLCached``
(``mesh_exec=False, warmup=False``) and ``repro_torch.core.SQLCached(
device="cpu")``. Every statement's result must match, and so must each
shard's whole raw state, the lazy-clock bookkeeping and the caught-up
snapshot (``same_shards``, through ``convert.table_snapshot``'s view of
both daemons). A checkpoint is the same files in both packages, and one
written by either package restores in the other. Every comparison is
exact: ints, bools, and floats that are only copied."""
import json

import numpy as np
import pytest

from repro.core import sqlparse as JS
from repro_torch import convert as CV
from repro_torch.core import shards as TSH
from repro_torch.core import sqlparse as TS
from repro_torch.core.daemon import SQLCached as TDB

from test_torch_daemon import run
from test_torch_shards import make_t, pair, same_shards

ERRORS = (JS.SQLError, TS.SQLError)


def outcome(db, sql, *args):
    """A statement's result, or ("refused", message)."""
    try:
        r = db.execute(sql, *args)
    except ERRORS as e:
        return ("refused", str(e))
    return {"count": r.count, "value": r.value, "rows": r.rows}


def same_outcome(dbs, sql, *args):
    out = [outcome(db, sql, *args) for db in dbs]
    assert out[0] == out[1], sql
    return out[1]


def checkpoint_both(dbs, table, tmp_path, name):
    """CHECKPOINT ``table`` of each daemon into its own directory; the two
    directories hold the same meta.json and the same arrays. Returns
    (reference's dir, port's dir)."""
    dirs = [str(tmp_path / f"{name}-{tag}") for tag in ("ref", "port")]
    res = [db.execute(f"CHECKPOINT {table} TO '{d}'")
           for db, d in zip(dbs, dirs)]
    assert res[0].count == res[1].count
    assert [r.value for r in res] == dirs
    metas = [json.loads((tmp_path / d / "step_0" / "meta.json").read_text())
             for d in dirs]
    assert metas[0] == metas[1]
    for leaf in metas[0]["names"].values():
        a, b = (np.load(tmp_path / d / "step_0" / leaf) for d in dirs)
        assert a.dtype == b.dtype, leaf
        np.testing.assert_array_equal(a, b, err_msg=leaf)
    return dirs


def fill(dbs, rng, batches=3, ttl=False):
    """``batches`` INSERT batches of 12 random rows into t (one batch
    bucket, so the reference compiles its insert once)."""
    sql = "INSERT INTO t (k, w, v) VALUES (?, ?, ?)" + (" TTL ?" if ttl
                                                         else "")
    for _ in range(batches):
        rows = [(int(rng.integers(0, 12)), int(rng.integers(0, 40)),
                 int(rng.integers(-5, 5))) + ((int(rng.integers(1, 8)),)
                                              if ttl else ())
                for _ in range(12)]
        run(dbs, "executemany", sql, rows)


def stream(dbs, rng, n=3):
    """Pruned and fan-out reads and writes on table t."""
    for i in range(n):
        k, w = int(rng.integers(0, 12)), int(rng.integers(0, 40))
        run(dbs, "execute", "SELECT k, w, v FROM t WHERE k = ?", (k,))
        run(dbs, "execute", "SELECT k, v FROM t WHERE w = ?", (w,))
        run(dbs, "execute", "UPDATE t SET v = v + 1 WHERE k = ?", (k,))
        if i % 2:
            run(dbs, "execute", "DELETE FROM t WHERE w = ?", (w,))
        run(dbs, "execute", "SELECT COUNT(*) FROM t WHERE w < ?", (w,))


# ------------------------------------------------------------- RETAIN

@pytest.mark.parametrize("shards,of,index", [
    (1, 64, ""), (1, 7, "w"), (2, 64, "w"), (2, 7, ""), (4, 64, "k"),
    (4, 7, "w")])
def test_retain_matches_reference(shards, of, index):
    rng = np.random.default_rng(shards * 10 + of)
    dbs = pair()
    make_t(dbs, shards, index, extra=" OPS_INTERVAL 4")
    fill(dbs, rng)
    run(dbs, "execute", "SELECT k FROM t WHERE k = ?", (3,))
    slots = sorted(rng.choice(of, size=max(1, of // 2), replace=False))
    sql = (f"ALTER TABLE t RETAIN SLOTS {','.join(map(str, slots))} "
           f"OF {of}")
    got = run(dbs, "execute", sql)
    assert got["value"] == len(slots) and got["count"] > 0
    same_shards(dbs, "t")
    # validity only: the indexes and stamps are untouched, statements
    # after it (probes, pruned lanes, inserts) agree
    stream(dbs, rng, n=2)
    fill(dbs, rng, batches=1)
    assert run(dbs, "execute", sql)["count"] > 0
    same_shards(dbs, "t")


def test_retain_keeps_rows_of_listed_slots_only():
    """A row survives exactly when its key's slot (``shard_of_host`` at
    modulus m, the cluster's routing hash) is listed, for negative and
    large keys too."""
    keys = [0, 1, 7, -1, -5, 123456, 2**31 - 1, -2**31, 65536, -65536,
            99, 1000003]
    dbs = pair()
    run(dbs, "execute", "CREATE TABLE t (k INT, v INT) CAPACITY 64 "
                        "SHARDS 4 PARTITION BY k")
    run(dbs, "executemany", "INSERT INTO t (k, v) VALUES (?, ?)",
        [(k, i) for i, k in enumerate(keys)])
    owned = [0, 5, 17, 33, 40, 63]
    run(dbs, "execute", f"ALTER TABLE t RETAIN SLOTS "
                        f"{','.join(map(str, owned))} OF 64")
    left = sorted(r["k"] for r in run(dbs, "execute",
                                      "SELECT k FROM t WHERE v >= ?",
                                      (0,))["rows"])
    assert left == sorted(k for k in keys
                          if TSH.shard_of_host(k, 64) in owned)
    same_shards(dbs, "t")


def test_retain_refused_without_partition_by():
    dbs = pair()
    run(dbs, "execute", "CREATE TABLE t (k INT, v INT) CAPACITY 16")
    out = same_outcome(dbs, "ALTER TABLE t RETAIN SLOTS 0,1 OF 4")
    assert out[0] == "refused" and "no PARTITION BY" in out[1]


# ------------------------------------------------- CHECKPOINT / RESTORE
# (restores into fresh tables and across packages: test_torch_snapshot_restore.py)

@pytest.mark.parametrize("dst_n", [2, 4])
def test_text_partition_restores_into_busy_interner(tmp_path, dst_n):
    """TEXT ids are the writer's interner ids: a daemon whose interner
    already holds other strings re-interns them and re-splits by the new
    ids, so pruned reads by name still find every row."""
    ddl = ("CREATE TABLE s (name TEXT, k INT, v FLOAT, INDEX(k)) "
           "CAPACITY 64 MAX_SELECT 16 SHARDS {n} PARTITION BY name")
    src = pair()
    for db in src:
        db.execute(ddl.format(n=4))
    run(src, "executemany", "INSERT INTO s (name, k, v) VALUES (?, ?, ?)",
        [(f"n{i % 9}", i % 5, i / 4) for i in range(30)])
    dirs = checkpoint_both(src, "s", tmp_path, "s")
    dst = pair()
    for db in dst:
        db.execute("CREATE TABLE other (tag TEXT, x INT) CAPACITY 16")
        db.executemany("INSERT INTO other (tag, x) VALUES (?, ?)",
                       [(f"zz{i}", i) for i in range(7)] + [("n4", 99)])
        db.execute(ddl.format(n=dst_n))
    # the port restores the reference's files, the reference the port's
    for db, d in zip(dst, reversed(dirs)):
        assert db.execute(f"RESTORE s FROM '{d}'").count == 30
    assert dst[1].interner._rev == dst[0].interner._rev
    assert dst[1].interner._rev != src[1].interner._rev
    same_shards(dst, "s")
    for i in range(9):
        got = run(dst, "execute", "SELECT name, k, v FROM s WHERE name = ?",
                  (f"n{i}",))
        want = [r for r in src[1].execute(
            "SELECT name, k, v FROM s WHERE name = ?", (f"n{i}",)).rows]
        assert sorted(map(str, got["rows"])) == sorted(map(str, want))
    run(dst, "execute", "SELECT name FROM s WHERE k = ?", (3,))


def test_restore_refuses_skew_and_leaves_table_untouched(tmp_path):
    dbs = pair()
    run(dbs, "execute", "CREATE TABLE t (k INT, w INT) CAPACITY 32 "
                        "SHARDS 2 PARTITION BY k")
    k0 = next(k for k in range(100) if TSH.shard_of_host(k, 4) == 0)
    run(dbs, "executemany", "INSERT INTO t (k, w) VALUES (?, ?)",
        [(k0, i) for i in range(16)])
    dirs = checkpoint_both(dbs, "t", tmp_path, "t")
    run(dbs, "execute", "CREATE TABLE u (k INT, w INT) CAPACITY 32 "
                        "SHARDS 4 PARTITION BY k")
    run(dbs, "executemany", "INSERT INTO u (k, w) VALUES (?, ?)",
        [(i, i) for i in range(10)])
    before = CV.table_snapshot(dbs[1].tables["u"])
    out = [outcome(db, f"RESTORE u FROM '{d}'") for db, d in zip(dbs, dirs)]
    assert out[0] == ("refused", out[0][1].replace(dirs[1], dirs[0]))
    assert out[1][0] == "refused" and "hash to one shard" in out[1][1]
    assert out[0][1] == out[1][1]
    np.testing.assert_equal(CV.table_snapshot(dbs[1].tables["u"]), before)
    same_shards(dbs, "u")


def test_restore_errors_match_reference(tmp_path):
    dbs = pair()
    for db in dbs:
        db.execute("CREATE TABLE t (k INT, w INT) CAPACITY 32")
        db.execute("CREATE TABLE x (k INT, w INT, z INT) CAPACITY 32")
    out = same_outcome(dbs, f"RESTORE t FROM '{tmp_path}/nothing'")
    assert out[0] == "refused" and "no checkpoint at" in out[1]
    dirs = checkpoint_both(dbs, "t", tmp_path, "t")
    for db, d in zip(dbs, dirs):
        out = outcome(db, f"RESTORE x FROM '{d}'")
        assert out[0] == "refused" and "does not match" in out[1]


def test_restore_retires_preplanned_statements(tmp_path):
    """RESTORE over a warmed table: the epoch moves on (SHOW STATS), and
    the statements after it answer from the restored rows."""
    dbs = pair()
    for db in dbs:
        db.execute("CREATE TABLE t (k INT, v INT, INDEX(k)) CAPACITY 64")
        db.execute("WARMUP t")
    run(dbs, "executemany", "INSERT INTO t (k, v) VALUES (?, ?)",
        [(i % 9, i) for i in range(40)])
    want = [run(dbs, "execute", "SELECT k, v FROM t WHERE k = ?", (k,))
            for k in range(9)]
    dirs = checkpoint_both(dbs, "t", tmp_path, "t")
    run(dbs, "execute", "FLUSH t")

    def epochs():
        return [json.loads(db.execute("SHOW STATS t").value)["executors"]
                ["epoch"] for db in dbs]

    e0 = epochs()
    for db, d in zip(dbs, dirs):
        assert db.execute(f"RESTORE t FROM '{d}'").count == 40
    assert epochs() == [e + 1 for e in e0]
    got = [run(dbs, "execute", "SELECT k, v FROM t WHERE k = ?", (k,))
           for k in range(9)]
    assert [sorted(r["v"] for r in g["rows"]) for g in got] == \
        [sorted(r["v"] for r in w["rows"]) for w in want]
    same_shards(dbs, "t")


def test_snapshot_statements_are_whole_table_for_the_scheduler():
    db = TDB(device="cpu", warmup=False)
    db.execute("CREATE TABLE t (k INT) CAPACITY 16 SHARDS 2 PARTITION BY k")
    for sql in ("ALTER TABLE t RETAIN SLOTS 0 OF 2", "CHECKPOINT t TO 'd'",
                "RESTORE t FROM 'd'", "ALTER TABLE t RESHARD 4"):
        shape = db.shape_key(sql)
        assert (shape.kind, shape.table, shape.is_write) == \
            ("admin", "t", True)
        assert shape.reads is None and shape.writes is None
        assert db.group_lane(shape, [()]) is None
        assert db.group_shard_ids(shape, [()]) is None
