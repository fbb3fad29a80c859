"""The port's daemon against the reference daemon, statement by statement.

The same SQL scripts (in the style of tests/test_core_daemon.py and
tests/test_planner_parity.py) run through ``repro.core.SQLCached`` (the
JAX reference, built with ``mesh_exec=False, warmup=False``) and
``repro_torch.core.SQLCached(device="cpu")``. Every count, row, row id
and value must match, and so must the whole table states afterwards.
Integers, bitmaps and ids compare exactly; float aggregates use
rtol=1e-5 because the two backends sum in different orders."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.core.daemon import SQLCached as JDB
from repro_torch import convert as CV
from repro_torch.core import sqlparse as TS
from repro_torch.core.daemon import _UNSET
from repro_torch.core.daemon import SQLCached as TDB


def pair():
    return JDB(mesh_exec=False, warmup=False), TDB(device="cpu")


def snap(r):
    if isinstance(r, list):
        return [snap(x) for x in r]
    ids = r.row_ids
    return {"count": r.count, "value": r.value, "rows": r.rows,
            "row_ids": None if ids is None else np.asarray(ids).tolist()}


def same(a, b):
    """Exact equality, except float values (rtol 1e-5: the summation order
    of float aggregates differs between backends)."""
    if isinstance(a, float) or isinstance(b, float):
        assert b == pytest.approx(a, rel=1e-5)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    else:
        assert a == b


def run(dbs, kind, sql, *args, **kw):
    out = [snap(getattr(db, kind)(sql, *args, **kw)) for db in dbs]
    same(out[0], out[1])
    return out[1]


def same_tables(dbs, *names):
    jdb, tdb = dbs
    for nm in names:
        want = jax.tree.map(np.asarray, jdb.table_state(nm))
        got = CV.state_to_numpy(tdb.table_state(nm))
        np.testing.assert_equal(got, want)
        assert jdb.live_rows(nm) == tdb.live_rows(nm)


def fill(dbs, n=20):
    run(dbs, "execute",
        "CREATE TABLE cache (page_id INT, user_id INT, key TEXT, val FLOAT) "
        "CAPACITY 128 MAX_SELECT 64")
    run(dbs, "executemany",
        "INSERT INTO cache (page_id, user_id, key, val) VALUES (?, ?, ?, ?)",
        [(i % 5, i % 3, f"k{i}", float(i)) for i in range(n)])


@pytest.mark.parametrize("limit", [1, 5, 64])
def test_generic_scan_compaction_matches_reference(monkeypatch, limit):
    """A WHERE the planner leaves to GenericScan (an OR) is compacted by
    core.table._compact: the same row ids, presence and counts as the
    reference daemon's."""
    from repro_torch.core import table as TT
    calls = []
    real = TT._compact
    monkeypatch.setattr(TT, "_compact",
                        lambda *a: calls.append(a[1]) or real(*a))
    dbs = pair()
    fill(dbs, n=60)
    for args in ((1, 2), (4, 0), (9, 9)):
        run(dbs, "execute", "SELECT key, val FROM cache WHERE page_id = ? "
            f"OR user_id = ? LIMIT {limit}", args)
    run(dbs, "execute", "DELETE FROM cache WHERE page_id = ? OR val > ?",
        (3, 50.0))
    run(dbs, "execute", "SELECT key FROM cache WHERE page_id = ? OR "
        f"user_id = ? LIMIT {limit}", (3, 1))
    same_tables(dbs, "cache")
    assert limit in calls


def test_core_daemon_script():
    dbs = pair()
    fill(dbs)
    ex = lambda *a, **k: run(dbs, "execute", *a, **k)
    em = lambda *a, **k: run(dbs, "executemany", *a, **k)
    ex("SELECT key, val FROM cache WHERE page_id = 2 AND val >= 5")
    ex("SELECT val FROM cache WHERE key = ?", ["k13"])
    assert ex("DELETE FROM cache WHERE page_id = ?", [3])["count"] == 4
    ex("SELECT COUNT(*) FROM cache WHERE page_id = 2")
    ex("UPDATE cache SET TTL = 500 WHERE user_id = 1")
    for q in ("COUNT(*)", "MAX(val)", "MIN(val)", "SUM(val)", "AVG(val)",
              "SUM(page_id)", "MIN(page_id)", "AVG(user_id)"):
        ex(f"SELECT {q} FROM cache WHERE user_id = 0")
        ex(f"SELECT {q} FROM cache")
    ex("SELECT val FROM cache ORDER BY val DESC LIMIT 3")
    ex("SELECT key FROM cache ORDER BY page_id ASC LIMIT 7")
    ex("SELECT val FROM cache WHERE (page_id = 1 OR page_id = 3) "
       "AND val BETWEEN 5 AND 15 AND NOT user_id = 2")
    ex("SELECT COUNT(*) FROM cache WHERE page_id IN (0, 4)")
    ex("SELECT * FROM cache WHERE val / 2 > page_id % 3 + ?", [1])
    ex("SELECT * FROM cache WHERE ABS(page_id - 3) < MAX(user_id, 1)")
    assert em("DELETE FROM cache WHERE page_id = ?",
              [(1,), (3,), (1,)])["count"] == 4
    em("UPDATE cache SET val = val * 3 WHERE page_id = ?", [(0,), (2,), (4,)])
    em("SELECT val FROM cache WHERE page_id = ?",
       [(0,), (4,), (0,), (4,), (0,)])
    em("SELECT COUNT(*) FROM cache WHERE page_id = ?", [(0,), (2,), (9,)])
    em("SELECT SUM(val) FROM cache WHERE user_id = ?", [(0,), (1,), (2,)])
    em("SELECT key FROM cache WHERE val > ? ORDER BY val DESC LIMIT 2",
       [(10.0,), (40.0,)])
    em("DELETE FROM cache WHERE page_id = ? OR user_id = ?",
       [(0, 1), (2, 1)], per_statement=True)
    em("INSERT INTO cache (page_id, user_id, key, val) VALUES (?, ?, ?, ?)",
       [(7, 7, "z", 1.5), (8, 8, "y", 2.5), (9, 9, "x", 3.5)],
       per_statement=True)
    em("UPDATE cache SET val = val + 1 WHERE page_id = ?",
       [(7,), (8,), (99,)], per_statement=True)
    em("DELETE FROM cache WHERE page_id = ?", [(7,), (7,), (8,)],
       per_statement=True)
    ex("FLUSH cache")
    same_tables(dbs, "cache")


def test_wide_eq_delete_batch_and_clock():
    dbs = pair()
    fill(dbs, 100)
    ex = lambda *a, **k: run(dbs, "execute", *a, **k)
    em = lambda *a, **k: run(dbs, "executemany", *a, **k)
    # > 16 statements: the sorted one-pass path, with duplicates
    em("DELETE FROM cache WHERE user_id = ?",
       [(i % 4,) for i in range(19)], per_statement=True)
    fill_more = [(i % 7, i % 5, f"n{i}", float(i)) for i in range(30)]
    em("INSERT INTO cache (page_id, user_id, key, val) VALUES (?, ?, ?, ?)",
       fill_more)
    em("DELETE FROM cache WHERE page_id = ?", [(i % 9,) for i in range(20)])
    ex("SELECT COUNT(*) FROM cache")
    same_tables(dbs, "cache")


def test_indexed_table_probe_batch_and_stale_index():
    dbs = pair()
    ex = lambda *a, **k: run(dbs, "execute", *a, **k)
    em = lambda *a, **k: run(dbs, "executemany", *a, **k)
    ex("CREATE TABLE t (k INT, w INT, INDEX(k)) CAPACITY 256")
    em("INSERT INTO t (k, w) VALUES (?, ?)", [(i % 10, i) for i in range(80)])
    qs = [(k,) for k in (0, 3, 9, 42)]
    em("SELECT w FROM t WHERE k = ?", qs)
    for q in qs:
        ex("SELECT w FROM t WHERE k = ?", q)
    em("SELECT SUM(w) FROM t WHERE k = ?", qs)
    em("UPDATE t SET w = w + 100 WHERE k = ?", [(0,), (3,), (77,)],
       per_statement=True)
    em("UPDATE t SET k = k + 1 WHERE w > ?", [(150,), (170,)])
    ex("SELECT w FROM t WHERE k = ? AND w < ?", (4, 50))
    ex("EXPLAIN SELECT w FROM t WHERE k = ?")
    ex("EXPLAIN DELETE FROM t WHERE k = 1 OR w = 2")
    ex("EXPLAIN SELECT w FROM t WHERE k = ? ORDER BY w")
    ex("EXPLAIN FLUSH t")
    ex("EXPLAIN INSERT INTO t (k, w) VALUES (?, ?)")
    same_tables(dbs, "t")

    ex("CREATE TABLE r (k INT, w INT, INDEX(k)) CAPACITY 512 MAX_SELECT 256")
    em("INSERT INTO r (k, w) VALUES (?, ?)", [(7, i) for i in range(200)])
    em("INSERT INTO r (k, w) VALUES (?, ?)", [(100 + i, i) for i in range(20)])
    info = ex("EXPLAIN SELECT w FROM r WHERE k = ?")
    assert json.loads(info["value"])["stale"] > 0
    ex("SELECT w FROM r WHERE k = ?", (7,))
    em("SELECT COUNT(*) FROM r WHERE k = ?", [(7,), (103,), (5,)])
    ex("UPDATE r SET w = w * 2 WHERE k = ?", (7,))
    assert ex("REINDEX r")["value"] > 0
    assert ex("DELETE FROM r WHERE k = ?", (7,))["count"] == 200
    assert ex("REINDEX r")["value"] == 0
    ex("SELECT COUNT(*) FROM r WHERE k = ?", (103,))
    ex("INSERT INTO r (k, w) VALUES (?, ?)", (1, 1))
    same_tables(dbs, "t", "r")


def test_ttl_and_ops_interval_expiry():
    dbs = pair()
    ex = lambda *a, **k: run(dbs, "execute", *a, **k)
    em = lambda *a, **k: run(dbs, "executemany", *a, **k)
    ex("CREATE TABLE t (a INT) CAPACITY 64 TTL 2 OPS_INTERVAL 4")
    ex("INSERT INTO t (a) VALUES (1)")
    for _ in range(6):
        ex("SELECT COUNT(*) FROM t")
    assert dbs[1].live_rows("t") == 0
    ex("CREATE TABLE e (a INT, b INT) CAPACITY 32 TTL 5 MAX_ROWS 12 "
       "OPS_INTERVAL 3")
    for i in range(10):
        em("INSERT INTO e (a, b) VALUES (?, ?) TTL ?",
           [(i, j, j % 4) for j in range(3)])
        em("SELECT a FROM e WHERE b = ?", [(0,), (1,)])
        ex("UPDATE e SET b = b + 1 WHERE a = ?", (i - 1,))
        for db in dbs:
            db.advance_clock(1, "e")
    ex("EXPIRE e")
    ex("SELECT a, b FROM e ORDER BY a ASC")
    same_tables(dbs, "t", "e")


def test_eviction_payloads_and_big_ints():
    dbs = pair()
    ex = lambda *a, **k: run(dbs, "execute", *a, **k)
    em = lambda *a, **k: run(dbs, "executemany", *a, **k)
    ex("CREATE TABLE s (a INT) CAPACITY 8 MAX_SELECT 8")
    for i in range(12):
        ex("INSERT INTO s (a) VALUES (?)", [i])
    assert [r["a"] for r in ex("SELECT a FROM s ORDER BY a ASC")["rows"]] \
        == list(range(4, 12))
    ex("CREATE TABLE big (a INT, b BIGINT) CAPACITY 16 MAX_SELECT 8")
    base = 1 << 24
    em("INSERT INTO big (a, b) VALUES (?, ?)",
       [(base + 3, 2**31 - 1), (base + 1, 2**31 - 2), (base + 2, 5)])
    ex("SELECT a FROM big ORDER BY a DESC LIMIT 2")
    ex("SELECT SUM(b) FROM big")   # int32 sum wraps on both sides
    ex("CREATE TABLE kv (seq INT, PAYLOAD blk TENSOR(4,8) F32) CAPACITY 32")
    blks = [np.full((4, 8), float(i), np.float32) for i in range(3)]
    outs = []
    for db in dbs:
        db.executemany("INSERT INTO kv (seq) VALUES (?)", [(i,) for i in
                                                           range(3)],
                       [{"blk": b} for b in blks])
        r = db.execute("SELECT PAYLOAD(blk), seq FROM kv WHERE seq = ?", (1,))
        outs.append(np.asarray(r.payloads["blk"])[0])
        d = db.execute("DELETE FROM kv WHERE seq = ?", (2,))
        assert d.count == 1 and list(d.row_ids) == [2]
    np.testing.assert_array_equal(outs[0], outs[1])
    same_tables(dbs, "s", "big", "kv")


def test_lazy_results_and_executor_reuse():
    db = TDB(device="cpu")
    db.execute("CREATE TABLE c (a INT, b FLOAT) CAPACITY 64")
    db.executemany("INSERT INTO c (a, b) VALUES (?, ?)",
                   [(i % 4, float(i)) for i in range(12)])
    r = db.execute("SELECT b FROM c WHERE a = ?", [2])
    assert r._count is _UNSET and r._rows is None
    db.drain("c")
    assert r.count == 3 and {x["b"] for x in r.rows} == {2.0, 6.0, 10.0}
    n0 = len(db.tables["c"].execs._entries)
    for k in range(5):
        db.execute("SELECT b FROM c WHERE a = ?", [k])
    # one executor serves every binding of the shape
    assert len(db.tables["c"].execs._entries) == n0
    # the result holds fresh tensors, not views of the table state
    r2 = db.execute("SELECT b FROM c WHERE a = ?", [1])
    db.execute("UPDATE c SET b = 0 WHERE a = 1")
    assert sorted(x["b"] for x in r2.rows) == [1.0, 5.0, 9.0]


@pytest.mark.parametrize("sql", [
    "ALTER TABLE c RETAIN SLOTS 0 OF 2",
    "CHECKPOINT c TO 'somewhere'",
    "RESTORE c FROM 'somewhere'",
])
def test_out_of_slice_statements_refused(sql, tmp_path, monkeypatch):
    """RETAIN SLOTS, CHECKPOINT and RESTORE, which the port once refused,
    act as the reference's: RETAIN without PARTITION BY and RESTORE from a
    directory with no checkpoint are refused with the reference's
    message, and CHECKPOINT of an empty table writes one (same result)."""
    from repro.core import sqlparse as JS
    monkeypatch.chdir(tmp_path)
    out = []
    for db in pair():
        db.execute("CREATE TABLE c (a INT) CAPACITY 16")
        try:
            out.append(snap(db.execute(sql)))
        except (JS.SQLError, TS.SQLError) as e:
            out.append(("refused", str(e)))
    assert out[0] == out[1]
    assert isinstance(out[1], tuple) == (not sql.startswith("CHECKPOINT"))
    assert "x" not in db.tables


def test_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDB()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDB(device="cuda")


def test_state_carried_across_with_convert():
    """Both daemons start from the same contents (the reference's state
    and interner carried into the port), then take the same statements."""
    jdb, tdb = pair()
    ddl = ("CREATE TABLE p (k TEXT, u INT, v FLOAT, INDEX(u)) CAPACITY 256 "
           "MAX_SELECT 32 TTL 40")
    jdb.execute(ddl)
    tdb.execute(ddl)
    rng = np.random.default_rng(0)
    rows = [(f"key{i}", int(rng.integers(0, 12)), float(rng.random()))
            for i in range(150)]
    jdb.executemany("INSERT INTO p (k, u, v) VALUES (?, ?, ?)", rows)
    jdb.execute("DELETE FROM p WHERE u = ?", (3,))
    jdb.advance_clock(7)
    CV.copy_interner(jdb.interner, tdb.interner)
    np_state = jax.tree.map(np.asarray, jdb.table_state("p"))
    tdb.swap_table_state("p", CV.state_from_numpy(np_state, tdb.device))
    np.testing.assert_equal(CV.state_to_numpy(tdb.table_state("p")), np_state)
    dbs = (jdb, tdb)
    run(dbs, "execute", "SELECT k, v FROM p WHERE u = ?", (5,))
    run(dbs, "execute", "SELECT u FROM p WHERE k = ?", ("key17",))
    run(dbs, "executemany", "SELECT v FROM p WHERE k = ?",
        [("key1",), ("key99",), ("nope",)])
    run(dbs, "execute", "UPDATE p SET v = v + 1 WHERE u = ?", (7,))
    run(dbs, "execute", "EXPIRE p")
    run(dbs, "execute", "SELECT COUNT(*) FROM p")
    same_tables(dbs, "p")
    with pytest.raises(ValueError):
        tdb.swap_table_state("p", {"valid": torch.zeros(3)})


def _pow2_batches(rows):
    """``rows`` split into power-of-two batches, largest first: each fits
    its own bucket, so the reference takes them at any capacity."""
    out, i, n = [], 0, len(rows)
    while i < n:
        b = 1 << ((n - i).bit_length() - 1)
        out.append(rows[i:i + b])
        i += b
    return out


@pytest.mark.parametrize("cap,n", [(48, 40), (100, 65), (1000, 600)])
def test_insert_batch_whose_bucket_exceeds_capacity(cap, n):
    """n rows in one executemany whose power-of-two bucket is larger than
    CAPACITY: the port takes them in one statement; the reference, fed the
    same rows in batches that fit its buckets, gives the same contents,
    row ids and counts."""
    jdb, tdb = pair()
    ddl = (f"CREATE TABLE t (k INT, w INT, s TEXT, INDEX(k)) CAPACITY {cap} "
           f"MAX_SELECT 64")
    jdb.execute(ddl)
    tdb.execute(ddl)
    rng = np.random.default_rng(cap)
    rows = [(int(rng.integers(0, 9)), i, f"s{i}") for i in range(n)]
    sql = "INSERT INTO t (k, w, s) VALUES (?, ?, ?)"
    got = snap(tdb.executemany(sql, rows))
    want_ids, want_count = [], 0
    for batch in _pow2_batches(rows):
        r = snap(jdb.executemany(sql, batch))
        want_ids += r["row_ids"]
        want_count += r["count"]
    assert got["count"] == want_count == n
    assert got["row_ids"] == want_ids
    assert tdb.live_rows("t") == jdb.live_rows("t") == n
    want = jax.tree.map(np.asarray, jdb.table_state("t"))
    have = CV.state_to_numpy(tdb.table_state("t"))
    for c in ("k", "w", "s"):
        np.testing.assert_array_equal(have["cols"][c], want["cols"][c])
    np.testing.assert_array_equal(have["valid"], want["valid"])
    for k in range(9):
        same(snap(jdb.execute("SELECT w, s FROM t WHERE k = ?", (k,))),
             snap(tdb.execute("SELECT w, s FROM t WHERE k = ?", (k,))))


def test_insert_wider_than_capacity_is_refused_unchanged():
    """More rows than CAPACITY in one statement raise SQLError, and the
    table is left as it was."""
    db = TDB(device="cpu")
    db.execute("CREATE TABLE t (k INT, w INT, INDEX(k)) CAPACITY 48")
    db.executemany("INSERT INTO t (k, w) VALUES (?, ?)",
                   [(i % 5, i) for i in range(30)])
    before = CV.state_to_numpy(db.table_state("t"))
    with pytest.raises(TS.SQLError, match="exceeds CAPACITY 48"):
        db.executemany("INSERT INTO t (k, w) VALUES (?, ?)",
                       [(1, i) for i in range(49)])
    np.testing.assert_equal(CV.state_to_numpy(db.table_state("t")), before)
    assert db.execute("SELECT COUNT(*) FROM t").value == 30
