"""The port's sharded tables against the reference's, statement by statement.

The same seeded statement streams (in the style of tests/test_shards.py and
tests/test_shard_parity.py) run through ``repro.core.SQLCached`` (the JAX
reference, ``mesh_exec=False, warmup=False``) and
``repro_torch.core.SQLCached(device="cpu")``, both with ``SHARDS n``
tables. Every count, row (in order), global row id and value must match,
and so must each shard's whole state (its raw lane, before any catch-up)
and the lazy-clock bookkeeping. Integers, bitmaps and ids compare exactly;
float aggregates use rtol=1e-5 because the backends sum in different
orders."""
import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import planner as JPL
from repro.core import predicate as JP
from repro.core import shards as JSH
from repro.core import sqlparse as JS
from repro.core.daemon import SQLCached as JDB
from repro.core.schema import make_schema as j_make_schema
from repro.kernels import ops as JOPS
from repro_torch import convert as CV
from repro_torch.core import planner as TPL
from repro_torch.core import predicate as TP
from repro_torch.core import shards as TSH
from repro_torch.core import sqlparse as TS
from repro_torch.core.daemon import SQLCached as TDB
from repro_torch.core.scheduler import BatchScheduler
from repro_torch.core.schema import make_schema as t_make_schema
from repro_torch.kernels import ops as TOPS

from test_torch_daemon import run, same, snap
from test_torch_protocol import both, frame

EDGE_KEYS = np.array([0, 1, 7, -1, -5, 123456, 2**31 - 1, 2**31 - 2,
                      -2**31, -2**31 + 1, 65535, 65536, -65536],
                     dtype=np.int32)


def pair(**kw):
    return (JDB(mesh_exec=False, warmup=False, **kw),
            TDB(device="cpu", warmup=False, **kw))


def same_shards(dbs, name):
    """Each shard's raw state, the catch-up bookkeeping, the counters and
    the caught-up snapshot (``table_state``) are equal."""
    jdb, tdb = dbs
    jt, tt = jdb.tables[name], tdb.tables[name]
    assert jt.schema.shards == tt.schema.shards
    for attr in ("host_ops", "ticks_total", "lane_ticks", "expire_due"):
        assert getattr(jt, attr) == getattr(tt, attr), attr
    for attr in ("stmt_routed", "writes_routed", "rows_in"):
        np.testing.assert_array_equal(getattr(jt, attr), getattr(tt, attr))
    if jt.lanes is None:
        assert tt.lanes is None
    else:
        for i, lane in enumerate(jt.lanes):
            np.testing.assert_equal(CV.state_to_numpy(tt.lanes[i]),
                                    jax.tree.map(np.asarray, lane))
    np.testing.assert_equal(CV.state_to_numpy(tdb.table_state(name)),
                            jax.tree.map(np.asarray, jdb.table_state(name)))
    assert jdb.live_rows(name) == tdb.live_rows(name)


def same_json(dbs, sql, drop=("executors", "device", "preplanned")):
    out = [json.loads(db.execute(sql).value) for db in dbs]
    for o in out:
        for k in drop:
            o.pop(k, None)
    assert out[0] == out[1], sql
    return out[1]


# ------------------------------------------------------- hashing, split

@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_shard_of_matches_reference(n):
    rng = np.random.default_rng(n)
    keys = np.concatenate([EDGE_KEYS, rng.integers(-2**31, 2**31 - 1, 500)
                           .astype(np.int32)])
    want = np.asarray(JSH.shard_of(jnp.asarray(keys), n))
    got = TSH.shard_of(torch.from_numpy(keys), n).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    host = [TSH.shard_of_host(int(k), n) for k in keys]
    assert host == [JSH.shard_of_host(int(k), n) for k in keys]
    assert host == want.tolist()


@pytest.mark.parametrize("masked", [False, True])
def test_shard_split_matches_reference(masked):
    rng = np.random.default_rng(3)
    for n in (2, 3, 4):
        sid = rng.integers(0, n, 41).astype(np.int32)
        mask = rng.random(41) < 0.7 if masked else None
        want = JOPS.shard_split(jnp.asarray(sid), n,
                                None if mask is None else jnp.asarray(mask))
        got = TOPS.shard_split(torch.from_numpy(sid), n,
                               None if mask is None else
                               torch.from_numpy(mask))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_plan_shards_matches_reference():
    cols = [("k", "INT"), ("w", "INT"), ("f", "FLOAT")]
    jsch = j_make_schema("t", cols, shards=4, partition_by="k")
    tsch = t_make_schema("t", cols, shards=4, partition_by="k")
    cases = []
    for mod in (JP, TP):
        eq_k = mod.BinOp("=", mod.Col("k"), mod.Param(0))
        eq_w = mod.BinOp("=", mod.Col("w"), mod.Param(0))
        cases.append([
            eq_k, mod.And(eq_k, eq_w), eq_w, None, mod.Or(eq_k, eq_w),
            mod.BinOp("<", mod.Col("k"), mod.Param(0)),
            mod.BinOp("=", mod.Col("k"), mod.Const(5.0)),     # coerced
            mod.BinOp("=", mod.Col("k"), mod.Const(5.5)),     # not
            mod.And(mod.BinOp("=", mod.Const(9), mod.Col("k")), eq_w),
            mod.BinOp("=", mod.Col("f"), mod.Param(0))])
    for jw, tw in zip(*cases):
        a, b = JPL.plan_shards(jsch, jw), TPL.plan_shards(tsch, tw)
        assert (a.pruned, a.kind, a.column, a.n_shards) == \
            (b.pruned, b.kind, b.column, b.n_shards)
        if a.pruned:
            assert (a.key.col, a.key.op, a.key.value) == \
                (b.key.col, b.key.op, b.key.value)
        assert JPL.explain(jsch, jw) == TPL.explain(tsch, tw)


# -------------------------------------------------------------- streams

CAP = 256
TEMPLATES = [
    ("SELECT k, w, v FROM t WHERE k = ?", lambda r: (int(r.integers(0, 12)),)),
    ("SELECT k, w FROM t WHERE w = ?", lambda r: (int(r.integers(0, 40)),)),
    ("SELECT k, w FROM t WHERE k = ? AND w >= ?",
     lambda r: (int(r.integers(0, 12)), int(r.integers(0, 40)))),
    ("SELECT k, w FROM t WHERE w BETWEEN ? AND ?",
     lambda r: (lambda a: (a, a + 10))(int(r.integers(0, 40)))),
    ("SELECT k, w FROM t ORDER BY w DESC LIMIT 7", lambda r: ()),
    ("SELECT * FROM t WHERE w = ? LIMIT 1", lambda r: (int(r.integers(0, 40)),)),
    ("SELECT v FROM t WHERE k = ? LIMIT 2", lambda r: (int(r.integers(0, 12)),)),
    ("SELECT COUNT(*) FROM t WHERE k = ?", lambda r: (int(r.integers(0, 12)),)),
    ("SELECT SUM(w) FROM t WHERE w < ?", lambda r: (int(r.integers(0, 40)),)),
    ("SELECT AVG(w) FROM t WHERE k = ?", lambda r: (int(r.integers(0, 12)),)),
    ("SELECT AVG(v) FROM t WHERE w > ?", lambda r: (int(r.integers(0, 40)),)),
    ("SELECT MIN(v) FROM t", lambda r: ()),
    ("SELECT MAX(w) FROM t WHERE k = ?", lambda r: (int(r.integers(0, 12)),)),
    ("UPDATE t SET w = w + 3 WHERE k = ?", lambda r: (int(r.integers(0, 12)),)),
    ("UPDATE t SET v = v * 2 WHERE w = ?", lambda r: (int(r.integers(0, 40)),)),
    ("DELETE FROM t WHERE k = ?", lambda r: (int(r.integers(0, 12)),)),
    ("DELETE FROM t WHERE w = ?", lambda r: (int(r.integers(0, 40)),)),
]


def make_t(dbs, shards, index="", extra=""):
    idx = f", INDEX({index})" if index else ""
    run(dbs, "execute", f"CREATE TABLE t (k INT, w INT, v INT{idx}) "
                        f"CAPACITY {CAP} MAX_SELECT 16{extra} "
                        f"SHARDS {shards} PARTITION BY k")


def insert_batch(dbs, rng, ttl=False):
    m = int(rng.integers(3, 12))
    rows = [(int(rng.integers(0, 12)), int(rng.integers(0, 40)),
             int(rng.integers(-5, 5))) for _ in range(m)]
    sql = "INSERT INTO t (k, w, v) VALUES (?, ?, ?)"
    if ttl:
        sql += " TTL ?"
        rows = [r + (int(rng.integers(1, 8)),) for r in rows]
    run(dbs, "executemany", sql, rows)


def test_max_rows_is_per_shard():
    rng = np.random.default_rng(5)
    dbs = pair()
    make_t(dbs, 4, extra=" MAX_ROWS 20 OPS_INTERVAL 3")
    for _ in range(8):
        insert_batch(dbs, rng)
        run(dbs, "execute", "SELECT COUNT(*) FROM t WHERE w < ?", (30,))
    run(dbs, "execute", "EXPIRE t")
    same_shards(dbs, "t")


def test_flush_reindex_parity():
    rng = np.random.default_rng(11)
    dbs = pair()
    make_t(dbs, 4, "w")
    insert_batch(dbs, rng)
    run(dbs, "execute", "FLUSH t")
    same_shards(dbs, "t")
    for _ in range(4):
        insert_batch(dbs, rng)
    run(dbs, "execute", "REINDEX t")
    run(dbs, "execute", "SELECT k, w, v FROM t WHERE w = ?", (2,))
    same_shards(dbs, "t")


def test_wide_insert_chunks_and_payload_deletes():
    """A batch wider than a shard goes through the stacked split in
    chunks; DELETEs on a payload table report global row ids; a SELECT
    returns the payloads of its global rows."""
    rng = np.random.default_rng(9)
    dbs = pair()
    run(dbs, "execute", "CREATE TABLE p (k INT, w INT, PAYLOAD e "
                        "TENSOR(3) F32) CAPACITY 64 MAX_SELECT 64 SHARDS 4 "
                        "PARTITION BY k")
    rows = [(int(rng.integers(0, 30)), i) for i in range(40)]
    pls = [{"e": rng.random(3).astype(np.float32)} for _ in rows]
    run(dbs, "executemany", "INSERT INTO p (k, w) VALUES (?, ?)", rows, pls)
    run(dbs, "execute", "DELETE FROM p WHERE w < ?", (10,))
    run(dbs, "execute", "DELETE FROM p WHERE k = ?", (rows[20][0],))
    sql = "SELECT PAYLOAD(e), w FROM p WHERE k = ?"
    res = [db.execute(sql, (rows[30][0],)) for db in dbs]
    same(snap(res[0]), snap(res[1]))
    np.testing.assert_array_equal(np.asarray(res[1].payloads["e"]),
                                  np.asarray(res[0].payloads["e"]))
    same_shards(dbs, "p")


# ------------------------------------------------- EXPLAIN, SHOW STATS

def test_explain_and_show_stats_match_reference():
    rng = np.random.default_rng(4)
    dbs = pair()
    make_t(dbs, 4, "w")
    insert_batch(dbs, rng)
    run(dbs, "execute", "SELECT * FROM t WHERE k = ?", (3,))
    run(dbs, "execute", "DELETE FROM t WHERE w = ?", (5,))
    for sql in ("EXPLAIN SELECT w FROM t WHERE k = ?",
                "EXPLAIN SELECT w FROM t WHERE k = 7",
                "EXPLAIN SELECT w FROM t WHERE k = 7.0",
                "EXPLAIN SELECT w FROM t WHERE w = ?",
                "EXPLAIN DELETE FROM t WHERE k = ? AND w = ?",
                "EXPLAIN UPDATE t SET v = 1 WHERE w < ?",
                "EXPLAIN INSERT INTO t (k, w) VALUES (?, ?)",
                "SHOW STATS t", "EXPLAIN t"):
        same_json(dbs, sql)
    info = same_json(dbs, "SHOW STATS t")
    assert info["shards"] == 4 and len(info["per_shard"]) == 4
    for sql, mode in (("SELECT w FROM t WHERE k = ?", "lane"),
                      ("SELECT k FROM t WHERE w = ?", "stacked")):
        got = [json.loads(db.execute(f"EXPLAIN ANALYZE {sql}", (3,)).value)
               for db in dbs]
        assert [g["exec_mode"] for g in got] == [mode, mode]
        assert got[0]["count"] == got[1]["count"]
    stats = [json.loads(db.execute("SHOW STATS t").value)["executors"]
             for db in dbs]
    # the port plans a pruned shape once per lane, the reference once per
    # device: every other key of the block agrees
    for k in ("fallbacks", "epoch"):
        assert stats[0].get(k, 0) == stats[1].get(k, 0), k


def test_explain_shard_route_over_the_wire():
    """EXPLAIN's shard route and SHOW STATS's skew report as the wire
    carries them: the same response bytes from both daemons' servers
    (SHOW STATS's executors block and device aside)."""
    script = b"".join([
        frame("CREATE TABLE t (k INT, w INT, INDEX(k)) CAPACITY 64 "
              "SHARDS 4 PARTITION BY k", tag=1),
        frame("INSERT INTO t (k, w) VALUES (?, ?)", (5, 6), tag=2),
        frame("EXPLAIN SELECT w FROM t WHERE k = 7", tag=3),
        frame("EXPLAIN SELECT w FROM t WHERE k = ?", tag=4),
        frame("EXPLAIN DELETE FROM t WHERE w = ?", tag=5),
        frame("EXPLAIN INSERT INTO t (k, w) VALUES (?, ?)", tag=6),
        frame("SELECT w FROM t WHERE k = ?", (5,), tag=7)])
    text = both(script)   # asserts the two servers' bytes are equal
    assert f"pruned -> shard {TSH.shard_of_host(7, 4)}" in text
    assert "fan-out x 4" in text and "split x 4" in text


# --------------------------------------------------------- RESHARD etc.

def test_reshard_round_trip_parity_and_twin():
    rng = np.random.default_rng(13)
    dbs = pair()
    make_t(dbs, 4, "k")
    twin = pair()
    make_t(twin, 4, "k")
    for _ in range(5):
        m = int(rng.integers(3, 12))
        rows = [(int(rng.integers(0, 40)), int(rng.integers(0, 40)),
                 int(rng.integers(-5, 5))) for _ in range(m)]
        for d in (dbs, twin):
            run(d, "executemany", "INSERT INTO t (k, w, v) VALUES (?, ?, ?)",
                rows)
    for n in (2, 1, 3, 4):
        run(dbs, "execute", f"ALTER TABLE t RESHARD {n}")
        same_shards(dbs, "t")
        same_json(dbs, "SHOW STATS t")
    run(dbs, "execute", "SELECT k, w FROM t WHERE k = ?", (5,))
    run(twin, "execute", "SELECT k, w FROM t WHERE k = ?", (5,))
    # after the round trip the contents equal the untouched twin's
    for sql in ("SELECT COUNT(*) FROM t", "SELECT SUM(w) FROM t WHERE k < ?"):
        a = dbs[1].execute(sql, (20,) if "?" in sql else ()).value
        b = twin[1].execute(sql, (20,) if "?" in sql else ()).value
        assert a == b


def test_reshard_refuses_overflowing_skew():
    dbs = pair()
    run(dbs, "execute", "CREATE TABLE t (k INT, w INT) CAPACITY 32 "
                        "SHARDS 2 PARTITION BY k")
    k0 = next(k for k in range(100) if TSH.shard_of_host(k, 2) == 0)
    run(dbs, "executemany", "INSERT INTO t (k, w) VALUES (?, ?)",
        [(k0, i) for i in range(16)])
    # all 16 rows hash to one of 4 shards of 8 rows: refused, untouched
    for db, err in zip(dbs, (JS.SQLError, TS.SQLError)):
        with pytest.raises(err, match="RESHARD 4"):
            db.execute("ALTER TABLE t RESHARD 4")
    assert dbs[1].schema("t").shards == 2
    same_shards(dbs, "t")


def test_update_partition_column_refused():
    dbs = pair()
    make_t(dbs, 4)
    for sql in ("UPDATE t SET k = 1 WHERE w = ?",
                "UPDATE t SET k = k + 1 WHERE k = ?"):
        for db in dbs:
            with pytest.raises(ValueError, match="partition column"):
                db.execute(sql, (1,))
        with pytest.raises(ValueError, match="partition column"):
            dbs[1].executemany(sql, [(1,), (2,)])
    assert dbs[1].tables["t"].host_ops == dbs[0].tables["t"].host_ops == 0


def test_reshard_and_stats_replay_deferred_lane_expiry():
    """A lane that missed an op-interval expiry still owes a replay; the
    snapshot, SHOW STATS and RESHARD apply it (reference
    tests/test_shards.py::test_reshard_replays_deferred_lane_expiry)."""
    dbs = pair()
    run(dbs, "execute", "CREATE TABLE t (k INT, w INT) CAPACITY 64 "
                        "MAX_SELECT 64 TTL 3 SHARDS 2 PARTITION BY k "
                        "OPS_INTERVAL 4")
    ka = next(k for k in range(50) if TSH.shard_of_host(k, 2) == 0)
    kb = next(k for k in range(50) if TSH.shard_of_host(k, 2) == 1)
    run(dbs, "executemany", "INSERT INTO t (k, w) VALUES (?, ?)",
        [(ka, 1), (kb, 2)])
    for db in dbs:
        db.advance_clock(10, "t")
    t = dbs[1].tables["t"]
    for _ in range(8):
        run(dbs, "execute", "SELECT w FROM t WHERE k = ?", (ka,))
        if any(d is not None for d in t.expire_due):
            break
    assert any(d is not None for d in t.expire_due)
    same_shards(dbs, "t")
    info = same_json(dbs, "SHOW STATS t")
    assert sum(p["live_rows"] for p in info["per_shard"]) == 0
    run(dbs, "execute", "ALTER TABLE t RESHARD 4")
    same_shards(dbs, "t")
    run(dbs, "execute", "SELECT COUNT(*) FROM t")


@pytest.mark.parametrize("sql", [
    "CREATE TABLE x (a INT, b INT) CAPACITY 16 SHARDS 4",
    "CREATE TABLE x (a INT, b INT) CAPACITY 16 PARTITION BY a",
    "ALTER TABLE x RESHARD 2",
])
def test_formerly_refused_statements_run(sql):
    """The sharding statements the port refused before run now, with the
    reference's results and state."""
    dbs = pair()
    if sql.startswith("ALTER"):
        run(dbs, "execute", "CREATE TABLE x (a INT, b INT) CAPACITY 16")
    run(dbs, "execute", sql)
    run(dbs, "executemany", "INSERT INTO x (a, b) VALUES (?, ?)",
        [(i, i * 2) for i in range(6)])
    run(dbs, "execute", "SELECT a, b FROM x WHERE a = ?", (3,))
    run(dbs, "execute", "SELECT a, b FROM x WHERE b > ?", (3,))
    same_json(dbs, "SHOW STATS x")
    same_shards(dbs, "x")


def test_text_keys_and_float_bindings_route_as_the_reference():
    """A TEXT partition key routes by its interned id on the host and the
    device; an integral float literal prunes (``k = 5.0``); a float bound
    to the partition column fans out with exact-compare semantics."""
    dbs = pair()
    run(dbs, "execute", "CREATE TABLE s (name TEXT, k INT, v FLOAT) "
                        "CAPACITY 64 MAX_SELECT 8 SHARDS 4 PARTITION BY name")
    run(dbs, "executemany", "INSERT INTO s (name, k, v) VALUES (?, ?, ?)",
        [(f"n{i % 7}", i % 9, i / 4) for i in range(30)])
    run(dbs, "execute", "SELECT k, v FROM s WHERE name = ?", ("n3",))
    run(dbs, "execute", "SELECT k FROM s WHERE name = 'n5'")
    run(dbs, "executemany", "DELETE FROM s WHERE name = ?", [("n1",), ("n2",)])
    run(dbs, "execute", "CREATE TABLE u (k INT, v FLOAT) CAPACITY 64 "
                        "SHARDS 4 PARTITION BY k")
    run(dbs, "executemany", "INSERT INTO u (k, v) VALUES (?, ?)",
        [(i % 9, i / 4) for i in range(30)])
    for sql, args in (("SELECT v FROM u WHERE k = 5.0", ()),
                      ("SELECT v FROM u WHERE k = ?", (5.0,)),
                      ("SELECT v FROM u WHERE k = ?", (5.5,)),
                      ("UPDATE u SET v = 1.5 WHERE k = ?", (3.0,)),
                      ("SELECT COUNT(*) FROM u WHERE k = ?", (3,))):
        run(dbs, "execute", sql, args)
    for sql in ("EXPLAIN SELECT v FROM u WHERE k = 5.0",
                "EXPLAIN SELECT k FROM s WHERE name = 'n5'"):
        same_json(dbs, sql)
    same_shards(dbs, "s")
    same_shards(dbs, "u")


def test_lane_exec_off_matches_lanes():
    rng = np.random.default_rng(31)
    dbs = pair(lane_exec=False)
    lanes = TDB(device="cpu", warmup=False)
    make_t(dbs, 4, "w", extra=" OPS_INTERVAL 5 TTL 9")
    lanes.execute(f"CREATE TABLE t (k INT, w INT, v INT, INDEX(w)) "
                  f"CAPACITY {CAP} MAX_SELECT 16 OPS_INTERVAL 5 TTL 9 "
                  f"SHARDS 4 PARTITION BY k")
    for i in range(16):
        if i % 6 == 0:
            m = int(rng.integers(3, 12))
            rows = [(int(rng.integers(0, 12)), int(rng.integers(0, 40)),
                     int(rng.integers(-5, 5))) for _ in range(m)]
            sql, args = "INSERT INTO t (k, w, v) VALUES (?, ?, ?)", rows
            run(dbs, "executemany", sql, args)
            lanes.executemany(sql, args)
            continue
        sql, mkp = TEMPLATES[int(rng.integers(0, len(TEMPLATES)))]
        p = mkp(rng)
        got = run(dbs, "execute", sql, p)
        same(got, snap(lanes.execute(sql, p)))
    same_shards(dbs, "t")
    np.testing.assert_equal(CV.state_to_numpy(lanes.table_state("t")),
                            CV.state_to_numpy(dbs[1].table_state("t")))


def test_sharded_table_equals_unsharded_port_table():
    """The reference's own contract, in the port: counts, row sets and
    aggregates of a sharded table equal an unsharded table's."""
    rng = np.random.default_rng(41)
    u, s = TDB(device="cpu", warmup=False), TDB(device="cpu", warmup=False)
    u.execute(f"CREATE TABLE t (k INT, w INT, v INT, INDEX(k)) CAPACITY {CAP}"
              f" MAX_SELECT {CAP}")
    s.execute(f"CREATE TABLE t (k INT, w INT, v INT, INDEX(k)) CAPACITY {CAP}"
              f" MAX_SELECT {CAP} SHARDS 4 PARTITION BY k")
    for i in range(40):
        if i % 5 == 0:
            rows = [(int(rng.integers(0, 12)), int(rng.integers(0, 40)),
                     int(rng.integers(-5, 5))) for _ in range(8)]
            for db in (u, s):
                db.executemany("INSERT INTO t (k, w, v) VALUES (?, ?, ?)",
                               rows)
            continue
        sql, mkp = TEMPLATES[int(rng.integers(0, len(TEMPLATES)))]
        if "LIMIT" in sql:
            continue   # which rows a LIMIT keeps follows (shard, slot)
        p = mkp(rng)
        a, b = u.execute(sql, p), s.execute(sql, p)
        assert a.count == b.count, sql
        if a.rows is None:
            assert b.value == pytest.approx(a.value, rel=1e-5), sql
        elif "ORDER BY" not in sql:
            assert sorted(map(lambda r: sorted(r.items()), a.rows)) == \
                sorted(map(lambda r: sorted(r.items()), b.rows)), sql
    assert u.live_rows("t") == s.live_rows("t")


def test_warmup_plans_every_lane():
    dbs = pair()
    make_t(dbs, 4, "w")
    port = dbs[1]
    sql = "SELECT w FROM t WHERE k = ?"
    n = port.execute(f"WARMUP t LIKE '{sql}'").count
    assert n == 4    # one plan a lane (the reference: one a device)
    assert port.execute(f"WARMUP t LIKE '{sql}'").count == 0
    info = json.loads(port.execute(f"EXPLAIN {sql}").value)
    assert info["preplanned"] is True
    dbs[0].execute(f"WARMUP t LIKE '{sql}'")
    same_json(dbs, f"EXPLAIN {sql}", drop=("executors",))
    fan = "SELECT k FROM t WHERE w = ?"
    assert port.execute(f"WARMUP t LIKE '{fan}'").count == 1
    before = json.loads(port.execute("SHOW STATS t").value)["executors"]
    rng = np.random.default_rng(0)
    insert_batch(dbs, rng)
    for k in range(12):
        run(dbs, "execute", sql, (k,))
    run(dbs, "execute", fan, (3,))
    after = json.loads(port.execute("SHOW STATS t").value)["executors"]
    # the warmed lanes and fan-out replay; only the INSERT batch plans
    assert after["misses"] - before["misses"] == 1


def test_convert_carries_sharded_tables():
    """A reference sharded table (lanes, deferred expiries, counters)
    carried into the port and back: both daemons then agree."""
    rng = np.random.default_rng(3)
    jdb, tdb = pair()
    ddl = (f"CREATE TABLE t (k INT, w INT, v INT, INDEX(w)) CAPACITY {CAP} "
           f"MAX_SELECT 16 TTL 20 OPS_INTERVAL 6 SHARDS 4 PARTITION BY k")
    jdb.execute(ddl)
    for _ in range(3):
        jdb.executemany("INSERT INTO t (k, w, v) VALUES (?, ?, ?)",
                        [(int(rng.integers(0, 12)), int(rng.integers(0, 40)),
                          1) for _ in range(8)])
    for k in range(7):
        jdb.execute("SELECT w FROM t WHERE k = ?", (k,))
    tdb.execute(ddl)
    CV.copy_interner(jdb.interner, tdb.interner)
    CV.load_table(tdb, "t", CV.table_snapshot(jdb.tables["t"]))
    same_shards((jdb, tdb), "t")
    for k in range(12):
        run((jdb, tdb), "execute", "SELECT w, v FROM t WHERE k = ?", (k,))
    run((jdb, tdb), "execute", "UPDATE t SET v = 5 WHERE w = ?", (3,))
    same_shards((jdb, tdb), "t")
    # and back: a fresh reference daemon takes the port's table
    jdb2 = JDB(mesh_exec=False, warmup=False)
    jdb2.execute(ddl)
    snap_t = CV.table_snapshot(tdb.tables["t"])
    CV.load_table(jdb2, "t", snap_t, array=jnp.asarray)
    same_shards((jdb2, tdb), "t")
    run((jdb2, tdb), "execute", "SELECT COUNT(*) FROM t WHERE w < ?", (20,))


# ------------------------------------------------------ scheduler lanes

def _sched_db():
    db = TDB(device="cpu", warmup=False)
    db.execute("CREATE TABLE s (k INT, w INT) CAPACITY 128 SHARDS 4 "
               "PARTITION BY k")
    db.executemany("INSERT INTO s (k, w) VALUES (?, ?)",
                   [(i, i % 3) for i in range(24)])
    return db


def test_scheduler_lane_splits_give_sequential_counts():
    async def main():
        db = _sched_db()
        sched = BatchScheduler(db, concurrency=True)
        await sched.start()
        res = await asyncio.gather(*[
            sched.submit("SELECT k, w FROM s WHERE k = ?", (i,))
            for i in range(8)])
        for i, r in enumerate(res):
            assert r.count == 1 and r.rows[0]["k"] == i
        assert sched.stats["lane_splits"] >= 1
        assert sched.stats["lane_dispatches"] >= 1
        res = await asyncio.gather(*[
            sched.submit("DELETE FROM s WHERE k = ?", (k,))
            for k in (1, 1, 2, 3, 6)])
        assert [r.count for r in res] == [1, 0, 1, 1, 1]
        await sched.stop()
        assert db.execute("SELECT COUNT(*) FROM s").value == 20

    asyncio.run(main())


def test_scheduler_keeps_fanout_group_whole():
    async def main():
        db = _sched_db()
        sched = BatchScheduler(db)
        await sched.start()
        before = sched.stats["lane_splits"]
        res = await asyncio.gather(*[
            sched.submit("SELECT COUNT(*) FROM s WHERE w = ?", (i,))
            for i in range(3)])
        assert [r.value for r in res] == [8, 8, 8]
        assert sched.stats["lane_splits"] == before
        await sched.stop()

    asyncio.run(main())
    db = _sched_db()
    shape = db.shape_key("SELECT w FROM s WHERE k = ?")
    assert db.group_lane(shape, [(1,), (1,)]) == TSH.shard_of_host(1, 4)
    assert db.item_lanes(shape, [(1,), (2,)]) == [
        TSH.shard_of_host(1, 4), TSH.shard_of_host(2, 4)]
    assert db.group_shard_ids(shape, [(1,), (2,)]) == frozenset(
        TSH.shard_of_host(k, 4) for k in (1, 2))
    fan = db.shape_key("SELECT w FROM s WHERE w = ?")
    assert db.group_lane(fan, [(1,)]) is None
    assert db.group_shard_ids(fan, [(1,)]) is None


# ------------------------------------- pruned indexed UPDATE, lanes off

def test_pruned_indexed_update_rebuilds_only_its_shard():
    """With lane_exec=False a pruned UPDATE of an indexed column rebuilds
    that index on the routed shard only, as the reference does: shard 0's
    overflowed index keeps its 12 overflow rows (EXPLAIN's ``stale``)
    while the UPDATE lands on shard 1."""
    dbs = pair(lane_exec=False)
    run(dbs, "execute", "CREATE TABLE t (k INT, w INT, INDEX(w)) CAPACITY "
                        "1024 MAX_SELECT 8 SHARDS 2 PARTITION BY k")
    s0 = [k for k in range(4000) if TSH.shard_of_host(k, 2) == 0][:140]
    s1 = [k for k in range(s0[30], 4000)
          if TSH.shard_of_host(k, 2) == 1][:20]
    run(dbs, "executemany", "INSERT INTO t (k, w) VALUES (?, ?)",
        [(k, 7) for k in s0 + s1])
    assert run(dbs, "execute", "DELETE FROM t WHERE k < ?",
               (s0[30],))["count"] == 30
    run(dbs, "execute", "UPDATE t SET w = w + 1 WHERE k = ?", (s1[3],))
    plan = same_json(dbs, "EXPLAIN SELECT k FROM t WHERE w = ?")
    assert plan["stale"] == 12
    assert run(dbs, "execute", "SELECT COUNT(*) FROM t WHERE w = ?",
               (7,))["value"] == 129
    same_shards(dbs, "t")


@pytest.mark.parametrize("index", ["w", "v"])
def test_pruned_indexed_updates_keep_every_shard_lanes_off(index):
    """A stream of pruned UPDATEs that write an indexed column (and some
    that do not) between DELETEs and narrow INSERTs that reuse freed
    slots (so index upkeep order is not row order), under
    lane_exec=False: each shard's whole state, its index lanes included,
    equals the reference's after every UPDATE."""
    rng = np.random.default_rng(61)
    dbs = pair(lane_exec=False)
    make_t(dbs, 4, index)
    for _ in range(3):
        insert_batch(dbs, rng)
    for i in range(10):
        run(dbs, "execute", "DELETE FROM t WHERE w < ?",
            (int(rng.integers(0, 8)),))
        insert_batch(dbs, rng)
        k = int(rng.integers(0, 12))
        col = index if i % 3 else ("v" if index == "w" else "w")
        run(dbs, "execute", f"UPDATE t SET {col} = {col} + ? WHERE k = ?",
            (int(rng.integers(1, 4)), k))
        same_shards(dbs, "t")
    run(dbs, "execute", f"SELECT k, w, v FROM t WHERE {index} = ?", (3,))
