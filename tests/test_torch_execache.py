"""The port's executor cache (core/execache.py) against the reference's.

Every test runs the same seeded statements through the reference, built
as ``repro.core.SQLCached(mesh_exec=False, warmup=False)``, and through the
port, ``repro_torch.core.SQLCached(device="cpu", warmup=False)``: WARMUP's
count and value, the ``executors`` block of ``SHOW STATS`` (key for key,
``compile_ms_total`` aside: a compile and a capture take different
times), EXPLAIN's ``preplanned``, every result and the whole table states
must match. These are the monolithic cases of tests/test_execache.py.
Then the port's own invariants: the table's tensors keep their addresses,
a Result owns its outputs, and a plan is keyed by its bound values' types,
never by the values."""
import asyncio
import json

import jax
import numpy as np
import pytest

from repro.core.daemon import SQLCached as JDB
from repro.core.execache import ExecutorCache as JCache
from repro.core.scheduler import BatchScheduler as JSched
from repro_torch import convert as CV
from repro_torch.core import sqlparse as TS
from repro_torch.core.daemon import SQLCached as TDB
from repro_torch.core.execache import ExecutorCache as TCache
from repro_torch.core.scheduler import BatchScheduler as TSched

DDL = "CREATE TABLE t (k INT, v INT, INDEX(k)) CAPACITY {cap}"


def pair(cap=256, warmup=False, ddl=DDL):
    dbs = (JDB(mesh_exec=False, warmup=warmup), TDB(device="cpu",
                                                     warmup=warmup))
    for db in dbs:
        db.execute(ddl.format(cap=cap))
    return dbs


def block(db, table="t"):
    st = json.loads(db.execute(f"SHOW STATS {table}").value)["executors"]
    assert st.pop("compile_ms_total") >= 0
    return st


def same_block(dbs, table="t"):
    """The executors blocks of both daemons, key for key."""
    want, got = (block(db, table) for db in dbs)
    assert got == want
    return got


def snap(r):
    if isinstance(r, list):
        return [snap(x) for x in r]
    ids = r.row_ids
    return {"count": r.count, "value": r.value, "rows": r.rows,
            "row_ids": None if ids is None else np.asarray(ids).tolist()}


def run(dbs, kind, sql, *args):
    out = [snap(getattr(db, kind)(sql, *args)) for db in dbs]
    assert out[1] == out[0]
    return out[1]


def same_tables(dbs, *names):
    jdb, tdb = dbs
    for nm in names:
        want = jax.tree.map(np.asarray, jdb.table_state(nm))
        np.testing.assert_equal(CV.state_to_numpy(tdb.table_state(nm)), want)


def warmup(dbs, sql):
    """WARMUP on both: the same count and epoch."""
    out = [(r.count, r.value) for r in (db.execute(sql) for db in dbs)]
    assert out[1] == out[0]
    return out[1]


def fill(dbs, n=24):
    run(dbs, "executemany", "INSERT INTO t (k, v) VALUES (?, ?)",
        [(i % 12, i) for i in range(n)])


# ------------------------------------------------------- cache unit tests

@pytest.mark.parametrize("cls", [JCache, lambda: TCache("cpu")],
                         ids=["ref", "port"])
def test_cache_get_memoizes_and_bump_retires(cls):
    c = cls()   # the port's cache takes its device explicitly
    built = []

    def builder():
        built.append(1)
        return lambda *a: a

    e1 = c.get(("select", "shape"), builder)
    assert c.get(("select", "shape"), builder) is e1 and len(built) == 1
    sig = ("select", "shape", None, "mono", ("dev", 0))
    c.note_sig(sig)
    assert c.has_sig(sig)
    assert c.bump() == 1
    # same key, new epoch: a rebuilt entry, and the signatures went with it
    assert c.get(("select", "shape"), builder) is not e1 and len(built) == 2
    assert not c.has_sig(sig)


def test_cache_stats_shape():
    want, got = JCache().stats_dict(), TCache("cpu").stats_dict()
    assert got == want
    assert got["cached"] == 0 and got["epoch"] == 0


# ----------------------------------------------------- WARMUP + zero-recompile

def test_warmup_counts_then_idempotent():
    dbs = pair()
    assert warmup(dbs, "WARMUP t") == (3, 0)
    assert warmup(dbs, "WARMUP t") == (0, 0)
    like = "WARMUP t LIKE 'SELECT COUNT(*) FROM t WHERE k = ?'"
    assert warmup(dbs, like) == (1, 0)
    assert warmup(dbs, like) == (0, 0)
    assert same_block(dbs)["misses"] == 0
    # warm-up touched no contents, clock or op count
    same_tables(dbs, "t")
    assert [json.loads(db.execute("SHOW STATS t").value)["host_ops"]
            for db in dbs] == [0, 0]


def test_zero_recompiles_mono():
    dbs = pair()
    warmup(dbs, "WARMUP t")
    st0 = same_block(dbs)
    assert st0["cached"] > 0 and st0["hits"] == 0
    for rep in range(3):
        run(dbs, "execute", "INSERT INTO t (k, v) VALUES (?, ?)",
            (rep, rep * 10))
        run(dbs, "execute", "SELECT * FROM t WHERE k = ?", (rep,))
        run(dbs, "execute", "DELETE FROM t WHERE k = ?", (rep,))
    st1 = same_block(dbs)
    assert st1["compiles"] == st0["compiles"]
    assert st1["misses"] == 0 and st1["fallbacks"] == 0
    assert st1["hits"] == 9
    # batches of one bucket share one executor whatever their count
    for n in (3, 4, 3):
        run(dbs, "executemany", "UPDATE t SET v = v + 1 WHERE k = ?",
            [(i,) for i in range(n)])
        run(dbs, "executemany", "SELECT v FROM t WHERE k = ?",
            [(i,) for i in range(n)])
    st2 = same_block(dbs)
    assert st2["compiles"] == st1["compiles"] + 2
    same_tables(dbs, "t")


def test_create_time_background_warmup():
    dbs = pair(warmup=True)
    for db in dbs:
        db.drain_warmup("t")
    assert same_block(dbs)["cached"] > 0
    # everything the canonical set covers is already planned
    assert warmup(dbs, "WARMUP t") == (0, 0)
    same_tables(dbs, "t")


def test_explain_reports_preplanned():
    dbs = pair()

    def preplanned(sql):
        out = [json.loads(db.execute(f"EXPLAIN {sql}").value)["preplanned"]
               for db in dbs]
        assert out[1] == out[0]
        return out[1]

    assert preplanned("SELECT * FROM t WHERE k = ?") is False
    assert preplanned("INSERT INTO t (k, v) VALUES (?, ?)") is False
    warmup(dbs, "WARMUP t")
    assert preplanned("SELECT * FROM t WHERE k = ?") is True
    # a shape outside the canonical set stays unplanned until it is served
    assert preplanned("SELECT * FROM t WHERE v = ?") is False
    assert preplanned("INSERT INTO t (k, v) VALUES (?, ?)") is True
    run(dbs, "execute", "SELECT * FROM t WHERE v = ?", (1,))
    assert preplanned("SELECT * FROM t WHERE v = ?") is True


def test_warmup_unknown_table_errors():
    from repro.core.sqlparse import SQLError
    for db, err in ((JDB(mesh_exec=False, warmup=False), SQLError),
                    (TDB(device="cpu", warmup=False), TS.SQLError)):
        with pytest.raises(err):
            db.execute("WARMUP nope")


# ------------------------------------------------------------ invalidation

def test_reindex_bumps_epoch():
    dbs = pair()
    warmup(dbs, "WARMUP t")
    fill(dbs)
    st0 = same_block(dbs)
    run(dbs, "execute", "REINDEX t")
    st1 = same_block(dbs)
    assert st1["epoch"] == st0["epoch"] + 1
    assert run(dbs, "execute", "SELECT COUNT(*) FROM t WHERE k = ?",
               (3,))["value"] == 2
    same_block(dbs)
    # the retired plans are gone: EXPLAIN and WARMUP start over
    assert warmup(dbs, "WARMUP t") == (3, 1)
    same_tables(dbs, "t")


def test_flush_keeps_epoch_and_executables():
    dbs = pair()
    warmup(dbs, "WARMUP t")
    fill(dbs)
    st0 = same_block(dbs)
    run(dbs, "execute", "FLUSH t")
    assert run(dbs, "execute", "SELECT COUNT(*) FROM t")["value"] == 0
    st1 = same_block(dbs)
    assert st1["epoch"] == st0["epoch"]
    assert st1["cached"] >= st0["cached"]
    run(dbs, "execute", "INSERT INTO t (k, v) VALUES (?, ?)", (1, 2))
    run(dbs, "execute", "SELECT * FROM t WHERE k = ?", (1,))
    st2 = same_block(dbs)
    assert st2["compiles"] == st1["compiles"] and st2["fallbacks"] == 0
    same_tables(dbs, "t")


def test_drop_create_gets_fresh_cache():
    dbs = pair()
    warmup(dbs, "WARMUP t")
    assert same_block(dbs)["cached"] > 0
    for db in dbs:
        db.execute("DROP TABLE t")
        db.execute("CREATE TABLE t (k INT, v INT, INDEX(k)) CAPACITY 64")
    assert same_block(dbs)["cached"] == 0


# ------------------------------------------------------ scheduler admission

def test_scheduler_solos_cold_groups():
    async def main(db, sched_cls):
        sched = sched_cls(db)
        await sched.start()
        # nothing warmed: the two differently-shaped groups are cold and
        # are kept out of warm waves even though they would commute
        futs = [sched.submit("INSERT INTO t (k, v) VALUES (?, ?)", (1, 1)),
                sched.submit("SELECT v FROM t WHERE k = ?", (1,))]
        await asyncio.gather(*futs)
        base = sched.stats["cold_solo"]
        db.execute("WARMUP t")
        futs = [sched.submit("INSERT INTO t (k, v) VALUES (?, ?)", (2, 2)),
                sched.submit("SELECT v FROM t WHERE k = ?", (2,))]
        await asyncio.gather(*futs)
        after = sched.stats["cold_solo"]
        await sched.stop()
        return base, after

    jdb, tdb = pair()
    want = asyncio.run(main(jdb, JSched))
    got = asyncio.run(main(tdb, TSched))
    assert got == want
    base, after = got
    assert base >= 2 and after == base   # warmed shapes join waves again
    same_block((jdb, tdb))


def test_group_warm_tolerates_unknown():
    dbs = pair()
    for db in dbs:
        # admin / unknown shapes are never reported cold
        assert db.group_warm(None, []) is True
        assert db.group_warm(db.shape_key("FLUSH t"), []) is True
        sh = db.shape_key("SELECT * FROM t WHERE k = ?")
        assert db.group_warm(sh, [(1,)]) is False
        db.execute("WARMUP t")
        assert db.group_warm(sh, [(1,)]) is True
        ins = db.shape_key("INSERT INTO t (k, v) VALUES (?, ?)")
        assert db.group_warm(ins, [(1, 1)]) is True
        assert db.group_warm(ins, [(1, 1), (2, 2)]) is False


# ------------------------------------------------- the port's own invariants

def _ptrs(state, out=None, path=""):
    out = {} if out is None else out
    for k, v in state.items():
        if isinstance(v, dict):
            _ptrs(v, out, f"{path}/{k}")
        else:
            out[f"{path}/{k}"] = v.data_ptr()
    return out


def test_state_keeps_its_addresses():
    """Between epoch bumps every tensor of the table's state stays where it
    is: a mixed stream, FLUSH, EXPIRE, advance_clock and swap_table_state
    all write into the same tensors. The reference agrees on the contents
    after each step."""
    ddl = ("CREATE TABLE t (k INT, v INT, s TEXT, PAYLOAD p TENSOR(3) F32, "
           "INDEX(k)) CAPACITY {cap} MAX_SELECT 8 TTL 30 OPS_INTERVAL 7")
    dbs = pair(cap=64, ddl=ddl)
    tdb = dbs[1]
    ptrs = _ptrs(tdb.table_state("t"))
    rng = np.random.default_rng(0)
    rows = [(int(rng.integers(0, 9)), i, f"s{i}") for i in range(40)]
    pls = [{"p": rng.random(3).astype(np.float32)} for _ in rows]
    run(dbs, "executemany", "INSERT INTO t (k, v, s) VALUES (?, ?, ?)",
        rows, pls)
    run(dbs, "execute", "SELECT k, v, s FROM t WHERE k = ?", (3,))
    run(dbs, "execute", "SELECT PAYLOAD(p), v FROM t WHERE s = ?", ("s5",))
    run(dbs, "execute", "SELECT SUM(v) FROM t WHERE k < ?", (5,))
    run(dbs, "execute", "UPDATE t SET k = k + 1 WHERE v < ?", (10,))
    run(dbs, "execute", "DELETE FROM t WHERE k = ?", (4,))
    run(dbs, "executemany", "DELETE FROM t WHERE s = ?",
        [("s11",), ("s12",), ("nope",)])
    run(dbs, "executemany", "SELECT v FROM t WHERE k = ?",
        [(1,), (2,), (7,)])
    same_tables(dbs, "t")
    assert _ptrs(tdb.table_state("t")) == ptrs
    for db in dbs:
        db.advance_clock(40, "t")
    run(dbs, "execute", "EXPIRE t")
    same_tables(dbs, "t")
    assert _ptrs(tdb.table_state("t")) == ptrs
    run(dbs, "execute", "FLUSH t")
    same_tables(dbs, "t")
    assert _ptrs(tdb.table_state("t")) == ptrs
    jdb = dbs[0]
    run(dbs, "executemany", "INSERT INTO t (k, v, s) VALUES (?, ?, ?)",
        rows[:9])
    tdb.execute("FLUSH t")   # then the reference's contents come back in
    tdb.swap_table_state("t", CV.state_from_numpy(
        jax.tree.map(np.asarray, jdb.table_state("t")), tdb.device))
    same_tables(dbs, "t")
    assert _ptrs(tdb.table_state("t")) == ptrs
    run(dbs, "execute", "SELECT k, v FROM t WHERE k = ?", (3,))


def test_result_owns_its_outputs():
    """A Result read after three later statements of the same shape still
    holds its own values (the plan's outputs are rewritten by each run)."""
    dbs = pair()
    fill(dbs)
    sql = "SELECT k, v FROM t WHERE k = ?"
    first = [(db.execute(sql, (3,)), db.executemany(sql, [(4,), (5,)]),
              db.execute("DELETE FROM t WHERE k = ?", (6,)))
             for db in dbs]
    for db in dbs:
        db.execute(sql, (7,))
        db.executemany(sql, [(8,), (9,)])
        db.execute("DELETE FROM t WHERE k = ?", (1,))
    want, got = ([snap(r) for r in rs] for rs in first)
    assert got == want
    assert [r["k"] for r in got[0]["rows"]] == [3, 3]
    same_tables(dbs, "t")


def test_plans_keyed_by_type_not_value():
    """Two statements of one shape with different keys answer for their
    own keys; an int and a float bound value take their own routes (a float
    bound to an int column scans with exact compares)."""
    dbs = pair()
    fill(dbs)
    sql = "SELECT v FROM t WHERE k = ?"
    for k in (3, 5, 3.0, 3.5, 5):
        run(dbs, "execute", sql, (k,))
    run(dbs, "executemany", sql, [(2,), (4,)])
    run(dbs, "executemany", sql, [(2.0,), (4.5,)])
    run(dbs, "execute", "UPDATE t SET v = v + ? WHERE k = ?", (1.5, 2))
    run(dbs, "execute", "UPDATE t SET v = v + ? WHERE k = ?", (2, 2.0))
    run(dbs, "execute", "DELETE FROM t WHERE k = ?", (5.0,))
    run(dbs, "execute", "DELETE FROM t WHERE k = ?", (6,))
    same_tables(dbs, "t")
    # one entry a shape; the port plans each type class of its values
    tdb = dbs[1]
    entries = tdb.tables["t"].execs._entries.values()
    assert max(len(e.compiled) for e in entries) == 2


def test_ops_interval_plans_both_variants_as_one():
    """An op-interval table's plans cover the expiry flag's both values and
    count as one executable, as the reference's runtime flag does; the
    expiry fires at the reference's statements."""
    ddl = ("CREATE TABLE t (k INT, v INT, INDEX(k)) CAPACITY {cap} "
           "TTL 3 OPS_INTERVAL 4")
    dbs = pair(cap=64, ddl=ddl)
    assert warmup(dbs, "WARMUP t") == (3, 0)
    for i in range(12):
        run(dbs, "execute", "INSERT INTO t (k, v) VALUES (?, ?)", (i % 5, i))
        run(dbs, "execute", "SELECT * FROM t WHERE k = ?", (i % 5,))
    run(dbs, "executemany", "DELETE FROM t WHERE k = ?", [(1,), (2,), (3,)])
    st = same_block(dbs)
    assert st["misses"] == 1 and st["cached"] == st["compiles"] == 4
    same_tables(dbs, "t")


def test_retired_entry_warms_nothing():
    """An entry a warm-up still holds when the epoch moves on (RESTORE or
    RESHARD while a CREATE-time warm-up runs) plans nothing more; the
    current epoch's entry for the same key plans as usual."""
    import torch

    def body(st, flag, a):
        return dict(st, x=st["x"] + a), st["x"].sum()

    cache = TCache("cpu", lambda: {"x": torch.zeros(4)})
    state = {"x": torch.zeros(4)}
    args = (np.ones(4, np.float32),)
    old = cache.get("k", lambda: body)
    cache.bump()
    assert old.warm(state, args) is False and not old.compiled
    new = cache.get("k", lambda: body)
    assert new is not old and new.epoch == old.epoch + 1
    assert new.warm(state, args) is True
    assert torch.equal(state["x"], torch.zeros(4))   # warm-up wrote nothing
