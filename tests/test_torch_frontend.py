"""The port's front end against the reference: the same SQL parses to
structurally equal statements, and the same WHERE lowers to the same
plan and the same EXPLAIN payload (host Python on both sides, so
equality is exact)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import planner as JPL
from repro.core import schema as JSC
from repro.core import sqlparse as JS
from repro_torch.core import planner as TPL
from repro_torch.core import schema as TSC
from repro_torch.core import sqlparse as TS

STATEMENTS = [
    "CREATE TABLE t (a INT, b TEXT, c FLOAT)",
    "CREATE TABLE kv (seq INT, PAYLOAD blk TENSOR(16,2,8,64) BF16) "
    "CAPACITY 256 MAX_SELECT 16 TTL 9 MAX_ROWS 100 OPS_INTERVAL 8",
    "INSERT INTO t (a, b) VALUES (?, 'x''y') TTL 50",
    "SELECT a, PAYLOAD(kv), b FROM t WHERE a = ? AND b BETWEEN 2 AND 7 "
    "ORDER BY b DESC LIMIT 10",
    "SELECT COUNT(*) FROM t",
    "SELECT AVG(a) FROM t WHERE a > 3",
    "UPDATE t SET a = a + 1, TTL = 200 WHERE b = ?",
    "DELETE FROM t WHERE u = 3",
    "EXPIRE t", "FLUSH t", "REINDEX t", "DROP TABLE t",
    "SELECT a FROM t WHERE a = 1 OR b = 2 AND c = 3",
    "SELECT a FROM t WHERE a + 2 * 3 = 7",
    "SELECT a FROM t WHERE NOT a IN (1, 2, 3)",
    "SELECT a FROM t WHERE a = ? AND b = ? AND c = ?",
    "CREATE TABLE t (a INT, INDEX(a), b TEXT, INDEX(b)) CAPACITY 64",
    "CREATE TABLE t (index INT)",
    "CREATE TABLE t (a INT, b INT) CAPACITY 128 SHARDS 4 PARTITION BY b",
    "CREATE TABLE t (a INT) SHARDS(2) CAPACITY 64 REPLICAS 2",
    "EXPLAIN SELECT a FROM t WHERE a = ?",
    "EXPLAIN DELETE FROM t WHERE a = 1",
    "EXPLAIN FLUSH t",
    "EXPLAIN t",
    "EXPLAIN ANALYZE SELECT a FROM t WHERE a = 2",
    "SELECT a FROM t WHERE a = -3 AND b = 2.5e2",
    "SHOW STATS", "SHOW STATS t", "SHOW METRICS t FORMAT 'prom'",
    "SHOW SLOW",
    "ALTER TABLE t RESHARD 4", "ALTER TABLE t RETAIN SLOTS 3,0 OF 8",
    "CHECKPOINT t TO '/tmp/x'", "RESTORE t FROM '/tmp/x'",
    "WARMUP t LIKE 'SELECT a FROM t WHERE a = ?'",
    "SELECT a FROM t WHERE ABS(a) < MIN(b, 3) AND MAX(a, b) >= ?",
]

BAD = ["SELECT a FROM", "CREATE TABLE t (a NOTATYPE)", "INSERT INTO t VALUES",
       "SELECT a FROM t WHERE", "SELECT a FROM t extra garbage",
       "SELECT a FROM t WHERE a @ 3", "EXPLAIN", "CREATE TABLE t (a INT) SHARDS"]


def norm(x):
    """A structural, module-independent view of a parsed statement / AST /
    plan: class name + normalized fields."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, norm(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(norm(v) for v in x)
    return x


@pytest.mark.parametrize("sql", STATEMENTS)
def test_same_ast(sql):
    assert norm(TS.parse(sql)) == norm(JS.parse(sql))


@pytest.mark.parametrize("sql", BAD)
def test_same_errors(sql):
    with pytest.raises(JS.SQLError) as je:
        JS.parse(sql)
    with pytest.raises(TS.SQLError) as te:
        TS.parse(sql)
    assert str(te.value) == str(je.value)


def test_payload_dtypes_are_torch():
    assert TS._PAYLOAD_DTYPES["BF16"] == torch.bfloat16
    assert set(TS._PAYLOAD_DTYPES) == set(JS._PAYLOAD_DTYPES)


def _schemas(indexes=("k",)):
    cols = [("k", "INT"), ("w", "INT"), ("f", "FLOAT"), ("s", "TEXT"),
            ("big", "BIGINT"), ("d", "DOUBLE")]
    return (JSC.make_schema("t", cols, capacity=256, indexes=indexes),
            TSC.make_schema("t", cols, capacity=256, indexes=indexes))


WHERES = [
    None,
    "k = ?", "k = 5", "w = ?", "k < ?", "f > 0.5", "k = 1 OR w = 2",
    "k = ? AND w >= ?", "k = ? AND w BETWEEN ? AND ?",
    "w BETWEEN 1 AND 4 AND s = ? AND k != 2",
    "k = ? AND w > 0 AND w > 1 AND w > 2 AND w > 3 AND w > 4",
    "w > 0 AND w > 1 AND w > 2 AND w > 3 AND w > 4",
    "big = ?", "d = 1", "s = 'x'", "_created < ?", "5 = k",
    "NOT k = 1", "k IN (1, 2)",
]


@pytest.mark.parametrize("where", WHERES)
@pytest.mark.parametrize("ranked", [False, True])
def test_same_plan_and_explain(where, ranked):
    js, ts = _schemas()
    jw = None if where is None else JS.parse(f"SELECT k FROM t WHERE {where}").where
    tw = None if where is None else TS.parse(f"SELECT k FROM t WHERE {where}").where
    assert norm(TPL.plan_where(ts, tw, ranked)) == norm(
        JPL.plan_where(js, jw, ranked))
    assert TPL.explain(ts, tw, ranked) == JPL.explain(js, jw, ranked)
    assert TPL.columns_of(tw) == JPL.columns_of(jw)


def test_schema_widths_and_validation():
    js, ts = _schemas()
    for jc, tc in zip(js.columns, ts.columns):
        # stored widths mirror the reference's 64-bit-off storage
        assert np.dtype(jc.dtype).itemsize >= tc.dtype.itemsize
        assert tc.dtype in (torch.int32, torch.float32, torch.bool)
    with pytest.raises(ValueError):
        TSC.make_schema("t", [("big", "BIGINT")], indexes=("big",))
    with pytest.raises(ValueError):
        JSC.make_schema("t", [("big", "BIGINT")], indexes=("big",))
