"""The port's mesh-placed sharded tables against the JAX reference on the
CPU (the cases of tests/test_mesh_parity.py).

The reference's own placed fan-out breaks on jax 0.9.0
(``parallel/sharding.py``), and its contract is that a placed table equals
the unplaced one. So the port's PLACED daemon (``SQLCached(device="cpu")``
with eight visible devices forced through ``launch.mesh``'s device-count
seam: every mesh entry is the CPU, and each block still owns its tensors,
runs its own executors and merges on the home entry) is held against the
reference's unplaced daemon (``mesh_exec=False``): every count, row (in
order), row id and value, each shard's raw state, the lazy-clock
bookkeeping and the caught-up snapshot (``same_shards``). Float
aggregates use rtol=1e-5 (summation order)."""
import json

import numpy as np
import pytest
import torch

from repro.core.daemon import SQLCached as JDB
from repro_torch import convert as CV
from repro_torch.core import shards as TSH
from repro_torch.core.daemon import SQLCached as TDB
from repro_torch.launch import mesh as M

from test_torch_shards import same_json, same_shards

CAP = 256
COLS = "(k INT, w INT, v INT"


@pytest.fixture(autouse=True)
def eight_devices():
    """The device-count seam: lane meshes of up to 8 entries."""
    with M.force_device_count(8):
        yield


def _mk_pair(shards: int, indexed: bool, ttl_default: int = 0,
             cap: int = CAP, extra_opts: str = ""):
    opts = f" TTL {ttl_default}" if ttl_default else ""
    idx = ", INDEX(k)" if indexed else ""
    dbs = (JDB(mesh_exec=False, warmup=False),
           TDB(device="cpu", warmup=False))
    for db in dbs:
        db.execute(f"CREATE TABLE t {COLS}{idx}) CAPACITY {cap} "
                   f"MAX_SELECT {cap}{opts}{extra_opts} "
                   f"SHARDS {shards} PARTITION BY k")
    t = dbs[1].tables["t"]
    assert t.mesh is not None and len(t.mesh) == min(shards, 8)
    assert t.state is None and len(t.blocks) == len(t.mesh)
    return dbs


def _insert_batch(dbs, rng, ttl=False):
    m = int(rng.integers(3, 12))
    rows = [(int(rng.integers(0, 12)), int(rng.integers(0, 40)),
             int(rng.integers(-5, 5))) for _ in range(m)]
    sql = "INSERT INTO t (k, w, v) VALUES (?, ?, ?)"
    if ttl:
        sql += " TTL ?"
        rows = [r + (int(rng.integers(1, 8)),) for r in rows]
    outs = [db.executemany(sql, rows) for db in dbs]
    assert outs[0].count == outs[1].count == m
    np.testing.assert_array_equal(outs[1].row_ids, outs[0].row_ids)


def _same(res_j, res_t):
    """Counts, rows in order, row ids and values equal (floats to 1e-5)."""
    assert res_t.count == res_j.count
    if res_j.rows is None:
        if isinstance(res_j.value, float):
            assert res_t.value == pytest.approx(res_j.value, rel=1e-5)
        else:
            assert res_t.value == res_j.value
        return
    assert res_t.rows == res_j.rows
    if res_j.row_ids is not None:
        np.testing.assert_array_equal(res_t.row_ids, res_j.row_ids)


def _p_key(rng):
    return (int(rng.integers(0, 12)),)


def _p_w(rng):
    return (int(rng.integers(0, 40)),)


TEMPLATES = [
    ("SELECT k, w, v FROM t WHERE k = ?", _p_key),          # pruned probe
    ("SELECT k, w FROM t WHERE w = ?", _p_w),               # fan-out eq
    ("SELECT k, w FROM t WHERE k = ? AND w >= ?",
     lambda r: (_p_key(r)[0], _p_w(r)[0])),                 # pruned+residual
    ("SELECT k, w FROM t WHERE w BETWEEN ? AND ?",
     lambda r: tuple(sorted((_p_w(r)[0], _p_w(r)[0] + 10)))),
    ("SELECT k, w FROM t ORDER BY w DESC LIMIT 7", lambda r: ()),
    ("SELECT k, v FROM t WHERE w > ? ORDER BY v LIMIT 5", _p_w),
    ("SELECT COUNT(*) FROM t WHERE k = ?", _p_key),
    ("SELECT SUM(w) FROM t WHERE w < ?", _p_w),
    ("SELECT AVG(w) FROM t WHERE k = ?", _p_key),
    ("SELECT AVG(v) FROM t WHERE w > ?", _p_w),
    ("SELECT MIN(v) FROM t", lambda r: ()),
    ("SELECT MAX(w) FROM t WHERE k = ?", _p_key),
    ("UPDATE t SET w = w + 3 WHERE k = ?", _p_key),         # pruned update
    ("UPDATE t SET v = v * 2 WHERE w = ?", _p_w),           # fan-out update
    ("DELETE FROM t WHERE k = ?", _p_key),                  # pruned delete
    ("DELETE FROM t WHERE w = ?", _p_w),                    # fan-out delete
]


# ------------------------------------------------------------ the mesh

@pytest.mark.parametrize("n_shards,n_devices,want", [
    (8, 3, 2), (6, 4, 3), (5, 4, None), (8, 8, 8), (4, 8, 4), (2, 1, None),
    (1, 8, None)])
def test_lane_mesh_for_divisor_rule(n_shards, n_devices, want):
    mesh = M.lane_mesh_for(n_shards, n_devices, home="cpu")
    if want is None:
        assert mesh is None
    else:
        assert mesh == (torch.device("cpu"),) * want
        # cached: one object a device count
        assert M.lane_mesh_for(n_shards, n_devices, home="cpu") is mesh


def test_visible_devices_seam():
    assert M.visible_devices("cpu") == 8          # the fixture's
    with M.force_device_count(3):
        assert M.visible_devices("cpu") == 3
        assert len(M.lane_mesh_for(6, home="cpu")) == 3
    assert M.visible_devices("cpu") == 8


def test_place_lanes_blocks_and_lane_views():
    from repro_torch.core.schema import make_schema
    sch = make_schema("t", [("k", "INT")], capacity=64, shards=4,
                      partition_by="k")
    st = TSH.init_state(sch, "cpu")
    st["cols"]["k"].copy_(torch.arange(64, dtype=torch.int32).reshape(4, 16))
    mesh = M.lane_mesh_for(4, 2, home="cpu")
    blocks = TSH.place_lanes(mesh, st)
    assert [b["valid"].shape for b in blocks] == [(2, 16), (2, 16)]
    # each block owns its storage, like a block on its own card
    assert blocks[0]["cols"]["k"].data_ptr() != st["cols"]["k"].data_ptr()
    lanes = TSH.disassemble_lanes(mesh, 4, blocks)
    for i, lane in enumerate(lanes):
        assert torch.equal(lane["cols"]["k"], st["cols"]["k"][i])
    lanes[3]["cols"]["k"][0] = -1          # a lane is a view of its block
    assert int(blocks[1]["cols"]["k"][1, 0]) == -1
    assert [d for d, _ in TSH.assemble_lanes(mesh, blocks)] == list(mesh)
    assert TSH.lane_devices(mesh, 4) == [torch.device("cpu")] * 4
    np.testing.assert_array_equal(
        TSH.gather_lanes(blocks, "cpu")["cols"]["k"].numpy()[:3],
        st["cols"]["k"].numpy()[:3])
    flat = TSH.flat_state(st)
    assert flat["valid"].shape == (64,) and flat["clock"].dim() == 0
    assert TSH.flat_schema(sch).capacity == 64


def test_mesh_off_keeps_tables_unplaced(monkeypatch):
    for kw in ({"mesh_exec": False}, {}):
        if not kw:
            monkeypatch.setenv("REPRO_MESH", "0")
        db = TDB(device="cpu", warmup=False, **kw)
        db.execute("CREATE TABLE t (k INT) CAPACITY 64 SHARDS 4 "
                   "PARTITION BY k")
        t = db.tables["t"]
        assert t.mesh is None and t.blocks is None and t.state is not None


# ------------------------------------------------------- parity streams

@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("indexed", [False, True])
def test_random_stream_parity(shards, indexed):
    rng = np.random.default_rng(31 + 100 * shards + int(indexed))
    dbs = _mk_pair(shards, indexed)
    _insert_batch(dbs, rng)
    for _ in range(14):
        op = rng.integers(0, 5)
        if op == 0:
            _insert_batch(dbs, rng)
            continue
        sql, mkp = TEMPLATES[int(rng.integers(0, len(TEMPLATES)))]
        params = mkp(rng)
        _same(*(db.execute(sql, params) for db in dbs))
    same_shards(dbs, "t")


def test_batched_paths_parity():
    rng = np.random.default_rng(7)
    dbs = _mk_pair(4, indexed=True)
    _insert_batch(dbs, rng)
    _insert_batch(dbs, rng)
    qs = [(k,) for k in (0, 3, 9, 42)]
    for sql in ("SELECT w FROM t WHERE k = ?",
                "SELECT w, v FROM t WHERE w = ?",
                "SELECT k, w FROM t WHERE w > ? ORDER BY w DESC LIMIT 3",
                "SELECT COUNT(*) FROM t WHERE k = ?",
                "SELECT SUM(w) FROM t WHERE k = ?",
                "SELECT MAX(v) FROM t WHERE w > ?"):
        for r_j, r_t in zip(*(db.executemany(sql, qs) for db in dbs)):
            _same(r_j, r_t)
        same_shards(dbs, "t")   # the batch's touch of the returned rows
    upd = [(1,), (3,), (77,)]
    u = [db.executemany("UPDATE t SET w = w + 100 WHERE k = ?", upd,
                        per_statement=True) for db in dbs]
    assert [r.count for r in u[1]] == [r.count for r in u[0]]
    d = [db.executemany("DELETE FROM t WHERE w = ?", [(5,), (6,)])
         for db in dbs]
    assert d[1].count == d[0].count
    d = [db.executemany("DELETE FROM t WHERE v > ?", [(3,), (1,)],
                        per_statement=True) for db in dbs]
    assert [r.count for r in d[1]] == [r.count for r in d[0]]
    same_shards(dbs, "t")


def test_ttl_expire_parity():
    rng = np.random.default_rng(3)
    dbs = _mk_pair(4, indexed=False)
    for _ in range(3):
        _insert_batch(dbs, rng, ttl=True)
    for db in dbs:
        db.advance_clock(4, "t")
    _same(*(db.execute("EXPIRE t") for db in dbs))
    _same(*(db.execute("SELECT k, w FROM t WHERE k = ?", (3,))
            for db in dbs))
    same_shards(dbs, "t")
    _same(*(db.execute("FLUSH t") for db in dbs))
    same_shards(dbs, "t")


def test_ops_interval_stream_parity():
    """Op-count auto-expiry on a placed table: the fired expiry and every
    lane's deferred replay run block by block."""
    rng = np.random.default_rng(23)
    dbs = _mk_pair(4, indexed=False, ttl_default=30,
                   extra_opts=" OPS_INTERVAL 8")
    _insert_batch(dbs, rng)
    for i in range(24):
        k = int(rng.integers(0, 12))
        sql = ("SELECT k, w FROM t WHERE k = ?" if i % 3
               else "SELECT k, w FROM t WHERE w > ?")
        _same(*(db.execute(sql, (k,)) for db in dbs))
        if i % 10 == 9:
            _insert_batch(dbs, rng)
    same_shards(dbs, "t")
    for db in dbs:
        db.execute("EXPIRE t")
    _same(*(db.execute("SELECT k, w, v FROM t") for db in dbs))
    same_shards(dbs, "t")


def test_reshard_across_device_counts():
    """RESHARD re-splits through the home device and re-places on the new
    shard count's mesh (4 -> 8 -> 2 -> 1 -> 4)."""
    rng = np.random.default_rng(41)
    dbs = _mk_pair(4, indexed=True)
    for _ in range(3):
        _insert_batch(dbs, rng)
    for new_n in (8, 2, 1, 4):
        _same(*(db.execute(f"ALTER TABLE t RESHARD {new_n}") for db in dbs))
        t = dbs[1].tables["t"]
        if new_n > 1:
            assert len(t.mesh) == new_n and len(t.blocks) == new_n
        else:
            assert t.mesh is None and t.blocks is None
        _same(*(db.execute("SELECT k, w FROM t WHERE w < ?", (20,))
                for db in dbs))
        same_shards(dbs, "t")


def test_checkpoint_restore_across_mesh_sizes_and_packages(tmp_path):
    """A placed table's checkpoint restores onto another mesh size (and
    unplaced), and across packages both ways."""
    rng = np.random.default_rng(43)
    dbs = _mk_pair(4, indexed=True)
    for _ in range(3):
        _insert_batch(dbs, rng)
    snap = str(tmp_path / "snap4")
    dbs[1].execute(f"CHECKPOINT t TO '{snap}'")      # the port's, placed
    for db in dbs:
        db.execute("ALTER TABLE t RESHARD 2")
        db.execute(f"RESTORE t FROM '{snap}'")
    assert len(dbs[1].tables["t"].mesh) == 2
    _same(*(db.execute("SELECT k, w, v FROM t WHERE w >= ?", (0,))
            for db in dbs))
    same_shards(dbs, "t")
    snap2 = str(tmp_path / "snap2")
    dbs[0].execute(f"CHECKPOINT t TO '{snap2}'")     # the reference's
    for db in dbs:
        db.execute("ALTER TABLE t RESHARD 8")
        db.execute(f"RESTORE t FROM '{snap2}'")
    assert len(dbs[1].tables["t"].mesh) == 8
    _same(*(db.execute("SELECT k, w, v FROM t WHERE w >= ?", (0,))
            for db in dbs))
    _same(*(db.execute("SELECT COUNT(*) FROM t WHERE k = ?", (5,))
            for db in dbs))
    same_shards(dbs, "t")
    # an unplaced daemon restores the placed table's snapshot
    flat = TDB(device="cpu", warmup=False, mesh_exec=False)
    flat.execute(f"CREATE TABLE t {COLS}, INDEX(k)) CAPACITY {CAP} "
                 f"MAX_SELECT {CAP} SHARDS 8 PARTITION BY k")
    snap3 = str(tmp_path / "snap8")
    dbs[1].execute(f"CHECKPOINT t TO '{snap3}'")
    flat.execute(f"RESTORE t FROM '{snap3}'")
    np.testing.assert_equal(CV.state_to_numpy(flat.table_state("t")),
                            CV.state_to_numpy(dbs[1].table_state("t")))


def test_stale_index_fallback_parity():
    dbs = _mk_pair(4, indexed=True, cap=2048)
    burst = [(7, i, 0) for i in range(140)]  # one bucket, > 128 rows
    mix = [(k, k, 1) for k in range(12) if k != 7]
    for db in dbs:
        db.executemany("INSERT INTO t (k, w, v) VALUES (?, ?, ?)",
                       burst + mix)
    ex = same_json(dbs, "EXPLAIN SELECT w FROM t WHERE k = 7")
    assert ex["stale"] > 0
    for k in (7, 3, 42):
        _same(*(db.execute("SELECT w FROM t WHERE k = ?", (k,))
                for db in dbs))
    _same(*(db.execute("SELECT k, w FROM t WHERE w < ?", (9,))
            for db in dbs))
    for db in dbs:
        db.execute("DELETE FROM t WHERE k = ?", (7,))
    r = [db.execute("REINDEX t") for db in dbs]
    assert r[0].value == r[1].value == 0
    _same(*(db.execute("SELECT k, w FROM t WHERE k = ?", (3,))
            for db in dbs))
    same_shards(dbs, "t")


def test_show_stats_devices_and_nonblocking_snapshot():
    """SHOW STATS reports the mesh and each lane's device from host
    metadata; its snapshot replaces no lane and a pending lazy result
    stays right across it. EXPLAIN names a pruned route's device."""
    rng = np.random.default_rng(47)
    dbs = _mk_pair(4, indexed=False)
    _insert_batch(dbs, rng)
    t = dbs[1].tables["t"]
    pending = dbs[1].execute("SELECT COUNT(*) FROM t WHERE w < ?", (999,))
    before = [id(lane) for lane in t.lanes]
    st = json.loads(dbs[1].execute("SHOW STATS t").value)
    assert st["devices"] == 4
    assert [p["device"] for p in st["per_shard"]] == [0] * 4   # cpu entries
    assert sum(p["live_rows"] for p in st["per_shard"]) \
        == dbs[0].live_rows("t")
    assert [id(lane) for lane in t.lanes] == before
    assert pending.value == dbs[0].execute(
        "SELECT COUNT(*) FROM t WHERE w < ?", (999,)).value
    same_json(dbs, "SHOW STATS t", drop=("executors", "device", "devices"))
    ex = json.loads(dbs[1].execute(
        "EXPLAIN SELECT w FROM t WHERE k = 3").value)
    assert ex["device"] == 0 and "pruned" in ex["shard_route"]
    ex = json.loads(dbs[1].execute(
        "EXPLAIN SELECT w FROM t WHERE w = 3").value)
    assert ex["devices"] == 4


def test_warm_fanout_replays_and_reshard_retires_the_mesh_plans():
    """WARMUP of a fan-out shape plans every block and the merge (no miss
    after it); RESHARD to another mesh retires them all (the counterpart
    of tests/test_execache.py::test_mesh_replacement_invalidates)."""
    dbs = _mk_pair(8, indexed=True)
    db = dbs[1]
    db.execute("WARMUP t LIKE 'SELECT k, v FROM t WHERE v > ?'")
    db.execute("WARMUP t")
    for d in dbs:
        d.executemany("INSERT INTO t (k, w, v) VALUES (?, ?, ?)",
                      [(i % 12, i, i) for i in range(24)])
    st0 = json.loads(db.execute("SHOW STATS t").value)["executors"]
    for v in (3, 10):
        _same(*(d.execute("SELECT k, v FROM t WHERE v > ?", (v,))
                for d in dbs))
    st1 = json.loads(db.execute("SHOW STATS t").value)["executors"]
    assert st1["misses"] == st0["misses"] and st1["hits"] > st0["hits"]
    assert json.loads(db.execute(
        "EXPLAIN SELECT k, v FROM t WHERE v > ?").value)["preplanned"]
    _same(*(d.execute("ALTER TABLE t RESHARD 4") for d in dbs))
    st2 = json.loads(db.execute("SHOW STATS t").value)["executors"]
    assert st2["epoch"] == st1["epoch"] + 1 and st2["cached"] == 0
    assert len(db.tables["t"].mesh) == 4
    _same(*(d.execute("SELECT k, v FROM t WHERE v > ?", (3,)) for d in dbs))
    same_shards(dbs, "t")


def test_scheduler_lane_locks_on_a_placed_table():
    """Four client threads' pruned writes and fan-out reads through the
    BatchScheduler on a placed table (lane groups on their blocks'
    devices), then the same stream serially on the reference."""
    import asyncio

    from repro_torch.core.scheduler import BatchScheduler

    dbs = _mk_pair(4, indexed=True)
    rng = np.random.default_rng(5)
    stream = [(int(rng.integers(0, 12)), i, int(rng.integers(0, 9)))
              for i in range(64)]

    async def main():
        sched = BatchScheduler(dbs[1])
        await sched.start()
        futs = [sched.submit("INSERT INTO t (k, w, v) VALUES (?, ?, ?)", r)
                for r in stream]
        await asyncio.gather(*futs)
        reads = await asyncio.gather(*[
            sched.submit("SELECT k, w FROM t WHERE k = ?", (k,))
            for k in range(12)])
        stats = dict(sched.stats)
        await sched.stop()
        return reads, stats

    reads, stats = asyncio.run(main())
    assert stats["lane_dispatches"] > 0
    for r in stream:
        dbs[0].execute("INSERT INTO t (k, w, v) VALUES (?, ?, ?)", r)
    for k, r_t in enumerate(reads):
        r_j = dbs[0].execute("SELECT k, w FROM t WHERE k = ?", (k,))
        assert sorted(map(repr, r_t.rows)) == sorted(map(repr, r_j.rows))
    assert dbs[0].live_rows("t") == dbs[1].live_rows("t")


def test_payload_table_deletes_and_selects_through_the_merge():
    """On a placed payload table, DELETEs report global row ids through the
    home merge (first ``limit`` in (shard, slot) order), a fan-out SELECT
    carries the payloads of the rows it merges, and a wide INSERT reaches
    every block, which keeps its own shards' rows."""
    rng = np.random.default_rng(9)
    dbs = (JDB(mesh_exec=False, warmup=False),
           TDB(device="cpu", warmup=False))
    for db in dbs:
        db.execute("CREATE TABLE p (k INT, w INT, PAYLOAD e TENSOR(3) F32) "
                   "CAPACITY 64 MAX_SELECT 8 SHARDS 4 PARTITION BY k")
    assert len(dbs[1].tables["p"].mesh) == 4
    rows = [(int(rng.integers(0, 30)), i) for i in range(40)]
    pls = [{"e": rng.random(3).astype(np.float32)} for _ in rows]
    out = [db.executemany("INSERT INTO p (k, w) VALUES (?, ?)", rows, pls)
           for db in dbs]
    np.testing.assert_array_equal(out[1].row_ids, out[0].row_ids)
    for sql, args in (("DELETE FROM p WHERE w < ?", (12,)),
                      ("DELETE FROM p WHERE k = ?", (rows[20][0],))):
        res = [db.execute(sql, args) for db in dbs]
        _same(*res)
    for sql, args in (("SELECT PAYLOAD(e), w FROM p WHERE w > ?", (15,)),
                      ("SELECT PAYLOAD(e), w FROM p WHERE k = ?",
                       (rows[30][0],)),
                      ("SELECT PAYLOAD(e), k FROM p ORDER BY w DESC "
                       "LIMIT 5", ())):
        res = [db.execute(sql, args) for db in dbs]
        _same(*res)
        np.testing.assert_array_equal(np.asarray(res[1].payloads["e"]),
                                      np.asarray(res[0].payloads["e"]))
    same_shards(dbs, "p")
