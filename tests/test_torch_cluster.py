"""The port's cluster tier (``repro_torch.core.cluster``) over in-process
port daemons: the reference's tests/test_cluster.py cases, each daemon a
``repro_torch.core.protocol.ThreadedServer`` on a CPU
``repro_torch.core.SQLCached`` (consistent-hash ring properties,
statement routing (pruned vs fan-out), replica mirroring and read merges,
SHOW CLUSTER, admin guardrails, live add/remove-node data movement through
the port's CHECKPOINT / RESTORE / RETAIN SLOTS). Node death is
``ThreadedServer.stop()``; process-level kill -9 lives in
tests/test_torch_cluster_chaos.py. Then the slot hash the client routes
by against the device hash RETAIN keeps by, and one seeded statement
stream through the reference's cluster (reference daemons) and the
port's (port daemons), with equal results."""
import asyncio

import numpy as np
import pytest
import torch

from repro.core import cluster as JC
from repro.core import protocol as JP
from repro.core.daemon import SQLCached as JDB
from repro_torch.core import shards as TSH
from repro_torch.core.cluster import (NSLOTS, AsyncClusterClient, ClusterClient,
                                      ClusterError, HashRing, _hash_point)
from repro_torch.core.daemon import SQLCached as TDB
from repro_torch.core.protocol import ThreadedServer


def server():
    """One port daemon on the CPU behind the wire."""
    return ThreadedServer(db=TDB(device="cpu"))


pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")


# ------------------------------------------------------------------ ring

def test_ring_deterministic_and_distinct():
    a = HashRing(["n1:1", "n2:1", "n3:1"])
    b = HashRing(["n3:1", "n1:1", "n2:1"])  # insertion order irrelevant
    for key in ("t", "t/0", "t/63", "users"):
        assert a.lookup(key, 2) == b.lookup(key, 2)
        assert len(set(a.lookup(key, 2))) == 2
    # r >= N degrades to all nodes
    assert set(a.lookup("t", 9)) == {"n1:1", "n2:1", "n3:1"}


def test_ring_add_remove_moves_minority():
    nodes = [f"n{i}:1" for i in range(8)]
    ring = HashRing(nodes)
    before = {s: ring.lookup(f"t/{s}", 1)[0] for s in range(NSLOTS)}
    ring.add("n8:1")
    after = {s: ring.lookup(f"t/{s}", 1)[0] for s in range(NSLOTS)}
    moved = sum(before[s] != after[s] for s in range(NSLOTS))
    # consistent hashing: ~1/N of slots remap, never a majority
    assert 0 < moved <= NSLOTS // 2
    assert all(after[s] == "n8:1" for s in range(NSLOTS)
               if before[s] != after[s])
    ring.remove("n8:1")
    assert {s: ring.lookup(f"t/{s}", 1)[0]
            for s in range(NSLOTS)} == before


def test_ring_points_stable_across_processes():
    # md5, not hash(): same coordinates under any PYTHONHASHSEED
    assert _hash_point("n1:1#0") == 0x726F0DD1FF11EFF1 or isinstance(
        _hash_point("n1:1#0"), int)
    assert _hash_point("x") == _hash_point("x")


# ----------------------------------------------------------- fixtures

@pytest.fixture()
def fleet():
    servers = [server() for _ in range(3)]
    try:
        yield servers
    finally:
        for s in servers:
            try:
                s.stop()
            except Exception:  # noqa: BLE001 — some were stopped by tests
                pass


@pytest.fixture()
def cc(fleet, tmp_path):
    c = ClusterClient([f"{s.addr[0]}:{s.addr[1]}" for s in fleet],
                      statement_retries=3, retry_base=0.01, retry_cap=0.05,
                      checkpoint_dir=str(tmp_path))
    yield c
    c.close()


SPREAD = ("CREATE TABLE m (id INT, score FLOAT, INDEX (id)) "
          "CAPACITY 512 SHARDS 2 PARTITION BY id REPLICAS 2")
WHOLE = ("CREATE TABLE kv (k TEXT, v INT, INDEX (k)) "
         "CAPACITY 256 REPLICAS 2")


def _load(cc, n=40):
    cc.execute(SPREAD)
    with cc.pipeline() as pl:
        for i in range(n):
            pl.execute("INSERT INTO m (id, score) VALUES (?, ?)",
                       (i, float(i)))
    assert all(isinstance(r, dict) and r["count"] == 1 for r in pl.results)


# ------------------------------------------------------------- routing

def test_spread_vs_whole_table_classification(cc):
    cc.execute(SPREAD)
    cc.execute(WHOLE)
    assert cc._tables["m"].spread and cc._tables["m"].pcol == "id"
    # TEXT partition values are per-daemon interner ids: no cluster hash
    assert not cc._tables["kv"].spread
    assert len(cc._tables["m"].groups) == NSLOTS
    assert list(cc._tables["kv"].groups) == [None]
    for members in cc._tables["m"].groups.values():
        assert len(members) == 2 and len(set(members)) == 2


def test_pruned_statements_route_to_one_group(cc):
    _load(cc)
    p = cc._route("SELECT * FROM m WHERE id = 7", ())
    assert p.mode == "group_read" and len(p.groups) == 1
    p = cc._route("DELETE FROM m WHERE id = ?", (7,))
    assert p.mode == "group_write"
    p = cc._route("SELECT * FROM m WHERE score > 1.0", ())
    assert p.mode == "rows_fanout"
    p = cc._route("UPDATE m SET score = 0.0 WHERE score > 1.0", ())
    assert p.mode == "fanall_write"


def test_unknown_table_and_admin_guardrails(cc):
    with pytest.raises(ClusterError, match="unknown table"):
        cc.execute("SELECT * FROM nope WHERE a = 1")
    cc.execute(SPREAD)
    for sql in ("CHECKPOINT m TO '/tmp/x'", "RESTORE m FROM '/tmp/x'",
                "ALTER TABLE m RETAIN SLOTS 0,1 OF 64"):
        with pytest.raises(ClusterError, match="node-local"):
            cc.execute(sql)


def test_fanout_projection_requirements(cc):
    cc.execute(SPREAD)
    with pytest.raises(ClusterError, match="partition column"):
        cc.execute("SELECT score FROM m WHERE score > 1.0")
    with pytest.raises(ClusterError, match="ORDER BY"):
        cc.execute("SELECT id FROM m WHERE score > 1.0 ORDER BY score")


# ------------------------------------------------------------- queries

def test_reads_and_merges(cc):
    _load(cc)
    r = cc.execute("SELECT * FROM m WHERE id = 7")
    assert r["rows"] == [{"id": 7, "score": 7.0}]
    # fan-out rows: replica-deduped, re-sorted, re-limited
    r = cc.execute("SELECT id, score FROM m WHERE score >= 30.0 "
                   "ORDER BY id DESC LIMIT 5")
    assert [row["id"] for row in r["rows"]] == [39, 38, 37, 36, 35]
    # fan-out row counts are exact (each row kept by exactly one reader)
    r = cc.execute("SELECT * FROM m WHERE score >= 0.0")
    assert r["count"] == 40 and len(r["rows"]) == 40
    assert len({row["id"] for row in r["rows"]}) == 40


def test_aggregate_merges(cc):
    _load(cc)
    assert cc.execute("SELECT COUNT(*) FROM m")["value"] == 40
    assert cc.execute("SELECT SUM(id) FROM m")["value"] == sum(range(40))
    assert cc.execute("SELECT MIN(id) FROM m")["value"] == 0
    assert cc.execute("SELECT MAX(score) FROM m")["value"] == 39.0
    # AVG fans out as SUM+COUNT and re-divides (replica-immune)
    assert abs(cc.execute("SELECT AVG(id) FROM m")["value"] - 19.5) < 1e-9
    # pruned aggregate passes straight through
    assert cc.execute("SELECT COUNT(*) FROM m WHERE id = 7")["value"] == 1


def test_fanout_writes_divide_by_replicas(cc):
    _load(cc)
    r = cc.execute("UPDATE m SET score = -1.0 WHERE score < 5.0")
    assert r["count"] == 5
    r = cc.execute("DELETE FROM m WHERE score < 0.0")
    assert r["count"] == 5
    assert cc.execute("SELECT COUNT(*) FROM m")["value"] == 35


def test_show_cluster_and_stats(cc):
    _load(cc)
    r = cc.execute("SHOW CLUSTER")
    v = r["value"]
    assert [n["status"] for n in v["nodes"]] == ["up", "up", "up"]
    assert v["tables"]["m"]["spread"] and v["tables"]["m"]["slots"] == NSLOTS
    assert v["tables"]["m"]["replicas"] == 2
    # every slot's primary is a real node
    assert sum(v["tables"]["m"]["primary_of"].values()) == NSLOTS
    r = cc.execute("SHOW STATS m")
    assert len(r["value"]["cluster_stats"]) == 3
    for rep in r["value"]["cluster_stats"].values():
        assert rep["table"] == "m" and rep["replicas"] == 2


def test_read_your_writes_through_mirroring(cc):
    """A write then read on the same client always sees the write: the
    mirror rides the same per-node connection ahead of any read."""
    cc.execute(SPREAD)
    for i in range(20):
        cc.execute("INSERT INTO m (id, score) VALUES (?, ?)", (i, 0.5))
        r = cc.execute("SELECT * FROM m WHERE id = ?", (i,))
        assert r["rows"] == [{"id": i, "score": 0.5}]


# ------------------------------------------------------------- failover

def test_read_failover_and_promotion(cc, fleet):
    _load(cc)
    fleet[0].stop()
    victim = f"{fleet[0].addr[0]}:{fleet[0].addr[1]}"
    with cc.pipeline() as pl:
        for i in range(40):
            pl.execute("SELECT * FROM m WHERE id = ?", (i,))
    assert all(isinstance(r, dict) and r["rows"] for r in pl.results)
    assert victim in cc._down
    # promotion: every group's primary is now a live node
    v = cc.execute("SHOW CLUSTER")["value"]
    assert victim not in v["tables"]["m"]["primary_of"]
    # writes keep flowing (ack = surviving replica answered)
    for i in range(100, 110):
        assert cc.execute("INSERT INTO m (id, score) VALUES (?, ?)",
                          (i, 1.0))["count"] == 1
        assert cc.execute("SELECT * FROM m WHERE id = ?",
                          (i,))["rows"] != []


def test_write_unacknowledged_when_group_fully_dead(fleet):
    cc = ClusterClient([f"{s.addr[0]}:{s.addr[1]}" for s in fleet],
                       statement_retries=1, retry_base=0.01,
                       retry_cap=0.02)
    cc.execute("CREATE TABLE m (id INT, INDEX (id)) CAPACITY 64 "
               "SHARDS 2 PARTITION BY id REPLICAS 2")
    for s in fleet:
        s.stop()
    cc._down.clear()  # the client finds out the hard way
    with pytest.raises((ClusterError, ConnectionError)):
        cc.execute("INSERT INTO m (id) VALUES (1)")
    cc.close()


def test_ping_all_marks_down_and_up(cc, fleet):
    assert all(cc.ping_all().values())
    fleet[1].stop()
    h = cc.ping_all()
    assert sum(h.values()) == 2
    assert len(cc._down) == 1


# ------------------------------------------------------------- topology

def test_remove_node_rereplicates(cc, fleet):
    _load(cc)
    fleet[0].stop()
    victim = f"{fleet[0].addr[0]}:{fleet[0].addr[1]}"
    cc.ping_all()
    cc.remove_node(victim)
    # back to full replication on the 2 survivors: counts exact again
    assert cc.execute("SELECT COUNT(*) FROM m")["value"] == 40
    for i in range(40):
        assert cc.execute("SELECT * FROM m WHERE id = ?", (i,))["rows"]
    for members in cc._tables["m"].groups.values():
        assert victim not in members and len(set(members)) == 2


def test_add_node_bootstraps_and_trims(cc):
    _load(cc)
    cc.execute(WHOLE)
    cc.execute("INSERT INTO kv (k, v) VALUES ('a', 1)")
    extra = server()
    try:
        name = f"{extra.addr[0]}:{extra.addr[1]}"
        report = cc.add_node(name)
        assert name in cc._ring.nodes
        # data still complete and exactly replicated after the remap
        assert cc.execute("SELECT COUNT(*) FROM m")["value"] == 40
        for i in range(40):
            assert cc.execute("SELECT * FROM m WHERE id = ?", (i,))["rows"]
        assert cc.execute("SELECT * FROM kv WHERE k = 'a'")["rows"] == [
            {"k": "a", "v": 1}]
        # the new node actually received data for its gained slots
        gained = sum(t["gained"] for t in report.values())
        assert gained > 0
        # writes route through the new topology
        cc.execute("INSERT INTO m (id, score) VALUES (777, 7.0)")
        assert cc.execute("SELECT * FROM m WHERE id = 777")["rows"]
    finally:
        extra.stop()


def test_add_then_remove_round_trip(cc):
    _load(cc, n=20)
    extra = server()
    try:
        name = f"{extra.addr[0]}:{extra.addr[1]}"
        cc.add_node(name)
        cc.remove_node(name)
        assert cc.execute("SELECT COUNT(*) FROM m")["value"] == 20
        for i in range(20):
            assert cc.execute("SELECT * FROM m WHERE id = ?", (i,))["rows"]
    finally:
        extra.stop()


# ---------------------------------------------------------------- async

def test_async_cluster_failover(fleet):
    async def main():
        cc = AsyncClusterClient(
            [f"{s.addr[0]}:{s.addr[1]}" for s in fleet],
            statement_retries=3, retry_base=0.01, retry_cap=0.05)
        await cc.execute(SPREAD)
        await asyncio.gather(*(cc.execute(
            "INSERT INTO m (id, score) VALUES (?, ?)", (i, float(i)))
            for i in range(30)))
        r = await cc.execute("SELECT AVG(id) FROM m")
        assert abs(r["value"] - 14.5) < 1e-9
        fleet[2].stop()
        res = await asyncio.gather(*(cc.execute(
            "SELECT * FROM m WHERE id = ?", (i,)) for i in range(30)))
        assert all(r["rows"] for r in res)
        assert len(cc._down) <= 1
        r = await cc.execute("SELECT COUNT(*) FROM m WHERE id = 3")
        assert r["value"] == 1
        await cc.close()

    asyncio.run(main())


# ------------------------------------------------------ slots, parity

def test_client_slot_agrees_with_device_retain_slot():
    """The slot the client routes a key by (``shard_of_host`` at NSLOTS)
    is the slot RETAIN computes on the device (``shard_of``), for
    negative and large keys: a handover keeps every row it owns."""
    rng = np.random.default_rng(21)
    keys = np.concatenate([
        np.array([0, 1, -1, 7, -7, 2**31 - 1, -2**31, -2**31 + 1, 65536,
                  -65536, 123456789, -987654321], np.int32),
        rng.integers(-2**31, 2**31 - 1, 2000).astype(np.int32)])
    dev = TSH.shard_of(torch.from_numpy(keys), NSLOTS).numpy()
    host = [ClusterClient._slot_of(int(k)) for k in keys]
    assert host == dev.tolist()
    assert host == [JC.ClusterClient._slot_of(int(k)) for k in keys]


def _stream(rng, n_rows=48):
    """A seeded cluster statement stream: writes, pruned and fan-out
    reads, aggregates, a whole-table TEXT table, fan-out writes."""
    ids = rng.choice(np.arange(-500, 500), n_rows, replace=False).tolist()
    out = [("CREATE TABLE m (id INT, score FLOAT, tag TEXT, INDEX (id)) "
            "CAPACITY 512 SHARDS 2 PARTITION BY id REPLICAS 2", ()),
           ("CREATE TABLE kv (k TEXT, v INT, INDEX (k)) CAPACITY 256 "
            "REPLICAS 2", ())]
    for i, k in enumerate(ids):
        out.append(("INSERT INTO m (id, score, tag) VALUES (?, ?, ?)",
                    (k, float(rng.random()), f"t{i % 5}")))
        if i % 4 == 0:
            out.append(("INSERT INTO kv (k, v) VALUES (?, ?)",
                        (f"key{i}", i)))
    for j in range(24):
        k = ids[int(rng.integers(0, len(ids)))]
        x = float(rng.random())
        out += [("SELECT * FROM m WHERE id = ?", (k,)),
                ("SELECT id, score FROM m WHERE score >= ? ORDER BY id "
                 "DESC LIMIT 7", (x,)),
                ("SELECT id, tag FROM m WHERE score < ?", (x,))]
        if j % 3 == 0:
            out += [("UPDATE m SET score = ? WHERE id = ?", (x, k)),
                    ("SELECT COUNT(*) FROM m WHERE score < ?", (x,)),
                    ("SELECT SUM(id) FROM m", ()),
                    ("SELECT AVG(id) FROM m WHERE score >= ?", (x,)),
                    ("SELECT MIN(id) FROM m", ()),
                    ("SELECT MAX(score) FROM m", ()),
                    ("SELECT v FROM kv WHERE k = ?", (f"key{4 * j}",))]
        if j % 5 == 4:
            out += [("DELETE FROM m WHERE id = ?", (k,)),
                    ("UPDATE m SET tag = 'hot' WHERE score > ?", (0.9,)),
                    ("DELETE FROM m WHERE score < ?", (0.05,))]
    return out


def _norm(res):
    """A cluster result without what placement decides: fan-out rows
    without ORDER BY come back in node order, so they are sorted."""
    if isinstance(res, Exception):
        return ("error", type(res).__name__)
    rows = res.get("rows") or []
    return {"count": res["count"], "value": res["value"],
            "rows": sorted(rows, key=lambda r: sorted(r.items()))}


def test_seeded_stream_matches_reference_cluster(tmp_path):
    """One seeded stream through the reference's ClusterClient over three
    reference daemons and through the port's over three port daemons
    (ring placement differs with the ports, the answers may not), then
    add_node and remove_node in both (CHECKPOINT / RESTORE / RETAIN on
    the nodes) and the reads again."""
    fleets = ([JP.ThreadedServer(db=JDB(mesh_exec=False, warmup=False))
               for _ in range(4)], [server() for _ in range(4)])
    ccs = []
    try:
        for mod, fleet, sub in ((JC, fleets[0], "ref"),
                                (None, fleets[1], "port")):
            cls = mod.ClusterClient if mod else ClusterClient
            ccs.append(cls([f"{s.addr[0]}:{s.addr[1]}" for s in fleet[:3]],
                           statement_retries=3, retry_base=0.01,
                           retry_cap=0.05,
                           checkpoint_dir=str(tmp_path / sub)))
        stmts = _stream(np.random.default_rng(8))
        reads = [x for x in stmts if x[0].startswith("SELECT")]
        for sql, args in stmts:
            got = [_norm(c.execute(sql, args)) for c in ccs]
            assert got[0] == got[1], (sql, args)
        for c, fleet in zip(ccs, fleets):
            extra = f"{fleet[3].addr[0]}:{fleet[3].addr[1]}"
            c.add_node(extra)
        for sql, args in reads[:30]:
            got = [_norm(c.execute(sql, args)) for c in ccs]
            assert got[0] == got[1], ("after add_node", sql, args)
        for c, fleet in zip(ccs, fleets):
            c.remove_node(f"{fleet[0].addr[0]}:{fleet[0].addr[1]}")
        for sql, args in reads[:30] + [("SELECT COUNT(*) FROM m", ()),
                                       ("SELECT COUNT(*) FROM kv", ())]:
            got = [_norm(c.execute(sql, args)) for c in ccs]
            assert got[0] == got[1], ("after remove_node", sql, args)
        shown = [c.execute("SHOW CLUSTER")["value"] for c in ccs]
        for v in shown:
            assert [n["status"] for n in v["nodes"]] == ["up"] * 3
            assert sum(v["tables"]["m"]["primary_of"].values()) == NSLOTS
        assert [{t: {k: x[k] for k in ("replicas", "spread", "slots",
                                        "partition_by")}
                 for t, x in v["tables"].items()} for v in shown] == \
            [{"m": {"replicas": 2, "spread": True, "slots": NSLOTS,
                    "partition_by": "id"},
              "kv": {"replicas": 2, "spread": False, "slots": 1,
                     "partition_by": None}}] * 2
    finally:
        for c in ccs:
            c.close()
        for fleet in fleets:
            for s in fleet:
                try:
                    s.stop()
                except Exception:  # noqa: BLE001 — stopped already
                    pass
