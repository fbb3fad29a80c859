"""Process-level chaos for the port's cluster tier (the reference's
tests/test_cluster_chaos.py cases over port daemons). Daemon PROCESSES
(``python -m repro_torch.core.protocol --device cpu``, tests/
_torch_chaos.py), a spread table with REPLICAS 2, SIGKILL one node
mid-workload: every acknowledged write must remain readable from the
promoted replicas (zero lost acknowledged writes), reads keep flowing,
and the dead node's keyspace re-replicates via remove_node. Plus scripted
network faults through ``FlakyProxy``: induced latency trips PING
deadlines, connection drops mid-pipeline fail over cleanly; and the
per-shard SHOW STATS counters survive RESHARD."""
import asyncio
import json

import pytest

from repro_torch.core.cluster import ClusterClient
from repro_torch.core.daemon import SQLCached
from repro_torch.core.protocol import AsyncSQLCachedClient, SQLCachedClient

from _torch_chaos import DaemonProc, FlakyProxy, spawn_fleet

CREATE = ("CREATE TABLE c (id INT, score FLOAT, INDEX (id)) "
          "CAPACITY 2048 MAX_SELECT 2048 SHARDS 2 PARTITION BY id "
          "REPLICAS 2")


def test_kill9_loses_zero_acknowledged_writes():
    fleet = spawn_fleet(3)
    cc = None
    try:
        cc = ClusterClient([d.name for d in fleet], statement_retries=4,
                           retry_base=0.02, retry_cap=0.2)
        cc.execute(CREATE)

        acked: list[int] = []
        # phase 1: healthy writes, individually acknowledged
        for i in range(60):
            r = cc.execute("INSERT INTO c (id, score) VALUES (?, ?)",
                           (i, float(i)))
            assert r["count"] == 1
            acked.append(i)

        # phase 2: SIGKILL one node, then keep writing THROUGH the
        # failure — acks must only be issued for writes that survive
        victim = fleet[0]
        victim.kill9()
        assert not victim.alive
        for i in range(60, 120):
            try:
                r = cc.execute("INSERT INTO c (id, score) VALUES (?, ?)",
                               (i, float(i)))
            except Exception:  # noqa: BLE001 — unacked is allowed to fail
                continue
            if isinstance(r, dict) and r["count"] == 1:
                acked.append(i)
        assert victim.name in cc._down
        assert len(acked) > 60  # failover really let writes through

        # phase 3: EVERY acknowledged write is still readable — served
        # by the promoted surviving replicas
        lost = [i for i in acked
                if not cc.execute("SELECT * FROM c WHERE id = ?",
                                  (i,))["rows"]]
        assert lost == [], f"lost acknowledged writes: {lost}"

        # phase 4: scrub the dead node; replication factor restored,
        # fan-out counts exact again
        cc.remove_node(victim.name)
        assert cc.execute("SELECT COUNT(*) FROM c")["value"] == len(acked)
        v = cc.execute("SHOW CLUSTER")["value"]
        assert victim.name not in v["tables"]["c"]["primary_of"]
    finally:
        if cc is not None:
            cc.close()
        for d in fleet:
            d.kill9()


def test_kill9_mid_pipeline_acks_are_replayed_by_tag():
    """The mirrored-tag contract: a pipeline in flight when a replica
    dies still yields one result per statement — the survivor's response
    (same tag, already executed) stands in for the dead node's."""
    fleet = spawn_fleet(2)
    cc = None
    try:
        cc = ClusterClient([d.name for d in fleet], statement_retries=3,
                           retry_base=0.02, retry_cap=0.2)
        # r=2 over 2 nodes: every write mirrors to BOTH daemons
        cc.execute("CREATE TABLE c (id INT, INDEX (id)) CAPACITY 1024 "
                   "SHARDS 2 PARTITION BY id REPLICAS 2")
        pl = cc.pipeline()
        for i in range(200):
            pl.execute("INSERT INTO c (id) VALUES (?)", (i,))
        fleet[0].kill9()  # dies while the batch is in flight
        res = pl.collect(return_exceptions=True)
        assert len(res) == 200
        acked = [i for i, r in enumerate(res)
                 if isinstance(r, dict) and r["count"] == 1]
        assert acked, "survivor should have answered the mirrored tags"
        lost = [i for i in acked
                if not cc.execute("SELECT * FROM c WHERE id = ?",
                                  (i,))["rows"]]
        assert lost == [], f"acked but unreadable: {lost}"
    finally:
        if cc is not None:
            cc.close()
        for d in fleet:
            d.kill9()


def test_latency_injection_trips_ping_deadline():
    with DaemonProc() as d, FlakyProxy(d.addr) as proxy:
        # direct (no latency): deadline comfortably met
        c = SQLCachedClient(*proxy.addr)
        assert c.ping()

        async def probe():
            ac = await AsyncSQLCachedClient.connect(*proxy.addr)
            assert await ac.ping(deadline=5.0)
            proxy.latency = 0.7
            with pytest.raises(asyncio.TimeoutError):
                await ac.ping(deadline=0.2)
            await ac.close()

        asyncio.run(probe())
        c.close()


def test_connection_drop_fails_over_to_replica():
    """A scripted connection drop (not a process death): the node is
    fine but unreachable — reads fail over, and after heal() the node
    can serve again on a fresh connection."""
    fleet = spawn_fleet(2)
    cc = None
    proxy = None
    try:
        proxy = FlakyProxy(fleet[0].addr)
        # node 0 reached via the flaky proxy, node 1 directly
        cc = ClusterClient([proxy.name, fleet[1].name],
                           statement_retries=3, retry_base=0.02,
                           retry_cap=0.1, connect_retries=0)
        cc.execute("CREATE TABLE c (id INT, INDEX (id)) CAPACITY 256 "
                   "SHARDS 2 PARTITION BY id REPLICAS 2")
        for i in range(20):
            cc.execute("INSERT INTO c (id) VALUES (?)", (i,))
        proxy.drop_all()
        for i in range(20):  # all reads survive the partition
            assert cc.execute("SELECT * FROM c WHERE id = ?",
                              (i,))["rows"]
        assert proxy.name in cc._down
        # partition heals: mark up, fresh connection, node serves again
        proxy.heal()
        cc.mark_up(proxy.name)
        assert cc.ping_all()[proxy.name]
        assert cc.execute("SELECT COUNT(*) FROM c WHERE id = 3")[
            "value"] == 1
    finally:
        if cc is not None:
            cc.close()
        if proxy is not None:
            proxy.close()
        for d in fleet:
            d.kill9()


def test_stats_counters_survive_reshard():
    """Regression (satellite): ALTER TABLE RESHARD used to zero the
    per-lane SHOW STATS counters; they must carry across (totals
    invariant) so operator dashboards don't reset on a re-split."""
    db = SQLCached(device="cpu")
    db.execute("CREATE TABLE s (id INT, INDEX (id)) CAPACITY 256 "
               "SHARDS 2 PARTITION BY id")
    for i in range(32):
        db.execute("INSERT INTO s (id) VALUES (?)", [i])
    for i in range(16):
        db.execute("SELECT * FROM s WHERE id = ?", [i])

    def totals():
        per = json.loads(db.execute("SHOW STATS s").value)["per_shard"]
        return (sum(p["statements"] for p in per),
                sum(p["writes"] for p in per),
                sum(p["inserted_rows"] for p in per))

    before = totals()
    assert before[1] == 32 and before[2] == 32
    db.execute("ALTER TABLE s RESHARD 4")
    after = totals()
    assert after == before, "RESHARD must carry stats counters"
    db.execute("ALTER TABLE s RESHARD 1")
    assert totals() == before


def test_cluster_up_boots_and_stops_a_fleet():
    """``python -m repro_torch.launch.cluster_up -n 2 --device cpu``
    boots two daemons, prints their names and a ClusterClient line, serves
    a cluster, and SIGTERM stops every child."""
    import os
    import re
    import signal
    import subprocess
    import sys

    from _torch_chaos import _REPO
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(_REPO, "src")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.cluster_up", "-n", "2",
         "--device", "cpu"], stdout=subprocess.PIPE, text=True, env=env,
        cwd=_REPO)
    cc = None
    try:
        lines = []
        while not lines or not lines[-1].startswith("Ctrl-C"):
            line = proc.stdout.readline()
            assert line, f"cluster_up exited early: {lines}"
            lines.append(line.strip())
        nodes = re.findall(r"^node (\S+)  pid (\d+)  device cpu$",
                           "\n".join(lines), re.M)
        assert len(nodes) == 2
        assert any(line.startswith("cc = ClusterClient([") for line in lines)
        cc = ClusterClient([n for n, _ in nodes], statement_retries=1)
        cc.execute("CREATE TABLE c (id INT, INDEX (id)) CAPACITY 64 "
                   "SHARDS 2 PARTITION BY id REPLICAS 2")
        for i in range(10):
            cc.execute("INSERT INTO c (id) VALUES (?)", (i,))
        assert cc.execute("SELECT COUNT(*) FROM c")["value"] == 10
    finally:
        if cc is not None:
            cc.close()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0 and "cluster down" in out
    for _, pid in nodes:
        with pytest.raises(ProcessLookupError):
            os.kill(int(pid), 0)
