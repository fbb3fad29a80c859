"""The port's CHECKPOINT / RESTORE against the reference's, across shard
counts and across packages (the rest of the snapshot statements:
tests/test_torch_snapshot_stmts.py).

A seeded stream (TTL, an op-count interval, lazy lane clocks and a
deferred lane expiry) runs through ``repro.core.SQLCached(mesh_exec=False,
warmup=False)`` and ``repro_torch.core.SQLCached(device="cpu")``; both
CHECKPOINT the table (the same files), and RESTORE it into a fresh table
of another shard count, or each restores the OTHER package's files. Every
statement's result and each shard's whole state must match, exactly."""
import numpy as np
import pytest

from test_torch_daemon import run
from test_torch_shards import make_t, pair, same_shards
from test_torch_snapshot_stmts import checkpoint_both, fill, stream


def source(src_n, seed, ddl_extra=" TTL 30 OPS_INTERVAL 5"):
    """A pair with table t (SHARDS src_n, INDEX(w)) after a seeded stream
    (lazy clocks and a deferred lane expiry included)."""
    rng = np.random.default_rng(seed)
    dbs = pair()
    make_t(dbs, src_n, "w", extra=ddl_extra)
    fill(dbs, rng, ttl=True)
    stream(dbs, rng, n=2)
    for db in dbs:
        db.advance_clock(3, "t")
    return dbs, rng


@pytest.mark.parametrize("src_n,dst_n", [(4, 4), (1, 1), (4, 2), (2, 1),
                                         (1, 4)])
def test_checkpoint_restore_into_fresh_table(tmp_path, src_n, dst_n):
    dbs, rng = source(src_n, 100 + src_n * 10 + dst_n)
    dirs = checkpoint_both(dbs, "t", tmp_path, "t")
    for db, d in zip(dbs, dirs):
        db.execute(f"CREATE TABLE u (k INT, w INT, v INT, INDEX(w)) "
                   f"CAPACITY 256 MAX_SELECT 16 TTL 30 OPS_INTERVAL 5 "
                   f"SHARDS {dst_n} PARTITION BY k")
    res = [db.execute(f"RESTORE u FROM '{d}'") for db, d in zip(dbs, dirs)]
    assert res[0].count == res[1].count == dbs[1].live_rows("t")
    same_shards(dbs, "u")
    for k in range(12):
        run(dbs, "execute", "SELECT k, w, v FROM u WHERE k = ?", (k,))
    run(dbs, "execute", "SELECT k, w FROM u WHERE w BETWEEN ? AND ?",
        (5, 30))
    run(dbs, "execute", "EXPIRE u")
    same_shards(dbs, "u")


@pytest.mark.parametrize("src_n,dst_n", [(2, 2), (4, 1), (1, 2)])
def test_checkpoint_crosses_packages(tmp_path, src_n, dst_n):
    """A reference CHECKPOINT restored by a port daemon, and a port
    CHECKPOINT restored by a reference daemon, at equal and at different
    shard counts: both end in the reference's own restore's state."""
    dbs, _ = source(src_n, 300 + src_n * 10 + dst_n)
    ref_dir, port_dir = checkpoint_both(dbs, "t", tmp_path, "t")
    # each daemon restores the OTHER package's files
    for db, d in zip(dbs, (port_dir, ref_dir)):
        db.execute(f"ALTER TABLE t RESHARD {dst_n}")
        db.execute("FLUSH t")
        db.execute(f"RESTORE t FROM '{d}'")
    same_shards(dbs, "t")
    for k in range(12):
        run(dbs, "execute", "SELECT k, w, v FROM t WHERE k = ?", (k,))
    run(dbs, "execute", "SELECT SUM(v) FROM t WHERE w < ?", (25,))
    same_shards(dbs, "t")
