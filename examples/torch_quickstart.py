"""Quickstart for the PyTorch port: the SQLcached cache daemon in 60
seconds (the counterpart of ``examples/quickstart.py``).

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The default device is the CUDA card: the table lives there, each statement
is one captured CUDA graph of the scan / compaction kernels, and the
``TENSOR(8)`` payload comes back as a CUDA tensor. ``--device cpu`` runs
every kernel's plain version.
"""
import argparse

import numpy as np

from repro_torch.core.daemon import SQLCached


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. A cache daemon. Tables are device-resident struct-of-arrays; TEXT
    #    is interned; every statement shape is planned once.
    db = SQLCached(device=args.device)
    db.execute(
        "CREATE TABLE fragments (page_id INT, user_id INT, kind TEXT, "
        "weight FLOAT, PAYLOAD emb TENSOR(8) F32) "  # complex data: a tensor
        "CAPACITY 1024 MAX_SELECT 32 TTL 1000")

    # 2. Structured INSERT — no serialize()/unserialize() round trip: the
    #    payload is a device tensor attached to the row.
    rows = [(1, 10, "header", 0.5), (1, 11, "body", 1.0),
            (2, 10, "header", 0.5), (2, 12, "nav", 0.25)]
    payloads = [{"emb": np.full(8, i, np.float32)} for i in range(len(rows))]
    db.executemany(
        "INSERT INTO fragments (page_id, user_id, kind, weight) "
        "VALUES (?, ?, ?, ?)", rows, payloads)

    # 3. Retrieval by complex criteria (paper §4.2) — not just exact keys.
    r = db.execute("SELECT page_id, user_id, kind FROM fragments "
                   "WHERE page_id = ? AND weight >= ?", (1, 0.5))
    print("page 1 fragments:", r.rows)

    # 4. Complex in-place operations (paper §4.4): extend TTLs, aggregate.
    db.execute("UPDATE fragments SET TTL = 5000 WHERE user_id = ?", (10,))
    r = db.execute("SELECT AVG(weight) FROM fragments")
    print("avg weight:", r.value)

    # 5. Fine-grained expiry (paper §4.3 / Table 2): one page, one user —
    #    not the memcached flush-everything hammer.
    print("expire page 2   ->", db.execute(
        "DELETE FROM fragments WHERE page_id = ?", (2,)).count, "rows")
    print("expire user 11  ->", db.execute(
        "DELETE FROM fragments WHERE user_id = ?", (11,)).count, "rows")
    print("rows left:", db.live_rows("fragments"))

    # 6. The payload comes back as a device tensor, sliceable, zero
    #    pickling.
    r = db.execute("SELECT PAYLOAD(emb), kind FROM fragments "
                   "WHERE page_id = 1")
    emb = r.payloads["emb"]
    print("payload tensor shape:", tuple(emb.shape), "dtype:", emb.dtype,
          "device:", emb.device)
    return db


if __name__ == "__main__":
    main()
