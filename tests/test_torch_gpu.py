"""The port's CUDA kernels against their plain PyTorch versions, on the
card, with exact equality (ids, masks, counts and index lanes are
integers and bits). Every test skips with a reason where no CUDA card is
present; run them on the card with ``python -m pytest -m gpu
tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import hashidx as HX
from repro_torch.kernels import relscan as RS

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _scan_case(rng, cap, nterms, w, dev):
    cols = [torch.tensor(rng.integers(-50, 50, cap), dtype=torch.int32,
                         device=dev) for _ in range(nterms)]
    valid = torch.tensor(rng.random(cap) < 0.7, device=dev)
    vals = torch.tensor(rng.integers(-40, 40, (w, nterms)),
                        dtype=torch.int32, device=dev)
    ops = tuple(rng.choice(list(RS.OP_CODES), nterms))
    return cols, valid, vals, ops


@pytest.mark.parametrize("cap", [1, 255, 256, 100_003, 131_072])
@pytest.mark.parametrize("nterms", [1, 2, 4])
@pytest.mark.parametrize("w", [1, 5])
def test_scan_and_compact_match_plain(cuda, cap, nterms, w):
    rng = np.random.default_rng(cap * 10 + nterms * 3 + w)
    cols, valid, vals, ops = _scan_case(rng, cap, nterms, w, cuda)
    mask, cnt = RS.scan(cols, valid, vals, ops)
    mask_r, cnt_r = RS.scan_ref(cols, valid, vals, ops)
    torch.cuda.synchronize()
    assert torch.equal(mask, mask_r) and torch.equal(cnt, cnt_r)
    for limit in (1, 64, 1000):
        ids = RS.compact(mask, cnt, limit)
        torch.cuda.synchronize()
        assert torch.equal(ids, RS.compact_ref(mask_r, cnt_r, limit))


@pytest.mark.parametrize("cap,frac", [(131_072, 0.76), (4096, 0.0),
                                      (4096, 1.0), (100_003, 0.5)])
def test_build_matches_plain(cuda, cap, frac):
    rng = np.random.default_rng(cap)
    keys = torch.tensor(rng.integers(-2**31, 2**31 - 1, cap),
                        dtype=torch.int32, device=cuda)
    keys[: cap // 3] = torch.tensor(rng.integers(0, 1000, cap // 3),
                                    dtype=torch.int32, device=cuda)
    valid = torch.tensor(rng.random(cap) < frac, device=cuda)
    nb = HX.n_buckets_for(cap)
    got = HX.build(keys, valid, n_buckets=nb)
    want = HX.build_ref(keys, valid, n_buckets=nb)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("w", [1, 64, 4096])
def test_probe_matches_plain(cuda, w):
    rng = np.random.default_rng(w)
    cap = 131_072
    keys = torch.tensor(rng.integers(0, 30_000, cap), dtype=torch.int32,
                        device=cuda)
    valid = torch.ones(cap, dtype=torch.bool, device=cuda)
    rid, key, _ = HX.build_ref(keys, valid, n_buckets=HX.n_buckets_for(cap))
    q = torch.tensor(rng.integers(-100, 40_000, w), dtype=torch.int32,
                     device=cuda)
    q[0] = keys[0]  # at least one hit
    got = HX.probe(rid, key, q)
    want = HX.probe_ref(rid, key, q)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(got[1].any())  # hits and misses both present


def test_cuda_tensor_never_takes_plain_version(cuda):
    from repro_torch.kernels import _build
    _build.reset_launches()
    cap = 4096
    c = torch.zeros(cap, dtype=torch.int32, device=cuda)
    v = torch.ones(cap, dtype=torch.bool, device=cuda)
    RS.relscan([c], v, torch.zeros((1, 1), dtype=torch.int32, device=cuda),
               ops=("==",), limit=8)
    rid, key, _ = HX.build(c, v, n_buckets=HX.n_buckets_for(cap))
    HX.probe(rid, key, torch.zeros(3, dtype=torch.int32, device=cuda))
    assert all(n == 1 for n in _build.launches.values()), _build.launches


def test_daemon_dispatch_is_sync_free(cuda):
    """No statement dispatch syncs with the host on the card; only the
    lazy Result's first access copies back."""
    from repro_torch.core import SQLCached
    db = SQLCached()
    db.execute("CREATE TABLE t (k INT, w INT, s TEXT, INDEX(k)) "
               "CAPACITY 4096 MAX_SELECT 16 TTL 50 OPS_INTERVAL 7")
    db.executemany("INSERT INTO t (k, w, s) VALUES (?, ?, ?)",
                   [(i % 50, i, f"s{i}") for i in range(300)])
    db.drain()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rs = [db.execute("SELECT w, s FROM t WHERE k = ?", (3,)),
              db.execute("SELECT w FROM t WHERE w < ? AND k != ?", (40, 2)),
              db.execute("SELECT COUNT(*) FROM t WHERE s = ?", ("s7",)),
              db.execute("UPDATE t SET w = w + 1 WHERE k = ?", (4,)),
              db.execute("DELETE FROM t WHERE k = ?", (5,)),
              db.execute("INSERT INTO t (k, w, s) VALUES (?, ?, ?)",
                         (1, 2, "x")),
              db.execute("SELECT s FROM t ORDER BY w DESC LIMIT 4"),
              db.executemany("DELETE FROM t WHERE w = ?",
                             [(i,) for i in range(20)]),
              db.executemany("UPDATE t SET w = 0 WHERE k = ?",
                             [(6,), (7,)], per_statement=True),
              db.execute("EXPIRE t")]
        rs += db.executemany("SELECT w FROM t WHERE k = ?",
                             [(i,) for i in range(9)])
        rs += db.executemany("SELECT SUM(w) FROM t WHERE k = ?",
                             [(i,) for i in range(3)])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for r in rs:
        for x in (r if isinstance(r, list) else [r]):
            assert x.count >= 0
