"""The port's CUDA kernels against their plain PyTorch versions, on the
card: exact equality for the relscan and hash-index kernels (ids, masks,
counts and index lanes are integers and bits), and for the attention
kernels fp32 1e-5 (summation order) and bf16 2e-2 (one bf16 rounding of
the output; the int8 read path the same), and for the Mamba2 scan y
within 1e-4 and h_last within
1e-3 in fp32 (relative and absolute: summation order over up to 64-step
tiles and the tensor cores' 3-term TF32 products, ~3e-5), bf16 y within
2e-2. The paged-attention and scan cases include the edges of their split
and chunk designs, and a second call must give the same bits. The daemon
tests hold the card daemon, whose statements replay captured CUDA graphs,
against a CPU daemon: equal results and states, no sync, no miss after a
warm-up, one graph launch a warm statement. The serving engines, whose
decode round replays one captured CUDA graph, are held against CPU
engines the same way: equal tokens and logits within 1e-4, no sync from
the capture on, one graph launch and two copies a warm round, exact
launch counts; the MoE, frontend and encoder-decoder engines the same
way, and the MoE router's top-k keeps ties in index order on the card.
The flash backward kernels are held against
their plain version (fp32 within 1e-4, bf16 within 2e-2 of the largest
gradient), bit-equal on a second call; autograd reaches them through
FlashAttention; the Mamba2 scan's backward kernel is held against its
plain version the same way and autograd reaches it through Mamba2Scan; a
SMOKE gemma2-2b training step through the kernels is held against the
same step with the plain attention, and a SMOKE zamba2 step on the card
against the same step on the CPU. Head dim 4 runs the flash kernels at 8
through the wrappers' zero-padding, against the plain version; a capture
survives a collection of another graph on its own thread; the dense
decode step over placed weights and the train step with the residual
stream cut along the sequence match their mesh-free and unsplit forms on
repeated ``cuda:0``. Every test
skips with a reason where no CUDA card is present; run them on the card
with ``python -m pytest -m gpu tests/test_torch_gpu.py``."""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import hashidx as HX
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import paged_attention as PA
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
    mask, cnt, n = RS.scan(cols, valid, vals, ops)
    mask_r, cnt_r, n_r = RS.scan_ref(cols, valid, vals, ops)
    torch.cuda.synchronize()
    assert torch.equal(mask, mask_r) and torch.equal(cnt, cnt_r)
    assert torch.equal(n, n_r)
    for limit in (1, 64, 1000):
        ids, count = RS.compact(mask, limit)
        ids_r, count_r = RS.compact_ref(mask_r, limit)
        torch.cuda.synchronize()
        assert torch.equal(ids, ids_r) and torch.equal(count, count_r)
        assert torch.equal(count, cnt.sum(dim=1, dtype=torch.int32))


@pytest.mark.parametrize("cap", [1, 7, 255, 257, 100_003])
@pytest.mark.parametrize("w", [1, 3, 32, 33])
@pytest.mark.parametrize("nterms", [1, 2, 3, 4])
@pytest.mark.parametrize("offset", [0, 1])
def test_scan_edges_match_plain(cuda, cap, w, nterms, offset):
    """The one-launch scan at its edges: caps that are no multiple of its
    8 rows a thread or 256 rows a warp, w beyond the statements one CTA
    takes (mask rows off 8-byte alignment), and with ``offset`` 1 columns
    and validity that start off their 16-byte alignment (views one row
    into longer tensors). Mask, per-block counts and totals exact; a
    second call gives the same totals (the accumulator words are zero
    again after each launch)."""
    rng = np.random.default_rng(cap * 7 + w * 5 + nterms + offset)
    cols, valid, vals, ops = _scan_case(rng, cap + offset, nterms, w, cuda)
    cols = [c[offset:] for c in cols]
    valid = valid[offset:]
    want = RS.scan_ref(cols, valid, vals, ops)
    for _ in range(2):
        got = RS.scan(cols, valid, vals, ops)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _one_call_events(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def test_scan_and_probe_are_one_launch(cuda):
    """A scan call (mask, counts and totals) and a verified probe call
    each put one kernel on the card, and no memset or copy."""
    rng = np.random.default_rng(0)
    cols, valid, vals, ops = _scan_case(rng, 131_072, 2, 1, cuda)
    names = _one_call_events(lambda: RS.scan(cols, valid, vals, ops))
    assert len(names) == 1 and "scan_kernel" in names[0], names
    rid, key, keys, valid = _probe_index(cuda, 131_072, 0.9)
    q = keys[:32].clone()
    names = _one_call_events(lambda: HX.probe_verify(
        rid, key, q, valid=valid, keycol=keys, limit=64))
    assert len(names) == 1 and "probe_kernel" in names[0], names


@pytest.mark.parametrize("cap", [1, 255, 256, 100_003, 131_072, 4_194_304])
@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("kind", ["empty", "full", "sparse"])
def test_compact_matches_plain(cuda, cap, w, kind):
    """Exact ids and counts; limits below and above the count; rows that
    do not start on 16 bytes (w > 1 at caps that are not multiples of 16,
    and a sliced view)."""
    rng = np.random.default_rng(cap + w)
    p = {"empty": 0.0, "full": 1.0, "sparse": 0.002}[kind]
    mask = torch.tensor(rng.random((w, cap)) < p, device=cuda)
    for m in (mask, mask[:, 3:]):
        for limit in (1, 64, 1000, m.shape[1] + 3):
            ids, count = RS.compact(m, limit)
            ids_r, count_r = RS.compact_ref(m, limit)
            torch.cuda.synchronize()
            assert ids.dtype == torch.int32 and ids.shape == (w, limit)
            assert torch.equal(ids, ids_r), (limit, m.shape)
            assert torch.equal(count, count_r), (limit, m.shape)


def test_compact_is_one_launch(cuda):
    """One device kernel and no memset or copy per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    mask = torch.rand((1, 131_072), device=cuda) < 0.001
    RS.compact(mask, 64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        RS.compact(mask, 64)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "compact_kernel" in names[0], names


def _hot_bucket_keys(rng, cap, nb, n_hot, hot=7):
    """cap keys: ``hot`` at n_hot random rows, and at every other row a key
    whose bucket is not the hot key's, so that bucket holds exactly n_hot
    rows."""
    hot_b = int(HX.bucket_of(torch.tensor([hot], dtype=torch.int32), nb)[0])
    pool = np.arange(-50_000, 50_000, dtype=np.int32)
    pool = pool[HX.bucket_of(torch.from_numpy(pool), nb).numpy() != hot_b]
    keys = rng.choice(pool, cap).astype(np.int32)
    keys[rng.choice(cap, n_hot, replace=False)] = hot
    return keys


def _build_case(case):
    """(keys [cap] int32, valid [cap] bool, n_buckets) as numpy, for one
    named build case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    kind, _, arg = case.partition(" ")
    if kind == "mixed":             # full-range keys, a third of them small
        cap, frac = int(arg.split("/")[0]), float(arg.split("/")[1])
        keys = rng.integers(-2**31, 2**31 - 1, cap).astype(np.int32)
        keys[: cap // 3] = rng.integers(0, 1000, cap // 3)
        return keys, rng.random(cap) < frac, HX.n_buckets_for(cap)
    cap = int(arg) if arg else 131_072
    nb = HX.n_buckets_for(cap)
    ones = np.ones(cap, bool)
    if kind == "one_bucket":        # every valid row in one bucket
        return np.full(cap, -3, np.int32), ones, nb
    if kind in ("bucket_128", "bucket_129"):
        return _hot_bucket_keys(rng, cap, nb, int(kind[-3:])), ones, nb
    if kind == "user_id":           # Table 2's users: buckets over 128
        table = np.random.default_rng(0)
        table.integers(0, 30_000, 100_000)  # the page_id column comes first
        col = np.zeros(cap, np.int32)
        col[:100_000] = table.integers(0, 1_000, 100_000)
        return col, np.arange(cap) < 100_000, nb
    keys = rng.integers(-2**31, 2**31 - 1, cap).astype(np.int32)
    if kind.startswith("hot_"):     # hot keys 0, 1, ... of 300 rows each
        for h in range(int(kind[4:])):
            keys[rng.choice(cap, 300, replace=False)] = h
        return keys, rng.random(cap) < 0.9, nb
    if kind == "random":
        return keys, rng.random(cap) < 0.9, nb
    if kind == "nb_12":             # no power of two: buckets 8-11 empty
        return keys, rng.random(cap) < 0.8, 12
    if kind == "all_invalid":
        return keys, np.zeros(cap, bool), nb
    raise ValueError(case)


BUILD_CASES = ["mixed 131072/0.76", "mixed 4096/0.0", "mixed 4096/1.0",
               "mixed 100003/0.5", "one_bucket 4096", "one_bucket",
               "bucket_128 4096", "bucket_129 4096", "user_id", "hot_3",
               "hot_40", "hot_100",
               "random 4194304", "nb_12 300", "random 1", "random 100003",
               "all_invalid"]


@pytest.mark.parametrize("case", BUILD_CASES)
def test_build_matches_plain(cuda, case):
    """The two-launch build against its plain version, lane for lane and
    overflow included: mixed key ranges and valid fractions, every row in
    one bucket, buckets of exactly 128 and 129 rows, Table 2's user_id
    column (2 buckets over 128), 3, 40 and 100 buckets over 128 (the
    walk CTAs split a bucket's rows into chunks, or walk whole buckets
    when more than 32 are listed), 4,194,304 rows in 131,072 buckets, 12
    buckets (no power of two), caps 1 and 100,003 (no multiple of a
    CTA's rows or a walk's 4,096-row step), no valid row."""
    keys, valid, nb = _build_case(case)
    keys = torch.from_numpy(keys).to(cuda)
    valid = torch.from_numpy(valid).to(cuda)
    got = HX.build(keys, valid, n_buckets=nb)
    want = HX.build_ref(keys, valid, n_buckets=nb)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    if case.startswith(("one_bucket", "bucket_129", "user_id", "hot_")):
        assert int(got[2]) > 0


def test_build_back_to_back_on_one_scratch(cuda):
    """Builds that overflow and builds that do not, back to back on one
    stream and its one scratch, each equal to the plain version: the
    counters and the overflow word are zero again after every call; and
    a build off 16-byte alignment (a view one row in) reads row by row."""
    outs, wants = [], []
    for case in ("user_id", "random 131072", "one_bucket 4096",
                 "bucket_128 4096", "user_id"):
        keys, valid, nb = _build_case(case)
        keys = torch.from_numpy(keys).to(cuda)
        valid = torch.from_numpy(valid).to(cuda)
        outs.append(HX.build(keys, valid, n_buckets=nb))
        wants.append(HX.build_ref(keys, valid, n_buckets=nb))
        outs.append(HX.build(keys[1:], valid[1:], n_buckets=nb))
        wants.append(HX.build_ref(keys[1:], valid[1:], n_buckets=nb))
    torch.cuda.synchronize()
    for got, want in zip(outs, wants):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_build_replays_in_a_cuda_graph(cuda):
    """A build captured in a CUDA graph and replayed over new keys and
    validity gives the plain version's outputs each time (the scratch is
    made before the capture; the kernels leave it zero)."""
    keys, valid, nb = _build_case("user_id")
    keys = torch.from_numpy(keys).to(cuda)
    valid = torch.from_numpy(valid).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        HX.build(keys, valid, n_buckets=nb)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = HX.build(keys, valid, n_buckets=nb)
    try:
        for case in ("random 131072", "user_id", "mixed 131072/0.76"):
            k, v, _ = _build_case(case)
            keys.copy_(torch.from_numpy(k))
            valid.copy_(torch.from_numpy(v))
            graph.replay()
            torch.cuda.synchronize()
            want = HX.build_ref(keys, valid, n_buckets=nb)
            for a, b in zip(out, want):
                assert torch.equal(a, b), case
    finally:
        # hand the graph's pool and this test's cached blocks back, so
        # later tests that count the allocator's bytes see no leftovers
        del out, graph
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def test_build_is_two_launches_and_sync_free(cuda):
    """A build call puts its two kernels on the card and nothing else (no
    memset, no copy, no sort): 10 calls under the profiler show both
    kernels and at most 20 records, every one a build kernel (a profiled
    window may lose a record, never gain one). A call never waits for
    the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    keys, valid, nb = _build_case("user_id")
    keys = torch.from_numpy(keys).to(cuda)
    valid = torch.from_numpy(valid).to(cuda)
    HX.build(keys, valid, n_buckets=nb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            HX.build(keys, valid, n_buckets=nb)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) <= 20 and all("build_" in n for n in names), names
    assert {"build_rows_kernel", "build_buckets_kernel"} <= {
        re.search(r"build_\w+_kernel", n).group(0) for n in names}, names
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = HX.build(keys, valid, n_buckets=nb)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = HX.build_ref(keys, valid, n_buckets=nb)
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


def _probe_index(dev, cap, frac, seed=0, key_hi=30_000):
    """A table column, its validity and the index built over it."""
    rng = np.random.default_rng(seed)
    keys = torch.tensor(rng.integers(0, key_hi, cap), dtype=torch.int32,
                        device=dev)
    valid = torch.tensor(rng.random(cap) < frac, device=dev)
    rid, key, _ = HX.build_ref(keys, valid, n_buckets=HX.n_buckets_for(cap))
    return rid, key, keys, valid


@pytest.mark.parametrize("w", [1, 32, 4096])
@pytest.mark.parametrize("nres", [0, 1, 2, 3, 4, 8])
@pytest.mark.parametrize("limit", [1, 64, 200])
@pytest.mark.parametrize("gates", [False, True])
def test_probe_verify_matches_plain(cuda, w, nres, limit, gates):
    """The verified probe against its plain version, exactly: 0-4 and 8
    residual terms (both instances of the kernel), an extra mask and an
    active flag (``gates``), limits below and beyond the bucket's 128
    lanes, buckets in row order and out of it. Keys repeat (up to ~30 rows
    a key) and some rows of the index are dead, so candidates fail every
    check. Beyond 3 terms each term passes most rows (an ``==`` term
    compares the key column with the query key), so matches remain."""
    rng = np.random.default_rng(w * 10 + nres + limit)
    cap = 131_072
    rid, key, keys, valid = _probe_index(cuda, cap, 0.8, seed=w, key_hi=5000)
    valid[rng.integers(0, cap, 2000)] = False   # rows dead after the build
    q = torch.tensor(rng.integers(-5, 5200, w), dtype=torch.int32,
                     device=cuda)
    q[0] = keys[int(torch.nonzero(valid)[0])]
    ops = list(RS.OP_CODES)
    if nres <= 3:
        residual = [(torch.tensor(rng.integers(-20, 20, cap),
                                  dtype=torch.int32, device=cuda),
                     ops[(t + nres) % 6],
                     torch.tensor(rng.integers(-5, 5, w), dtype=torch.int32,
                                  device=cuda)) for t in range(nres)]
    else:
        lo_hi = {"!=": (-5, 5), "<": (10, 20), "<=": (10, 20),
                 ">": (-20, -10), ">=": (-20, -10)}
        residual = []
        for t in range(nres):
            op = ops[(t + nres) % 6]
            if op == "==":
                residual.append((keys, op, q))
                continue
            residual.append((
                torch.tensor(rng.integers(-20, 20, cap), dtype=torch.int32,
                             device=cuda), op,
                torch.tensor(rng.integers(*lo_hi[op], w), dtype=torch.int32,
                             device=cuda)))
    kw = dict(valid=valid, keycol=keys, residual=residual, limit=limit)
    if gates:
        kw["extra_mask"] = torch.tensor(rng.random(cap) < 0.6, device=cuda)
        kw["active"] = torch.tensor(rng.random(w) < 0.8, device=cuda)
        kw["active"][0] = True
    # the built layout (each bucket in row order) and the same index with
    # every bucket's lanes permuted, as insertions may leave them
    perm = torch.from_numpy(rng.permutation(HX.BUCKET_CAP)).to(cuda)
    for r, k in ((rid, key), (rid[:, perm].contiguous(),
                              key[:, perm].contiguous())):
        got = HX.probe_verify(r, k, q, **kw)
        want = HX.probe_verify_ref(r, k, q, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert int(got[2].sum()) > 0


def test_probe_verify_on_a_stale_bucket(cuda):
    """A key with more rows than a bucket's 128 lanes (the index is stale):
    the probe sees the 128 it holds, in row order, as the plain version."""
    cap = 4096
    keys = torch.full((cap,), 7, dtype=torch.int32, device=cuda)
    keys[::3] = torch.arange(0, cap, 3, dtype=torch.int32, device=cuda)
    valid = torch.ones(cap, dtype=torch.bool, device=cuda)
    rid, key, overflow = HX.build_ref(keys, valid,
                                      n_buckets=HX.n_buckets_for(cap))
    assert int(overflow) > 0
    q = torch.tensor([7, 0, 3, 9], dtype=torch.int32, device=cuda)
    for limit in (1, 64, 200):
        got = HX.probe_verify(rid, key, q, valid=valid, keycol=keys,
                              limit=limit)
        want = HX.probe_verify_ref(rid, key, q, valid=valid, keycol=keys,
                                   limit=limit)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int(got[2][0]) == 128


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
    HX.probe_verify(rid, key, torch.zeros(3, dtype=torch.int32, device=cuda),
                    valid=v, keycol=c, limit=4)
    f = torch.rand((1, 5, 2), device=cuda)
    # a gradient: the scan's forward and its backward
    xg = torch.randn((1, 5, 2, 8), device=cuda, requires_grad=True)
    MS.mamba2_scan(xg, f, -f, torch.randn((1, 5, 4), device=cuda),
                   torch.randn((1, 5, 4), device=cuda))[0].sum().backward()
    q = torch.randn((1, 4, 5, 64), device=cuda)
    k = torch.randn((1, 2, 5, 64), device=cuda)
    FA.flash_attention(q, k, k, scale=0.125)
    arena = torch.randn((3, 2, 4, 2, 64), device=cuda)
    pages = torch.tensor([[2, 0]], dtype=torch.int32, device=cuda)
    lens = torch.tensor([6], dtype=torch.int32, device=cuda)
    PA.paged_attention(q[:, :, 0], arena, pages, lens, scale=0.125)
    # the serving mesh's call forms: block starts and the lse; block
    # starts alone (paged_wide_kernel, an output of q's dtype)
    starts = torch.tensor([[0, 4]], dtype=torch.int32, device=cuda)
    PA.paged_attention(q[:, :, 0], arena, pages, lens, scale=0.125,
                       blk_start=starts, return_lse=True)
    PA.paged_attention(q[:, :, 0], arena, pages, lens, scale=0.125,
                       blk_start=starts)
    # a gradient: the forward with its lse store, the three backward ones
    qg = q.clone().requires_grad_()
    FA.flash_attention(qg, k, k, scale=0.125).sum().backward()
    want = dict.fromkeys(_build.launches, 1) | {"hash_probe": 2}
    assert _build.launches == want, _build.launches


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
    _release(db)


def _release(*dbs):
    """Drop the daemons' tables and hand their graphs' pools and cached
    blocks back (later tests count the allocator's bytes)."""
    import gc

    from repro_torch.core import execache as EC
    for db in dbs:
        for name in list(db.tables):
            db.execute(f"DROP TABLE {name}")
    torch.cuda.synchronize()
    EC._sweep()
    gc.collect()
    torch.cuda.empty_cache()


def _graph_pair(ddl, warmup=True):
    """A card daemon and a CPU daemon holding the same table, their
    CREATE-time warm-ups drained."""
    from repro_torch.core import SQLCached
    dbs = (SQLCached(warmup=warmup), SQLCached(device="cpu", warmup=warmup))
    for db in dbs:
        db.execute(ddl)
        db.drain_warmup()
    return dbs


def _snap(r):
    if isinstance(r, list):
        return [_snap(x) for x in r]
    ids = r.row_ids
    return {"count": r.count, "value": r.value, "rows": r.rows,
            "row_ids": None if ids is None else np.asarray(ids).tolist()}


def _both(dbs, kind, sql, *args):
    """One statement on both daemons (the card's dispatch under sync
    debugging set to "error"); the results must be equal."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = getattr(dbs[0], kind)(sql, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got, want = _snap(got), _snap(getattr(dbs[1], kind)(sql, *args))
    assert got == want, sql
    return got


def _executors(db, table):
    import json
    return json.loads(db.execute(f"SHOW STATS {table}").value)["executors"]


def _same_state(dbs, table):
    from repro_torch import convert as CV
    got, want = (CV.state_to_numpy(db.table_state(table)) for db in dbs)
    np.testing.assert_equal(got, want)


T2_SINGLES = (   # (statement, its bound values for round i)
    ("DELETE FROM c WHERE page_id = ?", lambda p, u, i: (p[7 * i],)),
    ("DELETE FROM c WHERE user_id = ?", lambda p, u, i: (u[3 * i],)),
    ("SELECT * FROM c WHERE page_id = ? LIMIT 64",
     lambda p, u, i: (p[7 * i + 1],)),
    ("SELECT page_id, data FROM c WHERE user_id = ? AND page_id < ?",
     lambda p, u, i: (u[i + 50], 3_000)),
    ("UPDATE c SET data = data + 1 WHERE page_id = ?",
     lambda p, u, i: (p[7 * i + 2],)),
    ("SELECT COUNT(*) FROM c WHERE user_id = ?", lambda p, u, i: (u[i],)),
)


@pytest.mark.parametrize("extra", ["", ", INDEX(page_id), INDEX(user_id)"])
def test_graphs_table2_warmed_equal_cpu(cuda, extra):
    """Table 2's statements, planned by WARMUP, replay with no miss and no
    sync, and equal a CPU daemon; the table's tensors keep their
    addresses; a cold shape (a capture on a miss) syncs no more than a
    warm one."""
    rng = np.random.default_rng(1)
    n, cap = 20_000, 32_768
    pages = rng.integers(0, 6_000, n)
    users = rng.integers(0, 200, n)
    dbs = _graph_pair(f"CREATE TABLE c (page_id INT, user_id INT, data "
                      f"BIGINT{extra}) CAPACITY {cap} MAX_SELECT 64")
    _both(dbs, "executemany",
          "INSERT INTO c (page_id, user_id, data) VALUES (?, ?, ?)",
          [(int(p), int(u), i) for i, (p, u) in enumerate(zip(pages, users))])
    ptrs = [t.data_ptr() for t in _leaves(dbs[0].table_state("c"))]
    for sql, _ in T2_SINGLES:
        counts = [db.execute(f"WARMUP c LIKE '{sql}'").count for db in dbs]
        assert counts[0] == counts[1], sql
    st0 = _executors(dbs[0], "c")
    assert st0 == _executors(dbs[1], "c") | {
        "compile_ms_total": st0["compile_ms_total"]}
    p, u = pages.tolist(), users.tolist()
    for i in range(6):
        for sql, args in T2_SINGLES:
            _both(dbs, "execute", sql, args(p, u, i))
    st1 = _executors(dbs[0], "c")
    assert st1["misses"] == st0["misses"]
    assert st1["hits"] == st0["hits"] + 6 * len(T2_SINGLES)
    # a cold shape: one miss, captured and replayed without a sync
    _both(dbs, "execute", "SELECT data FROM c WHERE page_id = ?",
          (int(pages[5]),))
    assert _executors(dbs[0], "c")["misses"] == st0["misses"] + 1
    _both(dbs, "execute", "EXPIRE c")
    _both(dbs, "execute", "SELECT COUNT(*) FROM c")
    _same_state(dbs, "c")
    # REINDEX retires every plan (an epoch bump; it reads the residual
    # overflow back, an admin statement's sync); swap_table_state copies a
    # state into the table's tensors; the statements after both still
    # equal the CPU daemon's
    got, want = (_snap(db.execute("REINDEX c")) for db in dbs)
    assert got == want
    assert _executors(dbs[0], "c")["epoch"] == st0["epoch"] + (
        1 if extra else 0)
    dbs[0].swap_table_state("c", _to_cuda(dbs[1].table_state("c")))
    for sql, args in T2_SINGLES:
        _both(dbs, "execute", sql, args(p, u, 7))
    _same_state(dbs, "c")
    assert [t.data_ptr() for t in _leaves(dbs[0].table_state("c"))] == ptrs
    _release(*dbs)


def _to_cuda(tree):
    return {k: _to_cuda(v) if isinstance(v, dict) else v.cuda()
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_graphs_fig1_warmed_equal_cpu(cuda):
    """Fig. 1's key-value read, single and W = 32, warmed, equal a CPU
    daemon with no miss after the warm-up."""
    rng = np.random.default_rng(2)
    sizes = [16, 64, 256, 1024, 4096]
    idx = np.minimum(rng.geometric(0.5, size=128) - 1, len(sizes) - 1)
    values = {f"k{i}": "x" * sizes[j] for i, j in enumerate(idx)}
    dbs = _graph_pair("CREATE TABLE kv (k TEXT, v TEXT) CAPACITY 256 "
                      "MAX_SELECT 8")
    _both(dbs, "executemany", "INSERT INTO kv (k, v) VALUES (?, ?)",
          list(values.items()))
    sql = "SELECT v FROM kv WHERE k = ? LIMIT 1"
    for db in dbs:
        db.execute(f"WARMUP kv LIKE '{sql}'")
    keys = [f"k{int(i)}" for i in rng.integers(0, 128, 64)]
    _both(dbs, "executemany", sql, [(k,) for k in keys[:32]])
    st0 = _executors(dbs[0], "kv")
    for k in keys:
        assert _both(dbs, "execute", sql, (k,))["rows"] == [{"v": values[k]}]
    _both(dbs, "executemany", sql, [(k,) for k in keys[32:]])
    assert _executors(dbs[0], "kv")["misses"] == st0["misses"]
    _same_state(dbs, "kv")
    _release(*dbs)


def test_warm_statement_is_one_graph_launch(cuda):
    """A warm statement puts one cudaGraphLaunch and no kernel launch on
    the card (besides its two copies: bound values in, outputs out)."""
    from torch.profiler import ProfilerActivity, profile
    dbs = _graph_pair("CREATE TABLE t (k INT, v INT, INDEX(k)) "
                      "CAPACITY 4096 MAX_SELECT 16")
    _both(dbs, "executemany", "INSERT INTO t (k, v) VALUES (?, ?)",
          [(i % 97, i) for i in range(3000)])
    sqls = ("SELECT * FROM t WHERE k = ?", "DELETE FROM t WHERE v = ?",
            "UPDATE t SET v = v + 1 WHERE k = ?")
    db = dbs[0]
    for sql in sqls:
        db.execute(sql, (1,))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(10):
            for sql in sqls:
                db.execute(sql, (i,))
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert names.count("cudaGraphLaunch") == 30, names.count(
        "cudaGraphLaunch")
    assert not [x for x in names if x in ("cudaLaunchKernel",
                                          "cuLaunchKernel",
                                          "cudaLaunchKernelExC")]
    _release(*dbs)


def test_background_capture_races_replays(cuda):
    """WARMUP of new shapes in another thread captures while this thread
    replays another shape of the same table: every replay equals a CPU
    daemon's answer, and so do the new shapes afterwards."""
    import threading
    dbs = _graph_pair("CREATE TABLE t (k INT, v INT, s TEXT, INDEX(k)) "
                      "CAPACITY 8192 MAX_SELECT 16")
    _both(dbs, "executemany", "INSERT INTO t (k, v, s) VALUES (?, ?, ?)",
          [(i % 301, i, f"s{i % 7}") for i in range(6000)])
    new = ("SELECT v FROM t WHERE s = ? AND v < ?",
           "SELECT SUM(v) FROM t WHERE k < ?",
           "DELETE FROM t WHERE v = ?",
           "UPDATE t SET v = v + 2 WHERE s = ?",
           "SELECT k, s FROM t WHERE v > ? LIMIT 8")
    errors = []

    def warm():
        try:
            for sql in new:
                dbs[0].execute(f"WARMUP t LIKE '{sql}'")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    th = threading.Thread(target=warm)
    th.start()
    for i in range(200):
        _both(dbs, "execute", "SELECT v, s FROM t WHERE k = ?", (i % 301,))
        _both(dbs, "execute", "UPDATE t SET v = v + 1 WHERE k = ?", (i,))
    th.join()
    assert not errors, errors
    st = _executors(dbs[0], "t")
    for sql, args in zip(new, (("s3", 2000), (40,), (17,), ("s5",), (5990,))):
        _both(dbs, "execute", sql, args)
    assert _executors(dbs[0], "t")["misses"] == st["misses"]
    _same_state(dbs, "t")
    _release(*dbs)


def test_graph_survives_scratch_growth(cuda):
    """A SELECT captured before a wider executemany grows the compaction's
    scratch still answers right afterwards: the graph keeps the buffer it
    captured."""
    dbs = _graph_pair("CREATE TABLE t (k INT, v INT) CAPACITY 131072 "
                      "MAX_SELECT 64")
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 20_000, 100_000)
    _both(dbs, "executemany", "INSERT INTO t (k, v) VALUES (?, ?)",
          [(int(k), i) for i, k in enumerate(keys)])
    sql = "SELECT * FROM t WHERE k = ? LIMIT 64"
    _both(dbs, "execute", sql, (int(keys[0]),))
    _both(dbs, "executemany", sql, [(int(k),) for k in keys[:256]])
    for k in keys[300:340]:
        _both(dbs, "execute", sql, (int(k),))
    _same_state(dbs, "t")
    _release(*dbs)


ATT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


# ------------------------------------------------------------- shard axis

def _shard_case(rng, n_sh, cap_s, dev):
    keys = rng.integers(-50_000, 50_000, (n_sh, cap_s)).astype(np.int32)
    if cap_s >= 300:   # one bucket over 128 rows, in shard 0 only
        keys[0, rng.choice(cap_s, 300, replace=False)] = 7
    cols = [torch.tensor(keys, device=dev)] + [
        torch.tensor(rng.integers(-50, 50, (n_sh, cap_s)), dtype=torch.int32,
                     device=dev) for _ in range(3)]
    valid = rng.random((n_sh, cap_s)) < 0.8
    valid[1:2] = False   # a shard with no valid row
    return cols, torch.tensor(valid, device=dev)


def _sids(rng, n_sh, w, fanout, dev):
    sid = (np.repeat(np.arange(n_sh), w) if fanout
           else rng.integers(0, n_sh, w))
    return torch.tensor(sid, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("n_sh", [1, 2, 3, 8])
@pytest.mark.parametrize("cap_s", [1, 25, 16_384, 100_003])
@pytest.mark.parametrize("fanout", [True, False])
def test_shard_axis_scan_and_compact_match_plain(cuda, n_sh, cap_s, fanout):
    rng = np.random.default_rng(n_sh * 7 + cap_s)
    cols, valid = _shard_case(rng, n_sh, cap_s, cuda)
    for w in (1, 32):
        sid = _sids(rng, n_sh, w, fanout, cuda)
        for nt in (1, 2, 4):
            ops = tuple(rng.choice(list(RS.OP_CODES), nt))
            vals = torch.tensor(rng.integers(-60, 60, (sid.shape[0], nt)),
                                dtype=torch.int32, device=cuda)
            got = RS.scan(cols[4 - nt:], valid, vals, ops, sid=sid,
                          run=w if fanout else 1)
            want = RS.scan_ref(cols[4 - nt:], valid, vals, ops, sid=sid)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            for limit in (1, 64):
                for a, b in zip(RS.compact(got[0], limit),
                                RS.compact_ref(want[0], limit)):
                    assert torch.equal(a, b)


@pytest.mark.parametrize("n_sh", [1, 2, 3, 8])
@pytest.mark.parametrize("cap_s", [1, 25, 16_384, 100_003])
def test_shard_axis_build_and_probe_match_plain(cuda, n_sh, cap_s):
    from repro_torch.kernels import _build
    rng = np.random.default_rng(n_sh * 11 + cap_s)
    cols, valid = _shard_case(rng, n_sh, cap_s, cuda)
    nb = HX.n_buckets_for(cap_s)
    want = HX.build_ref(cols[0], valid, n_buckets=nb)
    for _ in range(2):   # back to back: the scratch is zero again
        _build.reset_launches()
        got = HX.build(cols[0], valid, n_buckets=nb)
        assert _build.launches["hash_build"] == 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    rid, key, _ = got
    for fanout in (True, False):
        for w in (1, 32):
            sid = _sids(rng, n_sh, w, fanout, cuda)
            n = sid.shape[0]
            q = cols[0][sid.long(), torch.tensor(
                rng.integers(0, cap_s, n), device=cuda)]
            q[0] = 7
            residual = [(cols[1], "<", torch.tensor(
                rng.integers(-40, 40, n), dtype=torch.int32, device=cuda))]
            kw = dict(valid=valid, keycol=cols[0], residual=residual,
                      extra_mask=torch.tensor(rng.random((n_sh, cap_s)) < .7,
                                              device=cuda),
                      active=torch.tensor(rng.random(n) < .8, device=cuda),
                      limit=64, sid=sid)
            _build.reset_launches()
            got = HX.probe_verify(rid, key, q, **kw)
            assert _build.launches["hash_probe"] == 1
            for a, b in zip(got, HX.probe_verify_ref(rid, key, q, **kw)):
                assert torch.equal(a, b)


def test_sharded_daemon_equals_cpu(cuda):
    """A sharded table (lanes and fan-out, indexed off the partition
    column) on the card equals a CPU daemon, with no sync, a warm pruned
    statement replaying its lane's graph, and RESHARD."""
    rng = np.random.default_rng(5)
    n = 20_000
    pages = rng.integers(0, 6_000, n).tolist()
    users = rng.integers(0, 200, n).tolist()
    dbs = _graph_pair("CREATE TABLE c (page_id INT, user_id INT, data BIGINT, "
                      "INDEX(page_id)) CAPACITY 32768 MAX_SELECT 64 "
                      "SHARDS 8 PARTITION BY user_id", warmup=False)
    _both(dbs, "executemany",
          "INSERT INTO c (page_id, user_id, data) VALUES (?, ?, ?)",
          [(p, u, i) for i, (p, u) in enumerate(zip(pages, users))])
    stmts = (("SELECT * FROM c WHERE user_id = ? LIMIT 64",
              lambda i: (users[i],)),
             ("DELETE FROM c WHERE user_id = ? AND page_id < ?",
              lambda i: (users[50 + i], 1_000)),
             ("SELECT * FROM c WHERE page_id = ? LIMIT 64",
              lambda i: (pages[i],)),
             ("DELETE FROM c WHERE page_id = ?", lambda i: (pages[100 + i],)),
             ("SELECT COUNT(*) FROM c WHERE page_id = ?",
              lambda i: (pages[200 + i],)),
             ("UPDATE c SET data = data + 1 WHERE page_id = ?",
              lambda i: (pages[300 + i],)))
    for rnd in range(2):
        for i in range(6):
            for sql, args in stmts:
                _both(dbs, "execute", sql, args(i + 10 * rnd))
        _both(dbs, "executemany", "SELECT data FROM c WHERE user_id = ?",
              [(u,) for u in users[400:432]])
        _same_state(dbs, "c")
        got, want = (_snap(db.execute(f"ALTER TABLE c RESHARD {4 - 2 * rnd}"))
                     for db in dbs)
        assert got == want
    _both(dbs, "execute", stmts[0][0], (users[3],))
    st0 = _executors(dbs[0], "c")
    _both(dbs, "execute", stmts[0][0], (users[3],))
    st1 = _executors(dbs[0], "c")
    assert (st1["misses"], st1["hits"]) == (st0["misses"], st0["hits"] + 1)
    _same_state(dbs, "c")
    _release(*dbs)


SNAP_DDL = ("CREATE TABLE c (id INT, v INT, INDEX(v)) CAPACITY 16384 "
            "MAX_SELECT 64 SHARDS 4 PARTITION BY id")
SNAP_STMTS = (("SELECT * FROM c WHERE id = ? LIMIT 64", lambda i: (i,)),
              ("SELECT id FROM c WHERE v = ?", lambda i: (i % 97,)),
              ("SELECT COUNT(*) FROM c WHERE v < ?", lambda i: (i % 97,)))


def _snap_pair(rng, warmup):
    dbs = _graph_pair(SNAP_DDL, warmup=warmup)
    _both(dbs, "executemany", "INSERT INTO c (id, v) VALUES (?, ?)",
          [(int(k), int(v)) for k, v in zip(rng.integers(-3000, 3000, 8000),
                                            rng.integers(0, 97, 8000))])
    return dbs


def _snap_round(dbs, base):
    for i in range(4):
        for sql, args in SNAP_STMTS:
            _both(dbs, "execute", sql, args(base + i))


def test_retired_entry_captures_into_a_pool_of_its_own(cuda):
    """An entry held across an epoch bump (a warm-up racing RESTORE or
    RESHARD) that still plans captures into a pool of its own, so freeing
    it leaves the current epoch's pool with its graphs: capturing into a
    shared pool whose graphs were all freed fails in PyTorch's caching
    allocator."""
    import gc

    from repro_torch.core import execache as EC

    def body(st, flag, a):
        return dict(st, x=st["x"] + a), st["x"].sum()

    cache = EC.ExecutorCache(cuda, lambda: {"x": torch.zeros(4, device=cuda)})
    state = {"x": torch.zeros(4, device=cuda)}
    args = (np.ones(4, np.float32),)
    stale = cache.get("k", lambda: body)
    cache.bump()
    stale(state, False, args)   # plans and replays in the retired entry
    del stale
    torch.cuda.synchronize()
    EC._sweep()
    gc.collect()
    for key in ("k", "j"):   # two captures that share the current pool
        cache.get(key, lambda: body)(state, False, args)
    torch.cuda.synchronize()
    assert torch.equal(state["x"], torch.full((4,), 3.0, device=cuda))
    cache.close()
    _release()


def test_retain_writes_valid_in_place_under_warm_plans(cuda):
    """RETAIN SLOTS on the card is one masked pass, one graph, that writes
    the stacked ``valid`` in place: lane and fan-out plans captured BEFORE
    it still answer correctly after it (no epoch bump, no new capture),
    equal to a CPU daemon, and it dispatches without a sync."""
    rng = np.random.default_rng(17)
    dbs = _snap_pair(rng, warmup=False)
    _snap_round(dbs, 0)
    _snap_round(dbs, 0)   # every shape planned (captured) by now
    valid = dbs[0].tables["c"].state["valid"]
    ptr = valid.data_ptr()
    st0 = _executors(dbs[0], "c")
    for r in range(2):
        slots = sorted(rng.choice(64, 32, replace=False).tolist())
        got = _both(dbs, "execute", f"ALTER TABLE c RETAIN SLOTS "
                                    f"{','.join(map(str, slots))} OF 64")
        assert got["count"] > 0 and got["value"] == 32
        _same_state(dbs, "c")
        assert dbs[0].tables["c"].state["valid"].data_ptr() == ptr
        before = _executors(dbs[0], "c")
        _snap_round(dbs, 0)
        after = _executors(dbs[0], "c")
        assert after["misses"] == before["misses"], "a warm plan re-planned"
    st1 = _executors(dbs[0], "c")
    assert st1["epoch"] == st0["epoch"]
    _same_state(dbs, "c")
    _release(*dbs)


def test_restore_retires_plans_and_replans(cuda, tmp_path):
    """RESTORE on the card installs new tensors, so every plan is retired
    (a new epoch, no cached plan) and re-planned on first use; the
    statements then equal a CPU daemon that restored the same files, at
    the table's shard count and after a RESHARD to another one. The card
    and the CPU daemon write the same checkpoint."""
    import json
    rng = np.random.default_rng(19)
    dbs = _snap_pair(rng, warmup=True)
    _snap_round(dbs, 0)
    dirs = [tmp_path / "card", tmp_path / "cpu"]
    counts = [db.execute(f"CHECKPOINT c TO '{d}'").count
              for db, d in zip(dbs, dirs)]
    assert counts[0] == counts[1] > 0
    metas = [json.loads((d / "step_0" / "meta.json").read_text())
             for d in dirs]
    assert metas[0] == metas[1]
    for leaf in metas[0]["names"].values():
        np.testing.assert_array_equal(np.load(dirs[0] / "step_0" / leaf),
                                      np.load(dirs[1] / "step_0" / leaf))
    for shards in (4, 2):
        if shards != 4:
            for db in dbs:
                db.execute(f"ALTER TABLE c RESHARD {shards}")
        _both(dbs, "execute", "FLUSH c")
        e0 = _executors(dbs[0], "c")["epoch"]
        got = [db.execute(f"RESTORE c FROM '{dirs[0]}'").count for db in dbs]
        assert got == [counts[0]] * 2
        st = _executors(dbs[0], "c")
        assert (st["epoch"], st["cached"]) == (e0 + 1, 0)
        _same_state(dbs, "c")
        _snap_round(dbs, 40)
        m0 = _executors(dbs[0], "c")["misses"]
        _snap_round(dbs, 40)
        assert _executors(dbs[0], "c")["misses"] == m0
        _same_state(dbs, "c")
    _release(*dbs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,kh,sq,sk,hd,causal,window,softcap,q_offset",
    [
        (2, 4, 4, 128, 128, 64, True, 0, 0.0, 0),
        (1, 8, 2, 256, 256, 64, True, 0, 0.0, 0),     # GQA
        (2, 4, 2, 128, 256, 32, False, 0, 0.0, 0),    # sq != sk
        (1, 4, 4, 256, 256, 64, True, 96, 0.0, 0),    # window
        (2, 2, 2, 64, 64, 128, True, 48, 30.0, 0),    # window + softcap
        (1, 32, 4, 21, 21, 128, True, 0, 0.0, 0),     # serve prefill, ragged
        (1, 4, 2, 13, 40, 256, True, 7, 20.0, 27),    # q_offset, hd 256
        (3, 6, 3, 1, 1, 128, True, 0, 0.0, 0),        # one token
        (2, 8, 4, 13, 13, 8, True, 0, 0.0, 0),        # head dim 8 (SMOKE)
        (1, 4, 2, 37, 37, 16, True, 5, 10.0, 0),      # head dim 16
        (1, 32, 32, 24, 24, 80, True, 0, 0.0, 0),     # zamba2 shared block
        (1, 32, 32, 300, 300, 80, True, 0, 0.0, 0),   # its long prompt
    ])
def test_flash_attention_matches_plain(cuda, b, h, kh, sq, sk, hd, causal,
                                       window, softcap, q_offset, dtype):
    g = torch.Generator(device=cuda).manual_seed(sq * 7 + hd)
    q = torch.randn((b, h, sq, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, kh, sk, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, kh, sk, hd), generator=g, device=cuda).to(dtype)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap, q_offset=q_offset)
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= ATT_TOL[dtype]


def _flash_case(dev, dtype, b, h, kh, sq, sk, hd, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((b, h, sq, hd), (b, kh, sk, hd),
                               (b, kh, sk, hd)))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 63, 64, 65, 300])
@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_flash_bf16_tile_edges(cuda, hd, n):
    """The tensor-core kernel at lengths around its 16-row warp tile, its
    64-row CTA tile and its 64-key (32 at hd 256) K/V tile; GQA 8:1."""
    q, k, v = _flash_case(cuda, torch.bfloat16, 1, 8, 1, n, n, hd, n + hd)
    got = FA.flash_attention(q, k, v, scale=hd ** -0.5)
    want = FA.flash_attention_ref(q, k, v, scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
@pytest.mark.parametrize(
    "b,h,kh,sq,sk,causal,window,softcap,q_offset",
    [
        (1, 4, 2, 130, 130, True, 70, 0.0, 0),    # window across K/V tiles
        (2, 4, 4, 65, 65, True, 0, 30.0, 0),      # softcap
        (2, 4, 2, 17, 81, True, 0, 0.0, 64),      # q_offset, sk > sq
        (1, 4, 4, 63, 65, False, 0, 0.0, 0),      # not causal, sq != sk
        (1, 8, 1, 100, 164, True, 40, 20.0, 64),  # all of them, GQA 8:1
    ])
def test_flash_bf16_options(cuda, hd, b, h, kh, sq, sk, causal, window,
                            softcap, q_offset):
    q, k, v = _flash_case(cuda, torch.bfloat16, b, h, kh, sq, sk, hd,
                          sq + hd)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap, q_offset=q_offset)
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


# query rows that see no key (q_offset + row >= sk + window - 1): the
# plain version gives the mean of V over the sk keys there
BLIND_ROW_CASES = [
    (1, 4, 2, 16, 16, True, 8, 0.0, 40),      # every row blind
    (1, 4, 2, 16, 16, True, 8, 0.0, 20),
    (1, 4, 2, 16, 16, True, 4, 0.0, 8),       # blind from row 11 on
    (2, 8, 2, 100, 16, True, 4, 0.0, 8),      # tiles of both kinds
    (1, 4, 4, 30, 20, False, 6, 10.0, 5),     # not causal, softcap
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
@pytest.mark.parametrize("b,h,kh,sq,sk,causal,window,softcap,q_offset",
                         BLIND_ROW_CASES)
def test_flash_rows_that_see_no_key(cuda, dtype, hd, b, h, kh, sq, sk,
                                    causal, window, softcap, q_offset):
    q, k, v = _flash_case(cuda, dtype, b, h, kh, sq, sk, hd, q_offset + hd)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap, q_offset=q_offset)
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= ATT_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,s,hd", [(1, 32, 32, 300, 80),
                                         (2, 32, 4, 24, 128),
                                         (1, 8, 2, 37, 8)])
def test_flash_reads_transposed_views_without_a_copy(cuda, dtype, b, h, kh,
                                                     s, hd):
    """The [b, s, h, hd]-transposed views attention_prefill passes: the
    same output as the contiguous call, written in q's layout, and the
    caching allocator hands out the output's bytes and nothing else."""
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn((b, s, n, hd), generator=g,
                           device=cuda).to(dtype).transpose(1, 2)
               for n in (h, kh, kh))
    kw = dict(scale=hd ** -0.5)
    want = FA.flash_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), **kw)
    FA.flash_attention(q, k, v, **kw)  # built and warm
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(cuda)["allocated_bytes.all.allocated"]
    got = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    grown = (torch.cuda.memory_stats(cuda)["allocated_bytes.all.allocated"]
             - before)
    assert grown == -(-got.numel() * got.element_size() // 512) * 512
    assert got.stride() == q.stride() and got.transpose(1, 2).is_contiguous()
    assert torch.equal(got, want)
    ref = FA.flash_attention_ref(q, k, v, **kw)
    assert float((got.float() - ref.float()).abs().max()) <= ATT_TOL[dtype]


def test_flash_dtype_picks_the_kernel(cuda):
    """bf16 runs on the tensor-core kernel, fp32 on the SIMT kernel
    (within 1e-5 of the plain version)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cases = {dtype: _flash_case(cuda, dtype, 1, 8, 2, 70, 70, 64, 3)
             for dtype in (torch.float32, torch.bfloat16)}
    for dtype, (q, k, v) in cases.items():
        got = FA.flash_attention(q, k, v, scale=0.125)
        want = FA.flash_attention_ref(q, k, v, scale=0.125)
        assert float((got.float() - want.float()).abs().max()) \
            <= ATT_TOL[dtype]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            for q, k, v in cases.values():
                FA.flash_attention(q, k, v, scale=0.125)
        torch.cuda.synchronize()
    events = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    kinds = [re.search(r"flash_kernel\w*", n) for n in events]
    assert all(kinds), events
    assert {m.group(0) for m in kinds} == {"flash_kernel",
                                           "flash_kernel_tc"}, events
    q, k, v = cases[torch.float32]
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), k.half(), v.half(), scale=0.125)


# pages longer than a split (64 positions): paged_wide_kernel cuts each
# into 64-position parts (the serving mesh's block 256, which its
# mesh-free steps and head-sharded coordinates run): yi-6b's mesh-free
# step and a head-sharded coordinate, layout (c)'s 8,184-token slot,
# zamba2's mesh-free step and a coordinate of its (2, 2) mesh, lengths
# either side of a part's and a page's edge, gemma2's hd 256 with softcap
# 50 and a window across parts, block 128 (two parts a page), and
# missing pages
WIDE_CASES = [
    (4, 32, 4, 128, 256, 16, 0, 0.0, [24, 310, 1030, 4088], ()),
    (2, 16, 2, 128, 256, 16, 0, 0.0, [24, 4088], ()),
    (1, 32, 4, 128, 256, 32, 0, 0.0, [8184], ()),
    (2, 32, 32, 80, 256, 16, 0, 0.0, [310, 1030], ()),
    (1, 16, 16, 80, 256, 16, 0, 0.0, [1030], ()),
    (4, 32, 4, 128, 256, 4, 0, 0.0, [64, 256, 257, 63], ()),
    (4, 8, 4, 256, 256, 8, 101, 50.0, [300, 1500, 24, 0], ()),
    (3, 8, 2, 64, 128, 6, 0, 0.0, [700, 128, 1], ()),
    (2, 8, 2, 64, 256, 4, 0, 0.0, [900, 600], ((0, 1), (1, 0))),
]


def _form(block: int) -> str:
    """The launch counter of an unstriped call without the lse."""
    return "paged_attention_wide" if block > 64 else "paged_attention"


def _launched(before: dict) -> dict:
    from repro_torch.kernels import _build
    return {k: v - before[k] for k, v in _build.launches.items()
            if v != before[k]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,kh,hd,block,nblk,window,softcap,lengths,holes",
    [
        (2, 4, 4, 64, 16, 4, 0, 0.0, None, ()),
        (3, 8, 2, 64, 16, 6, 0, 0.0, None, ()),       # GQA g=4
        (2, 4, 4, 128, 32, 3, 0, 50.0, None, ()),     # softcap
        (2, 4, 2, 64, 16, 8, 40, 0.0, None, ()),      # window
        (4, 32, 4, 128, 16, 16, 0, 0.0, None, ()),    # the serve path's decode
        (2, 8, 2, 256, 8, 5, 9, 30.0, None, ()),      # hd 256, window + softcap
        (3, 8, 4, 8, 8, 6, 0, 0.0, None, ()),         # head dim 8 (SMOKE)
        (4, 32, 32, 80, 16, 20, 0, 0.0, None, ()),    # zamba2's shared block
        # the split kernel's edges (a split is 64 positions: 4 pages of 16,
        # 8 of 8, 2 of 32): lengths on a split edge and either side of it
        (4, 32, 4, 128, 16, 16, 0, 0.0, [64, 128, 65, 63], ()),
        (4, 32, 32, 80, 32, 8, 0, 0.0, [64, 192, 129, 1], ()),
        # a 1,024-token sequence beside an empty and a 1-token slot
        (3, 32, 32, 80, 16, 64, 0, 0.0, [1024, 0, 1], ()),
        (3, 32, 4, 128, 16, 64, 0, 0.0, [1, 1024, 0], ()),
        # a window that drops whole early splits
        (2, 8, 2, 64, 16, 20, 40, 0.0, [300, 200], ()),
        (2, 8, 8, 80, 8, 40, 33, 20.0, [310, 64], ()),
        # a missing page in the middle of a split, and a split all missing
        (2, 8, 2, 64, 8, 12, 0, 0.0, [90, 70], ((0, 9), (1, 2))),
        (2, 8, 8, 80, 16, 16, 0, 0.0, [250, 100],
         ((0, 4), (0, 5), (0, 6), (0, 7), (1, 2))),
    ] + WIDE_CASES)
def test_paged_attention_matches_plain(cuda, b, h, kh, hd, block, nblk,
                                       window, softcap, lengths, holes,
                                       dtype):
    """Against the plain version; a second call bit-equal (the split
    counters wrap); each call one launch of its form's counter."""
    from repro_torch.kernels import _build
    rng = np.random.default_rng(b * 100 + nblk)
    cap = b * nblk + 4
    pages = np.full((b, nblk), -1, np.int32)
    lens = np.zeros((b,), np.int32)
    perm = rng.permutation(cap)
    pi = 0
    for i in range(b):
        if lengths is None:
            n = int(rng.integers(1, nblk + 1))
            lens[i] = (n - 1) * block + int(rng.integers(1, block + 1))
        else:
            lens[i] = lengths[i]
            n = -(-lengths[i] // block)
        pages[i, :n] = perm[pi:pi + n]
        pi += n
    if lengths is None and b > 2:
        lens[-1] = 0   # an empty slot gives 0
    for i, j in holes:
        pages[i, j] = -1
    g = torch.Generator(device=cuda).manual_seed(hd + nblk)
    q = torch.randn((b, h, hd), generator=g, device=cuda).to(dtype)
    arena = torch.randn((cap, 2, block, kh, hd), generator=g,
                        device=cuda).to(dtype)
    pt = torch.from_numpy(pages).to(cuda)
    ln = torch.from_numpy(lens).to(cuda)
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    before = dict(_build.launches)
    got = PA.paged_attention(q, arena, pt, ln, **kw)
    assert _launched(before) == {_form(block): 1}
    want = PA.paged_attention_ref(q, arena, pt, ln, **kw)
    again = PA.paged_attention(q, arena, pt, ln, **kw)  # counters wrapped
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= ATT_TOL[dtype]
    assert torch.equal(got, again)
    if lengths is not None:   # a slot with nothing visible gives 0
        assert not got[torch.from_numpy(lens == 0).to(cuda)].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("self_term", [True, False])
@pytest.mark.parametrize(
    "b,h,kh,hd,block,nblk,window,softcap,lengths",
    [
        (4, 32, 4, 128, 16, 16, 0, 0.0, [24, 31, 0, 40]),     # yi-6b decode
        (4, 32, 32, 80, 16, 32, 0, 0.0, [24, 31, 0, 310]),    # zamba2's
        (3, 8, 4, 8, 8, 6, 0, 0.0, [5, 17, 48]),              # hd 8: 8 bytes
        (4, 32, 4, 128, 16, 16, 0, 0.0, [64, 128, 65, 63]),   # split edges
        (3, 32, 32, 80, 16, 64, 0, 0.0, [1024, 0, 1]),        # many splits
        (2, 8, 8, 80, 8, 40, 33, 20.0, [310, 64]),            # window+softcap
        (2, 4, 4, 128, 32, 3, 0, 50.0, [70, 9]),              # softcap
        (2, 8, 2, 256, 8, 5, 9, 30.0, [33, 40]),              # hd 256
    ] + [c[:-1] for c in WIDE_CASES if not c[-1]])
def test_paged_attention_int8_matches_plain(cuda, b, h, kh, hd, block, nblk,
                                            window, softcap, lengths,
                                            self_term, dtype):
    """The int8 read path (an int8 arena quantized per token as the serve
    engine writes it, its fp32 scales, q in fp32 or bf16) against the
    plain version with scales, with and without the unquantized self term;
    with it, a slot at -1 attends nothing (0) and a slot at 0 only its
    own token."""
    from repro_torch.kernels import _build
    from repro_torch.serving.paged import quantize_kv
    rng = np.random.default_rng(b * 100 + nblk + hd)
    cap = b * nblk + 4
    pages = np.full((b, nblk), -1, np.int32)
    perm = rng.permutation(cap)
    pi = 0
    for i, n_tok in enumerate(lengths):
        n = -(-n_tok // block)
        pages[i, :n] = perm[pi:pi + n]
        pi += n
    lens = np.asarray(lengths, np.int32)
    if self_term and b >= 3:
        lens[-1], lens[-2] = -1, 0
    g = torch.Generator(device=cuda).manual_seed(hd + nblk)
    q = torch.randn((b, h, hd), generator=g, device=cuda).to(dtype)
    arena, scales = quantize_kv(torch.randn((cap, 2, block, kh, hd),
                                            generator=g, device=cuda))
    kv_self = (tuple(torch.randn((b, kh, hd), generator=g,
                                 device=cuda).to(dtype) for _ in range(2))
               if self_term else None)
    pt = torch.from_numpy(pages).to(cuda)
    ln = torch.from_numpy(lens).to(cuda)
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window,
              scales=scales, kv_self=kv_self)
    before = dict(_build.launches)
    got = PA.paged_attention(q, arena, pt, ln, **kw)
    assert _launched(before) == {_form(block): 1}
    want = PA.paged_attention_ref(q, arena, pt, ln, **kw)
    again = PA.paged_attention(q, arena, pt, ln, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= ATT_TOL[dtype]
    assert torch.equal(got, again)
    if self_term and b >= 3:
        assert not got[-1].any()
        np.testing.assert_allclose(
            got[-2].float().cpu().numpy(), kv_self[1][-2].repeat_interleave(
                h // kh, dim=0).float().cpu().numpy(), rtol=0,
            atol=ATT_TOL[dtype])


SCAN_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 1e-3)}


def _ssd_case(gen, dev, b, s, nh, dh, st, dtype, h0):
    def n(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = n(b, s, nh, dh).to(dtype)
    dt = torch.nn.functional.softplus(n(b, s, nh))
    dA = -torch.nn.functional.softplus(n(b, s, nh))
    return x, dt, dA, n(b, s, st), n(b, s, st), (n(b, nh, dh, st) if h0
                                                  else None)


def _rel_err(got, want):
    return float(((got.float() - want.float()).abs()
                  / (1 + want.float().abs())).max())


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,s,nh,dh,st",
    [(2, 64, 2, 16, 8), (1, 128, 4, 32, 16), (2, 96, 1, 8, 4),  # JAX tests
     (2, 23, 3, 16, 8), (1, 600, 4, 64, 64),    # ragged last tiles
     (1, 300, 80, 64, 64),                       # zamba2's prefill
     (1, 24, 80, 64, 64),                        # zamba2's short prefill
     # the chunk-parallel kernel's edges: one step, one chunk and one
     # step either side, three chunks with a ragged one; b = 3; st 16,
     # 128 and 256; dh past one 64-row block
     (1, 1, 80, 64, 64), (1, 63, 80, 64, 64), (1, 64, 80, 64, 64),
     (1, 65, 80, 64, 64), (1, 129, 80, 64, 64), (3, 129, 4, 64, 64),
     (2, 150, 4, 64, 16), (1, 150, 4, 64, 128), (1, 70, 2, 16, 256),
     (2, 130, 3, 80, 32)])
def test_mamba2_scan_matches_plain(cuda, b, s, nh, dh, st, dtype, h0):
    gen = torch.Generator(device=cuda).manual_seed(s + nh + dh)
    args = _ssd_case(gen, cuda, b, s, nh, dh, st, dtype, h0)
    y, h = MS.mamba2_scan(*args)
    y_r, h_r = MS.mamba2_scan_ref(*args)
    y2, h2 = MS.mamba2_scan(*args)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == y_r.shape and h.shape == h_r.shape
    y_tol, h_tol = SCAN_TOL[dtype]
    assert _rel_err(y, y_r) <= y_tol
    assert _rel_err(h, h_r) <= h_tol
    assert torch.equal(y, y2) and torch.equal(h, h2)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _serve_engines(cuda, arch, max_seq, lens, seed=0, quant=False,
                   **overrides):
    """A CPU engine and a card engine over the same fp32 SMOKE weights
    (``quant``: with the int8 arena; ``overrides``: config fields
    replaced), and seeded prompts of ``lens`` tokens. The card engine's
    round and block allocation run with sync debugging set to "error"."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as TF
    from repro_torch.serving.engine import ServeEngine
    cfg = dataclasses.replace(configs.get_smoke(arch), kv_quant_int8=quant,
                              **overrides)
    params = TF.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    engines = [ServeEngine(cfg, params, max_slots=4, max_seq=max_seq,
                           block=8, device="cpu"),
               ServeEngine(cfg, _to(params, cuda), max_slots=4,
                           max_seq=max_seq, block=8, device=cuda)]
    card = engines[1]
    for name in ("_step", "_insert_blocks"):
        fn = getattr(card, name)

        def guarded(*a, _fn=fn, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        guarded.__wrapped__ = fn
        setattr(card, name, guarded)
    return cfg, engines, prompts


def _release_engines(engines):
    """Drop the engines (the card engine's graph and its pool with them)
    and hand the cached blocks back."""
    db = engines[1].daemon
    engines.clear()
    _release(db)


def _rounds(engines, n):
    for _ in range(n):
        outs = [e.decode_round() for e in engines]
        assert outs[0] == outs[1]
        assert float((engines[0].logits - engines[1].logits.cpu())
                     .abs().max()) <= 1e-4


def _serve_stream(engines, prompts, n_rounds, extras=None):
    """Admissions, ``n_rounds`` rounds, then finish_request, an admission
    into the freed slot, evict_user, flush and re-admission, each equal on
    both engines (``extras``: each prompt's request extras). Returns the
    rounds run."""
    ex = extras or [None] * len(prompts)
    for e in engines:
        for i, p in enumerate(prompts):
            e.add_request(p, user_id=i % 2, extras=ex[i])
    _rounds(engines, n_rounds)
    assert len({e.finish_request(1) for e in engines}) == 1
    for e in engines:
        e.add_request(prompts[0], user_id=3, extras=ex[0])
    _rounds(engines, 2)
    assert len({e.evict_user(0) for e in engines}) == 1
    _rounds(engines, 1)
    assert len({e.flush() for e in engines}) == 1
    for e in engines:
        e.add_request(prompts[1], user_id=4, extras=ex[1])
    _rounds(engines, 1)
    assert engines[1].live_blocks() == engines[0].live_blocks()
    return n_rounds + 4


def test_serve_engine_on_card_matches_cpu(cuda):
    """yi-6b SMOKE (fp32) through the paged engine, its decode round one
    captured CUDA graph, on the card and on the CPU with the same weights:
    the same tokens, logits within 1e-4, over admissions, block
    boundaries, finish_request, evict_user, flush and re-admission, with
    no sync from the capture on; flash attention once per layer and
    prefill, paged attention once per layer and round (the capture's
    prime round included)."""
    from repro_torch.kernels import _build
    cfg, engines, prompts = _serve_engines(cuda, "yi-6b", 64, (9, 17, 8))
    _build.reset_launches()
    rounds = _serve_stream(engines, prompts, 9)
    assert _build.launches["flash_attention"] == 5 * cfg.n_layers
    assert _build.launches["paged_attention"] == (rounds + 1) * cfg.n_layers
    _release_engines(engines)


def test_zamba2_engine_on_card_matches_cpu(cuda):
    """zamba2 SMOKE (fp32) through the paged engine, its decode round one
    captured CUDA graph, on the card and on the CPU with the same weights:
    the same tokens, logits within 1e-4 (prefill's too) over the stream of
    the yi-6b test; the scan once per Mamba2 layer and prefill, flash
    attention once per shared-block application and prefill, paged
    attention once per application and round (the prime round
    included)."""
    from repro_torch.kernels import _build
    cfg, engines, prompts = _serve_engines(cuda, "zamba2-2.7b", 128,
                                           (9, 70, 8))
    _build.reset_launches()
    for e in engines:
        e.add_request(prompts[1], user_id=5)
    assert float((engines[0].prefill_logits
                  - engines[1].prefill_logits.cpu()).abs().max()) <= 1e-4
    for e in engines:
        e.finish_request(0)
    rounds = _serve_stream(engines, prompts, 9)
    napps = cfg.n_shared_applications()
    assert _build.launches["mamba2_scan"] == 6 * cfg.n_layers
    assert _build.launches["flash_attention"] == 6 * napps
    assert _build.launches["paged_attention"] == (rounds + 1) * napps
    _release_engines(engines)


# starcoder2's SMOKE head dim 4 is below the kernels' smallest (8): its
# card test takes 8, and the wrappers keep refusing 4
NEW_ARCH_CASES = [("gemma2-2b", {}), ("gemma3-27b", {}),
                  ("starcoder2-7b", {"head_dim": 8}),
                  ("falcon-mamba-7b", {})]


@pytest.mark.parametrize("arch,overrides", NEW_ARCH_CASES)
def test_new_arch_engine_on_card_matches_cpu(cuda, arch, overrides):
    """gemma2-2b, gemma3-27b (SMOKE window 8: the prompts cross it),
    starcoder2-7b (36 / 4 heads) and falcon-mamba-7b (Mamba1, no arena)
    SMOKE (fp32) through the paged engine, its decode round one captured
    CUDA graph, on the card and on the CPU with the same weights: the
    prefill's logits within 1e-4, then the yi-6b test's stream with the
    same tokens and logits within 1e-4, no sync from the capture on; flash
    attention once per attention layer and prefill, paged attention once
    per attention layer and round (the prime round included), and none of
    either on falcon-mamba."""
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as TF
    cfg, engines, prompts = _serve_engines(cuda, arch, 64, (9, 17, 12),
                                           **overrides)
    _build.reset_launches()
    for e in engines:
        e.add_request(prompts[1], user_id=5)
    assert float((engines[0].prefill_logits
                  - engines[1].prefill_logits.cpu()).abs().max()) <= 1e-4
    for e in engines:
        e.finish_request(0)
    rounds = _serve_stream(engines, prompts, 9)
    attn = TF.n_attn_layers(cfg)
    assert _build.launches["flash_attention"] == 6 * attn
    assert _build.launches["paged_attention"] == (rounds + 1) * attn
    assert _build.launches["mamba2_scan"] == 0
    if arch == "falcon-mamba-7b":
        assert "arena" not in engines[1].state
        assert engines[1].live_blocks() == 0
    _release_engines(engines)


def test_kernels_refuse_head_dim_4(cuda):
    """starcoder2's SMOKE head dim (4) is not one the paged kernel takes:
    its wrapper refuses it on the card rather than run a plain version
    (the serve paths run starcoder2 at its full width's 128). The flash
    wrappers take it through their zero-padded route (the kernels at head
    dim 8), and refuse a head dim that neither the kernels nor the
    padding take (12)."""
    q = torch.zeros((1, 36, 5, 4), device=cuda)
    k = torch.zeros((1, 4, 5, 4), device=cuda)
    assert FA.flash_attention(q, k, k, scale=0.5).shape == q.shape
    q12 = torch.zeros((1, 36, 5, 12), device=cuda)
    k12 = torch.zeros((1, 4, 5, 12), device=cuda)
    with pytest.raises(TypeError):
        FA.flash_attention(q12, k12, k12, scale=0.5)
    arena = torch.zeros((3, 2, 8, 4, 4), device=cuda)
    with pytest.raises(TypeError):
        PA.paged_attention(q[:, :, 0], arena,
                           torch.zeros((1, 2), dtype=torch.int32,
                                       device=cuda),
                           torch.ones(1, dtype=torch.int32, device=cuda),
                           scale=0.5)


# the new archs' attention shapes at full width: starcoder2's 36 / 4 heads
# (GQA group 9), gemma2's hd 256 with softcap 50 and a window that binds,
# gemma3's 1,024-token window with lengths past it (the island passes
# window + 1 to the paged kernel)
NEW_FLASH_SHAPES = [(1, 36, 4, 300, 128, 0, 0.0),
                    (1, 8, 4, 300, 256, 100, 50.0),
                    (1, 32, 16, 1200, 128, 1024, 0.0)]
NEW_PAGED_SHAPES = [(36, 4, 128, 16, 0, 0.0, [24, 31, 17, 40]),
                    (8, 4, 256, 20, 101, 50.0, [300, 31, 100, 102]),
                    (32, 16, 128, 76, 1025, 0.0, [1200, 1025, 17, 1030])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,s,hd,window,softcap", NEW_FLASH_SHAPES)
def test_flash_at_new_arch_shapes(cuda, b, h, kh, s, hd, window, softcap,
                                  dtype):
    q, k, v = _flash_case(cuda, dtype, b, h, kh, s, s, hd, s + hd)
    # the [b, s, h, hd]-transposed views attention_prefill passes
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in (q, k, v))
    kw = dict(scale=hd ** -0.5, window=window, softcap=softcap)
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= ATT_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,hd,nblk,window,softcap,lengths",
                         NEW_PAGED_SHAPES)
def test_paged_at_new_arch_shapes(cuda, h, kh, hd, nblk, window, softcap,
                                  lengths, dtype):
    b, block = len(lengths), 16
    rng = np.random.default_rng(h + hd)
    cap = b * nblk + 3
    pages = np.full((b, nblk), -1, np.int32)
    perm = rng.permutation(cap)
    pi = 0
    for i, n_tok in enumerate(lengths):
        n = -(-n_tok // block)
        pages[i, :n] = perm[pi:pi + n]
        pi += n
    g = torch.Generator(device=cuda).manual_seed(hd + nblk)
    q = torch.randn((b, h, hd), generator=g, device=cuda).to(dtype)
    arena = torch.randn((cap, 2, block, kh, hd), generator=g,
                        device=cuda).to(dtype)
    pt = torch.from_numpy(pages).to(cuda)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    got = PA.paged_attention(q, arena, pt, ln, **kw)
    want = PA.paged_attention_ref(q, arena, pt, ln, **kw)
    again = PA.paged_attention(q, arena, pt, ln, **kw)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= ATT_TOL[dtype]
    assert torch.equal(got, again)


@pytest.mark.parametrize("arch,max_seq,lens", [("yi-6b", 64, (9, 17, 8)),
                                               ("zamba2-2.7b", 128,
                                                (9, 70, 8))])
def test_serve_graph_warm_round(cuda, monkeypatch, arch, max_seq, lens):
    """The round is captured while the kv table's CREATE-time warm-up
    still captures its statements on the same device, and its replays
    equal the CPU engine. A warm round with no block boundary is one
    cudaGraphLaunch,
    one host-to-device and one device-to-host copy, and no kernel launch;
    N replays launch paged attention exactly N times a layer; a round's
    logits stay as they were after the next round."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import _build
    monkeypatch.setenv("REPRO_WARMUP", "1")
    cfg, engines, prompts = _serve_engines(cuda, arch, max_seq, lens)
    graph, db = engines[1]._step.__wrapped__, engines[1].daemon
    assert db._warm_threads["kv"].is_alive()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.capture()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    db.drain_warmup()
    for e in engines:
        for i, p in enumerate(prompts):
            e.add_request(p, user_id=i)
    _rounds(engines, 1)
    # the host's calls inside the round must be exact in every profiled
    # round; the card's record of a window's first activity is sometimes
    # lost, so a small kernel opens the window, and a round whose copies
    # did not both show is profiled again
    for _ in range(3):
        while any(n % 8 == 0 for n in engines[1].lengths[:len(prompts)]):
            _rounds(engines, 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device=cuda)
            torch.cuda.synchronize()
            with record_function("decode_round"):
                engines[1].decode_round()
            torch.cuda.synchronize()
        engines[0].decode_round()
        span = next(e for e in prof.events()
                    if e.name == "decode_round"
                    and e.device_type != DeviceType.CUDA).time_range
        host = [e.name for e in prof.events()
                if e.device_type != DeviceType.CUDA
                and span.start <= e.time_range.start <= span.end]
        copies = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "Memcpy" in e.name]
        assert host.count("cudaGraphLaunch") == 1
        assert host.count("cudaMemcpyAsync") == 2
        assert not [x for x in host if x in ("cudaLaunchKernel",
                                             "cuLaunchKernel",
                                             "cudaLaunchKernelExC")]
        if (sum("HtoD" in c for c in copies) == 1
                and sum("DtoH" in c for c in copies) == 1):
            break
    else:
        raise AssertionError(f"no profiled round showed one HtoD and one "
                             f"DtoH copy: {copies}")
    kept = engines[1].logits
    before = kept.clone()
    _build.reset_launches()
    _rounds(engines, 5)
    assert torch.equal(kept, before)
    attn = cfg.n_layers if arch == "yi-6b" else cfg.n_shared_applications()
    assert _build.launches["paged_attention"] == 5 * attn
    _release_engines(engines)


def test_kvpool_delete_and_find_prefix_on_card(cuda):
    """Part of core/kvpool.py on the card (the DELETEs and the lookup
    reach the relscan kernels through the executors) against the CPU:
    equal counts, rows, page tables, lengths, gathered blocks and states."""
    from repro_torch import convert as CV
    from repro_torch.core import kvpool as KV
    from repro_torch.kernels import _build
    rng = np.random.default_rng(4)
    n = 96
    cell = rng.permutation(n)   # one row a (slot, pos_block): 8 x 12
    cols = {"slot": cell // 12, "seq_id": rng.integers(0, 12, n),
            "user_id": rng.integers(0, 5, n), "pos_block": cell % 12,
            "prefix_hash": rng.integers(0, 20, n)}
    cols = {k: v.astype(np.int32) for k, v in cols.items()}
    kv = rng.standard_normal((n, 2, 2, 4, 2, 8)).astype(np.float32)
    out = []
    _build.reset_launches()
    for dev in ("cpu", cuda):
        sch = KV.kv_schema(layers=2, block_size=4, kv_heads=2, head_dim=8,
                           capacity=128, dtype=torch.float32)
        st = KV.init_pool(sch, dev)
        st, rows, ev = KV.append_blocks(
            sch, st, **{k: torch.from_numpy(v).to(dev)
                        for k, v in cols.items()},
            kv=torch.from_numpy(kv).to(dev))
        obs = [rows, ev]
        for seq in (3, 7, 11):
            st, cnt = KV.delete_seq(sch, st, seq)
            obs.append(cnt)
        st, cnt = KV.delete_user(sch, st, 2)
        obs.append(cnt)
        for h in (0, 5, 19):
            st, res = KV.find_prefix(sch, st, h, limit=16)
            obs += [res["count"], res["row_ids"], res["present"],
                    res["rows"]["pos_block"], res["rows"]["seq_id"]]
        pt = KV.page_table(sch, st, max_slots=8, max_blocks=16)
        obs += [pt, KV.seq_lengths(sch, st, max_slots=8, block_size=4),
                KV.gather_blocks(st, pt)]
        out.append(([o.cpu().numpy() for o in obs], CV.state_to_numpy(st)))
    for want, got in zip(*(o[0] for o in out)):
        np.testing.assert_array_equal(want, got)
    np.testing.assert_equal(out[0][1], out[1][1])
    assert _build.launches["relscan_scan"] > 0


def test_int8_engine_on_card_matches_cpu(cuda):
    """yi-6b SMOKE (fp32) with the int8 arena, its decode round one
    captured CUDA graph on the card: the same tokens as the CPU engine
    over 9 rounds, logits within 1e-2 (the two devices' fp32 K/V differ
    by a few ulp, so a value on a rounding boundary quantizes one step
    apart), int8 arenas equal but for such steps and scales within 1e-5;
    no sync from the capture on; the paged kernel once per layer and
    round (the prime round included)."""
    from repro_torch.kernels import _build
    cfg, engines, prompts = _serve_engines(cuda, "yi-6b", 64, (9, 17, 8),
                                           quant=True)
    cpu, card = engines
    assert card.state["arena"].dtype == torch.int8
    _build.reset_launches()
    for e in engines:
        for i, p in enumerate(prompts):
            e.add_request(p, user_id=i)
    for _ in range(9):
        assert cpu.decode_round() == card.decode_round()
        assert float((cpu.logits - card.logits.cpu()).abs().max()) <= 1e-2
    assert _build.launches["paged_attention"] == 10 * cfg.n_layers
    got = card.state["arena"].cpu().to(torch.int32)
    want = cpu.state["arena"].to(torch.int32)
    assert int((got - want).abs().max()) <= 1
    assert int((got != want).sum()) <= got.numel() // 1000
    np.testing.assert_allclose(card.state["arena_scale"].cpu().numpy(),
                               cpu.state["arena_scale"].numpy(), rtol=1e-5,
                               atol=0)
    _release_engines(engines)


def test_mesh_fanout_on_card_equals_cpu(cuda):
    """A SHARDS 8 table placed over a lane mesh of 4 entries (cuda:0
    repeated on one card, distinct cards where there are four) against an
    unplaced CPU daemon: pruned and fan-out statements, batched ones,
    RESHARD 2 and 1, equal results and states and no sync; a warm fan-out
    is one graph launch a block plus the merge's, no kernel launch, and
    2 d + 1 copies (each block's bound values in and its packed outputs
    into the merge's input, the merge's outputs out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import SQLCached
    from repro_torch.launch import mesh as M
    with M.force_device_count(4):
        dbs = (SQLCached(warmup=False),
               SQLCached(device="cpu", warmup=False, mesh_exec=False))
        ddl = ("CREATE TABLE m (k INT, p INT, v INT, INDEX(p)) CAPACITY 4096 "
               "MAX_SELECT 64 SHARDS 8 PARTITION BY k")
        for db in dbs:
            db.execute(ddl)
        assert len(dbs[0].tables["m"].mesh) == 4
        rng = np.random.default_rng(3)
        rows = [(int(rng.integers(0, 300)), int(rng.integers(0, 100)), i)
                for i in range(3000)]
        _both(dbs, "executemany", "INSERT INTO m (k, p, v) VALUES (?, ?, ?)",
              rows)
        for i in range(6):
            _both(dbs, "execute", "SELECT * FROM m WHERE k = ?", (i,))
            _both(dbs, "execute", "SELECT * FROM m WHERE p = ? LIMIT 20",
                  (i,))
            _both(dbs, "execute",
                  "SELECT k, v FROM m WHERE v > ? ORDER BY v DESC LIMIT 9",
                  (i * 100,))
            _both(dbs, "execute", "SELECT AVG(v) FROM m WHERE p = ?", (i,))
            _both(dbs, "execute", "UPDATE m SET v = v + 1 WHERE p = ?", (i,))
            _both(dbs, "execute", "DELETE FROM m WHERE p = ?", (50 + i,))
        _both(dbs, "executemany", "SELECT * FROM m WHERE p = ? LIMIT 8",
              [(x,) for x in range(10, 26)])
        _same_state(dbs, "m")
        sql, args = "SELECT COUNT(*) FROM m WHERE p = ?", (7,)
        _both(dbs, "execute", sql, args)    # planned (captured)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                dbs[0].execute(sql, args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type != DeviceType.CUDA]
        assert names.count("cudaGraphLaunch") == 5 * (4 + 1)
        assert names.count("cudaMemcpyAsync") == 5 * (2 * 4 + 1)
        assert not any(n in names for n in ("cudaLaunchKernel",
                                            "cudaLaunchKernelExC",
                                            "cuLaunchKernel"))
        for _ in range(5):
            dbs[1].execute(sql, args)
        for n in (2, 1):   # an admin statement reads its count back
            assert len({db.execute(f"ALTER TABLE m RESHARD {n}").count
                        for db in dbs}) == 1
            _both(dbs, "execute", "SELECT * FROM m WHERE p = ? LIMIT 20",
                  (3,))
            _same_state(dbs, "m")
    _release(*dbs)


# ------------------------------------------------- MoE, frontend, enc-dec
def _extras(cfg, n, seed):
    """Each request's extras as the reference's serving test draws them:
    a vision frontend's embeddings or an encoder-decoder's frames,
    [frontend_len, d] × 0.02; None for a text-only arch."""
    if cfg.frontend != "vision" and not cfg.is_encdec:
        return [None] * n
    key = "enc_frames" if cfg.is_encdec else "frontend"
    rng = np.random.default_rng(seed)
    return [{key: (rng.standard_normal((cfg.frontend_len, cfg.d_model))
                   * 0.02).astype(np.float32)} for _ in range(n)]


@pytest.mark.parametrize("arch,ragged", [
    ("granite-moe-1b-a400m", False), ("granite-moe-1b-a400m", True),
    ("phi3.5-moe-42b-a6.6b", False), ("internvl2-1b", False),
    ("seamless-m4t-large-v2", False)])
def test_moe_frontend_encdec_engine_on_card_matches_cpu(cuda, monkeypatch,
                                                        arch, ragged):
    """granite-moe and phi3.5-moe (the dense dispatch, and granite's
    ragged one with ``REPRO_MOE_RAGGED=1``: sort, cumsum and index_copy_
    inside the captured round), internvl2 (a frontend before every
    prompt) and seamless (encoder frames on every request, their cross
    K/V copied into the static state) SMOKE (fp32) through the paged
    engine, its decode round one captured CUDA graph, on the card and on
    the CPU with the same weights: the prefill's logits within 1e-4, then
    the yi-6b test's stream with the same tokens and logits within 1e-4,
    no sync from the capture on; flash attention once per decoder layer
    and prefill (seamless: and once per encoder layer and cross
    attention), paged attention once per decoder layer and round (the
    prime round included)."""
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as TF
    if ragged:
        monkeypatch.setenv("REPRO_MOE_RAGGED", "1")
    cfg, engines, prompts = _serve_engines(cuda, arch, 64, (9, 17, 12))
    extras = _extras(cfg, len(prompts), 11)
    _build.reset_launches()
    for e in engines:
        e.add_request(prompts[1], user_id=5, extras=extras[1])
    assert float((engines[0].prefill_logits
                  - engines[1].prefill_logits.cpu()).abs().max()) <= 1e-4
    for e in engines:
        e.finish_request(0)
    rounds = _serve_stream(engines, prompts, 9, extras)
    attn = TF.n_attn_layers(cfg)
    flash = attn + (cfg.enc_layers + cfg.n_layers if cfg.is_encdec else 0)
    assert _build.launches["flash_attention"] == 6 * flash
    assert _build.launches["paged_attention"] == (rounds + 1) * attn
    if cfg.is_encdec:
        st = [e.state["enc_k"] for e in engines]
        assert float((st[0] - st[1].cpu()).abs().max()) <= 1e-4
    _release_engines(engines)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_router_ties_choose_the_lower_index_on_card(cuda, dtype):
    """``torch.topk`` promises no order among ties on CUDA; the port's
    ``moe.top_k`` (a stable descending sort) must keep equal values in
    index order there, as ``jax.lax.top_k`` does: equal to the CPU's
    choice on rows full of ties, and, at granite's router width (d 1,024,
    32 experts, top 8) with columns repeated in groups of three (exact
    ties in every group), every token's chosen members of a group are
    that group's lowest indices."""
    from repro_torch.models.layers import moe as MOE
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.integers(0, 4, (4096, 32)).astype(
        np.float32)).to(dtype)
    for k in (1, 2, 8, 32):
        got = MOE.top_k(vals.to(cuda), k)
        want = MOE.top_k(vals, k)
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(got[0].cpu(), want[0])

    class Cfg:
        n_experts, top_k = 32, 8
    g = torch.Generator(device=cuda).manual_seed(1)
    router = torch.randn((1024, 11), generator=g, device=cuda)
    router = router.repeat_interleave(3, dim=1)[:, :32].to(dtype) / 32
    x = torch.randn((1, 4096, 1024), generator=g, device=cuda).to(dtype)
    w, _ = MOE.router_probs({"router": router}, Cfg, x)
    chosen = (w[0] > 0).cpu().numpy()
    assert (chosen.sum(axis=-1) == 8).all()
    for lo in range(0, 32, 3):
        grp = chosen[:, lo:lo + 3]
        m = grp.sum(axis=-1)
        want = np.arange(grp.shape[1])[None, :] < m[:, None]
        np.testing.assert_array_equal(grp, want)


def test_ragged_equals_dense_dispatch_at_granite_width(cuda):
    """One MoE layer at granite-moe-1b's published widths (d 1,024, 32
    experts of d_ff 512, top 8, bf16) over a prefill of 8 tokens (each
    expert's capacity is then every token: nothing dropped): the ragged
    dispatch equals the dense one within bf16's 2e-2 (summation order and
    one rounding of each weighted expert output), and its aux loss is the
    dense one's over top_k (the reference's two formulas differ so)."""
    from repro_torch import configs
    from repro_torch.models.layers import moe as MOE
    cfg = configs.get_config("granite-moe-1b-a400m")
    g = torch.Generator(device=cuda).manual_seed(2)
    p = MOE.init_moe(g, cfg, cuda)
    x = torch.randn((1, 8, cfg.d_model), generator=g, device=cuda).to(
        cfg.dtype)
    dense, aux_d = MOE.moe_forward(p, cfg, x)
    ragged, aux_r = MOE.moe_forward(p, cfg, x, ragged=True)
    torch.cuda.synchronize()
    assert dense.dtype == ragged.dtype == torch.bfloat16
    assert float((dense.float() - ragged.float()).abs().max()) <= 2e-2
    assert abs(float(aux_d) - cfg.top_k * float(aux_r)) <= 1e-5


# the MoE, vision and encoder-decoder archs' attention shapes at full
# width: seamless's encoder
# (non-causal, 1,024 frames) and cross attention (8 / 24 queries over
# them), internvl2's prefill (GQA group 7 over 256 + 24 positions),
# granite's (hd 64, group 2)
MOE_ENCDEC_FLASH_SHAPES = [(1, 16, 16, 1024, 1024, 64, False),
                     (1, 16, 16, 24, 1024, 64, False),
                     (1, 16, 16, 8, 1024, 64, False),
                     (1, 14, 2, 280, 280, 64, True),
                     (1, 16, 8, 23, 23, 64, True)]
# (h, kh, hd, nblk, lengths): internvl2 (group 7, max_seq 512), seamless
# (group 1), granite (group 2), phi3.5 (group 4, hd 128)
MOE_ENCDEC_PAGED_SHAPES = [(14, 2, 64, 32, [280, 287, 0, 296]),
                     (14, 2, 64, 32, [257, 320, 64, 512]),
                     (16, 16, 64, 16, [24, 31, 0, 40]),
                     (16, 8, 64, 16, [9, 17, 33, 256]),
                     (32, 8, 128, 16, [24, 31, 0, 40])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,sq,sk,hd,causal", MOE_ENCDEC_FLASH_SHAPES)
def test_flash_at_moe_encdec_shapes(cuda, b, h, kh, sq, sk, hd, causal,
                                    dtype):
    q, k, v = _flash_case(cuda, dtype, b, h, kh, sq, sk, hd, sq + sk + hd)
    # the [b, s, h, hd]-transposed views attention_forward passes
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in (q, k, v))
    kw = dict(scale=hd ** -0.5, causal=causal)
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= ATT_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,hd,nblk,lengths", MOE_ENCDEC_PAGED_SHAPES)
def test_paged_at_moe_encdec_shapes(cuda, h, kh, hd, nblk, lengths, dtype):
    b, block = len(lengths), 16
    rng = np.random.default_rng(h + hd + nblk)
    cap = b * nblk + 3
    pages = np.full((b, nblk), -1, np.int32)
    perm = rng.permutation(cap)
    pi = 0
    for i, n_tok in enumerate(lengths):
        n = -(-n_tok // block)
        pages[i, :n] = perm[pi:pi + n]
        pi += n
    g = torch.Generator(device=cuda).manual_seed(hd + nblk + h)
    q = torch.randn((b, h, hd), generator=g, device=cuda).to(dtype)
    arena = torch.randn((cap, 2, block, kh, hd), generator=g,
                        device=cuda).to(dtype)
    pt = torch.from_numpy(pages).to(cuda)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kw = dict(scale=hd ** -0.5)
    got = PA.paged_attention(q, arena, pt, ln, **kw)
    want = PA.paged_attention_ref(q, arena, pt, ln, **kw)
    again = PA.paged_attention(q, arena, pt, ln, **kw)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= ATT_TOL[dtype]
    assert torch.equal(got, again)


# ------------------------------------------------- training: the backward

BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (b, h, kh, sq, sk, hd, causal, window, softcap, q_offset): causal and
# not, q_offset, a window crossed, softcap 50, GQA groups 1, 2, 7 and 8,
# sq != sk, ragged tails, rows that see no key, every head dim
BWD_CASES = [
    (2, 4, 4, 128, 128, 64, True, 0, 0.0, 0),
    (1, 8, 4, 256, 256, 256, True, 96, 50.0, 0),
    (2, 4, 2, 128, 256, 32, False, 0, 0.0, 0),
    (1, 14, 2, 40, 40, 64, True, 0, 0.0, 0),
    (1, 8, 1, 70, 70, 128, True, 0, 0.0, 0),
    (1, 4, 2, 13, 40, 256, True, 7, 20.0, 27),
    (2, 8, 4, 13, 13, 8, True, 0, 0.0, 0),
    (1, 4, 2, 37, 37, 16, True, 5, 10.0, 0),
    (1, 32, 32, 300, 300, 80, True, 0, 0.0, 0),
    (1, 16, 16, 24, 1024, 64, False, 0, 0.0, 0),
    (1, 4, 2, 16, 16, 16, True, 4, 0.0, 8),
    (1, 4, 4, 30, 20, 8, False, 6, 10.0, 5),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,sq,sk,hd,causal,window,softcap,q_offset",
                         BWD_CASES)
def test_flash_backward_matches_plain(cuda, b, h, kh, sq, sk, hd, causal,
                                      window, softcap, q_offset, dtype):
    q, k, v = _flash_case(cuda, dtype, b, h, kh, sq, sk, hd, sq + hd)
    do = _flash_case(cuda, dtype, b, h, h, sq, sq, hd, hd)[0]
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap, q_offset=q_offset)
    o, lse = FA._forward(q, k, v, with_lse=True, **kw)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = FA.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    top = max(float(w.abs().max()) for w in want)
    for a, w in zip(got, want):
        assert a.dtype == dtype
        assert float((a.float() - w).abs().max()) <= BWD_TOL[dtype] * top
    # the delta kernel alone: D = rowsum(dO * O)
    d = FA.flash_attention_bwd_delta(o, do)
    d_ref = (do.float() * o.float()).sum(dim=-1)
    assert float((d - d_ref).abs().max()) <= (
        BWD_TOL[dtype] * float(d_ref.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_gives_qkv_gradients(cuda, dtype):
    """Autograd reaches the kernels: the gradients of a CUDA flash call
    (transposed views, as attention_prefill passes them) are the backward
    kernels', in each input's layout."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((1, 40, n, 64), generator=g, device=cuda)
               .to(dtype).transpose(1, 2).requires_grad_()
               for n in (8, 2, 2))
    kw = dict(scale=0.125, causal=True, window=16, softcap=30.0, q_offset=0)
    out = FA.flash_attention(q, k, v, **kw)
    assert out.grad_fn is not None
    do = torch.randn(out.shape, generator=g, device=cuda).to(dtype)
    out.backward(do)
    o, lse = FA._forward(q.detach(), k.detach(), v.detach(), with_lse=True,
                         **kw)
    want = FA.flash_attention_bwd(q.detach(), k.detach(), v.detach(), o, lse,
                                  do, **kw)
    for t, w in zip((q, k, v), want):
        assert t.grad is not None and torch.equal(t.grad, w)
        assert t.grad.stride() == t.stride()


MAMBA_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # of the
# largest entry of each gradient: fp32 sums in another order; bf16 dx is
# rounded once (the other gradients stay fp32 whatever x is)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,dh,st,h0", [
    (1, 1, 2, 16, 8, False), (2, 24, 3, 16, 8, True),
    (1, 64, 80, 64, 64, False), (1, 65, 4, 64, 64, True),
    (2, 300, 5, 16, 256, True), (1, 300, 80, 64, 64, False)])
def test_mamba2_backward_matches_plain(cuda, b, s, nh, dh, st, h0, dtype):
    """The three backward launches against mamba2_scan_bwd_ref on the
    same inputs (a random dh_last where h0 is random), each gradient
    within its tolerance of its largest entry; a second call bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(s + nh + st)
    args = _ssd_case(gen, cuda, b, s, nh, dh, st, dtype, h0)
    dy = torch.randn((b, s, nh, dh), generator=gen, device=cuda).to(dtype)
    dhl = (torch.randn((b, nh, dh, st), generator=gen, device=cuda) if h0
           else None)
    got = MS.mamba2_scan_bwd(*args, dy, dhl)
    again = MS.mamba2_scan_bwd(*args, dy, dhl)
    want = MS.mamba2_scan_bwd_ref(*args, dy, dhl)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert got[0].dtype == dtype
    for i, (a, w) in enumerate(zip(got, want)):
        tol = MAMBA_BWD_TOL[dtype] if i == 0 else MAMBA_BWD_TOL[torch.float32]
        top = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= tol * max(
            top, 1e-30), i


def test_cuda_mamba2_scan_gives_gradients(cuda):
    """Autograd reaches the backward kernel through Mamba2Scan: the
    gradients of every input (h0 included, h_last's gradient given) are
    the wrapper's; without a gradient a call launches the forward alone."""
    from repro_torch.kernels import _build
    g = torch.Generator(device=cuda).manual_seed(2)
    x, dt, dA, B, C, h0 = _ssd_case(g, cuda, 1, 130, 4, 32, 16,
                                    torch.float32, True)
    ins = [t.clone().requires_grad_() for t in (x, dt, dA, B, C, h0)]
    _build.reset_launches()
    y, h_last = MS.mamba2_scan(*ins)
    dy = torch.randn(y.shape, generator=g, device=cuda)
    dhl = torch.randn(h_last.shape, generator=g, device=cuda)
    torch.autograd.backward((y, h_last), (dy, dhl))
    assert _build.launches["mamba2_scan"] == 1
    assert _build.launches["mamba2_scan_bwd"] == 1
    want = MS.mamba2_scan_bwd(x, dt, dA, B, C, h0, dy, dhl)
    for t, w in zip(ins, want):
        assert t.grad is not None and torch.equal(t.grad, w)
    _build.reset_launches()
    with torch.no_grad():
        MS.mamba2_scan(*ins)
    assert _build.launches["mamba2_scan"] == 1
    assert _build.launches["mamba2_scan_bwd"] == 0


def test_zamba2_train_step_on_card_matches_cpu(cuda):
    """zamba2 SMOKE (Mamba2 layers and the shared block, fp32, remat
    full) on the card through the scan and flash kernels against the
    same weights and batch on the CPU (plain versions under autograd):
    the loss within 1e-5, every gradient leaf within 1e-4 of its largest
    entry, and one AdamW step's parameters within 1e-4."""
    from repro_torch import configs
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as TF
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.training.loop import to_device
    from repro_torch.training.step import make_train_step
    cfg = configs.get_smoke("zamba2-2.7b")
    cpu = torch.device("cpu")
    params = TF.init_model(torch.Generator().manual_seed(0), cfg, cpu)
    host = make_batch(cfg, 2, 80, seed=4)

    def run(dev):
        p = _to(params, dev)
        batch = to_device(host, dev)
        leaves = tree_leaves(p)
        for x in leaves:
            x.requires_grad_(True)
        loss, _ = TF.train_loss(p, cfg, batch, remat="full")
        grads = torch.autograd.grad(loss, leaves)
        for x in leaves:
            x.requires_grad_(False)
        step = make_train_step(cfg, remat="full", peak_lr=1e-3, warmup=0,
                               total_steps=10)
        p, _, m = step(p, adamw_init(p), batch, 1)
        return float(loss), [g.cpu() for g in grads], float(m["loss"]), [
            x.cpu() for x in tree_leaves(p)]

    _build.reset_launches()
    loss_k, g_k, step_k, p_k = run(cuda)
    assert _build.launches["mamba2_scan_bwd"] > 0
    assert _build.launches["flash_attention_bwd_dq"] > 0
    loss_c, g_c, step_c, p_c = run(cpu)
    assert abs(loss_k - loss_c) <= 1e-5 and abs(step_k - step_c) <= 1e-5
    for a, c in zip(g_k, g_c):
        top = float(c.abs().max())
        assert float((a - c).abs().max()) <= 1e-4 * max(top, 1e-30)
    for a, c in zip(p_k, p_c):
        assert float((a - c).abs().max()) <= 1e-4


def test_lm_loss_takes_masked_out_of_range_labels_on_card(cuda):
    """Labels -1, -100 and padded_vocab under a zero mask: no device-side
    assert, and the CPU's loss."""
    from repro_torch import configs
    from repro_torch.models import transformer as TF
    cfg = configs.get_smoke("yi-6b")
    params = TF.init_model(torch.Generator().manual_seed(0), cfg,
                           torch.device("cpu"))
    g = torch.Generator().manual_seed(1)
    h = torch.randn((2, 16, cfg.d_model), generator=g)
    y = torch.randint(0, cfg.vocab, (2, 16), generator=g)
    m = torch.ones((2, 16))
    for (i, j), lab in zip([(0, 3), (0, 9), (1, 0), (1, 15)],
                           [-1, -100, cfg.padded_vocab, -1]):
        y[i, j], m[i, j] = lab, 0.0
    want = TF.lm_loss(params, cfg, h, y, m)
    got = TF.lm_loss(_to(params, cuda), cfg, h.to(cuda), y.to(cuda),
                     m.to(cuda))
    assert torch.isfinite(got)
    assert abs(float(got) - float(want)) <= 1e-5


def test_train_step_on_card_matches_plain_attention(cuda, monkeypatch):
    """SMOKE gemma2-2b (window, both softcaps, remat full, fp32) on the
    card through the flash kernels, against the same with the plain
    attention under autograd: the loss within 1e-5 and every gradient
    leaf within 1e-4 of its largest entry; then one AdamW step, the
    updated parameters within 1e-4."""
    from repro_torch import configs
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as TF
    from repro_torch.models.layers import attention as AT
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.training.loop import to_device
    from repro_torch.training.step import make_train_step
    cfg = configs.get_smoke("gemma2-2b")
    batch = to_device(make_batch(cfg, 2, 32, seed=4), cuda)

    def init():
        return TF.init_model(torch.Generator(device=cuda).manual_seed(0),
                             cfg, cuda)

    def grads():
        params = init()
        leaves = tree_leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        loss, _ = TF.train_loss(params, cfg, batch, remat="full")
        return float(loss), torch.autograd.grad(loss, leaves)

    def one_step():
        step = make_train_step(cfg, remat="full", peak_lr=1e-3, warmup=0,
                               total_steps=10)
        params = init()
        params, _, m = step(params, adamw_init(params), batch, 1)
        return float(m["loss"]), tree_leaves(params)

    _build.reset_launches()
    loss_k, g_k = grads()
    step_k, p_k = one_step()
    for name in ("flash_attention_lse", "flash_attention_bwd_delta",
                 "flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        assert _build.launches[name] > 0, name
    monkeypatch.setattr(AT, "flash_attention", FA.flash_attention_ref)
    loss_p, g_p = grads()
    step_p, p_p = one_step()
    assert abs(loss_k - loss_p) <= 1e-5 and abs(step_k - step_p) <= 1e-5
    assert len(g_k) == len(g_p)
    for a, c in zip(g_k, g_p):
        top = float(c.abs().max())
        assert float((a - c).abs().max()) <= 1e-4 * max(top, 1e-30)
    for a, c in zip(p_k, p_p):
        assert float((a - c).abs().max()) <= 1e-4


def test_host_copy_bounds_its_card_buffer(cuda, monkeypatch):
    """A tree larger than ``CHUNK_BYTES`` reaches the host whole, leaf for
    leaf, while the card holds at most ``CHUNK_BYTES`` more than the tree
    (a leaf larger than a chunk travels alone)."""
    from repro_torch.checkpoint import store as TCK
    g = torch.Generator(device=cuda).manual_seed(3)
    tree = {"a": [torch.randn((1 << 18,), generator=g, device=cuda)
                  for _ in range(6)],
            "big": torch.randn((1 << 21,), generator=g, device=cuda),
            "i": torch.arange(7, dtype=torch.int32, device=cuda),
            "h": torch.randn((1 << 18,), generator=g, device=cuda)
            .bfloat16()}
    chunk = 3 << 20   # three of the 1 MiB leaves; "big" is 8 MiB
    monkeypatch.setattr(TCK, "CHUNK_BYTES", chunk)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    # a pool of its own: a free block that earlier tests left in a live
    # segment could hand the chunk's buffer up to 1 MiB more than it asks
    # (the allocator splits off no remainder of 1 MiB or less)
    with torch.cuda.use_mem_pool(torch.cuda.MemPool()):
        host = TCK.host_copy(tree)
    assert torch.cuda.max_memory_allocated(cuda) - base <= chunk
    for a, c in zip(TCK._flatten(host).values(), TCK._flatten(tree).values()):
        assert a.device.type == "cpu" and a.dtype == c.dtype
        assert torch.equal(a, c.cpu())


# ------------------------------------------- the serving mesh on the card
def _striped(pages, block, S):
    """Stripe s of S: blocks s, s + S, ... of each sequence and their
    global starts."""
    b, nblk = pages.shape
    out = []
    for s in range(S):
        start = ((torch.arange(nblk // S, device=pages.device) * S + s)
                 * block).to(torch.int32)
        out.append((pages[:, s::S].contiguous(),
                    start.expand(b, -1).contiguous()))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize(
    "h,kh,hd,block,nblk,window,softcap,lengths",
    [
        (32, 4, 128, 256, 16, 0, 0.0, [24, 310, 1030, 4088]),  # yi-6b
        (32, 32, 80, 256, 16, 0, 0.0, [24, 310, 0, 1030]),     # zamba2
        (32, 16, 128, 16, 96, 1025, 50.0, [1216, 1025, 17, 5]),  # gemma3
        (14, 2, 64, 16, 32, 0, 0.0, [280, 287, 0, 296]),       # internvl2
        (8, 4, 256, 256, 8, 0, 50.0, [300, 24, 0, 1500]),      # gemma2
    ])
def test_paged_attention_striped_matches_plain(cuda, h, kh, hd, block, nblk,
                                               window, softcap, lengths, S,
                                               int8, dtype):
    """The serving mesh's call form: each stripe's pages at their global
    starts (``blk_start``) with the rows' log-sum-exp, against the plain
    version; rows that see nothing give 0 and lse -1e30; the stripes'
    combine equals the unstriped plain call; a second call bit-equal."""
    from repro_torch.serving.paged import quantize_kv
    b = len(lengths)
    rng = np.random.default_rng(hd + S)
    cap = b * nblk
    pages = torch.from_numpy(rng.permutation(cap).reshape(b, nblk)
                             .astype(np.int32)).to(cuda)
    for i, n in enumerate(lengths):   # pages past the length: missing
        pages[i, -(-n // block):] = -1
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn((b, h, hd), generator=g, device=cuda).to(dtype)
    arena = torch.randn((cap, 2, block, kh, hd), generator=g, device=cuda)
    scales = None
    if int8:
        arena, scales = quantize_kv(arena)
    else:
        arena = arena.to(dtype)
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window,
              scales=scales)
    whole = PA.paged_attention_ref(q, arena, pages, lens, **kw)
    parts = []
    for pg, bs in _striped(pages, block, S):
        got = PA.paged_attention(q, arena, pg, lens, blk_start=bs,
                                 return_lse=True, **kw)
        want = PA.paged_attention_ref(q, arena, pg, lens, blk_start=bs,
                                      return_lse=True, **kw)
        again = PA.paged_attention(q, arena, pg, lens, blk_start=bs,
                                   return_lse=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                            again[1])
        assert float((got[0].float() - want[0].float()).abs().max()) \
            <= ATT_TOL[dtype]
        none = want[1] <= -1e29
        assert torch.equal(got[1] <= -1e29, none)
        assert not got[0][none].any()
        if not bool(none.all()):
            rel = (got[1] - want[1]).abs() / want[1].abs().clamp(min=1.0)
            assert float(rel[~none].max()) <= 1e-4
        parts.append(got)
    o = torch.stack([p[0].float() for p in parts])
    lse = torch.stack([p[1] for p in parts])
    w = torch.exp(lse - lse.max(0).values)
    comb = (w[..., None] * o).sum(0) / w.sum(0)[..., None]
    assert float((comb - whole.float()).abs().max()) <= ATT_TOL[dtype]
    # the unstriped call (paged_split_kernel at block 16, paged_wide_kernel
    # at block 256) against the plain version, and untouched by the new
    # arguments
    from repro_torch.kernels import _build
    before = dict(_build.launches)
    plain = PA.paged_attention(q, arena, pages, lens, **kw)
    assert _launched(before) == {_form(block): 1}
    assert float((plain.float() - whole.float()).abs().max()) \
        <= ATT_TOL[dtype]
    assert torch.equal(plain, PA.paged_attention(q, arena, pages, lens,
                                                 blk_start=None, **kw))


@pytest.mark.parametrize("starts", [False, True])
def test_paged_attention_striped_self_term_lse(cuda, starts):
    """Over an int8 arena with the self term (the int8 island without
    stripes) the lse counts it: a slot at 0 sees only its own key (lse =
    its score), one at -1 nothing (-1e30); with and without block starts
    (j * block)."""
    from repro_torch.serving.paged import quantize_kv
    b, h, kh, hd, block, nblk = 3, 8, 2, 64, 16, 4
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((b, h, hd), generator=g, device=cuda)
    arena, scales = quantize_kv(torch.randn((b * nblk, 2, block, kh, hd),
                                            generator=g, device=cuda))
    pages = torch.arange(b * nblk, dtype=torch.int32,
                         device=cuda).reshape(b, nblk)
    lens = torch.tensor([37, 0, -1], dtype=torch.int32, device=cuda)
    ks = tuple(torch.randn((b, kh, hd), generator=g, device=cuda)
               for _ in range(2))
    kw = dict(scale=0.125, scales=scales, kv_self=ks, return_lse=True,
              blk_start=_striped(pages, block, 1)[0][1] if starts else None)
    got = PA.paged_attention(q, arena, pages, lens, **kw)
    want = PA.paged_attention_ref(q, arena, pages, lens, **kw)
    torch.cuda.synchronize()
    assert float((got[0] - want[0]).abs().max()) <= 1e-5
    assert float((got[1] - want[1]).abs().max()) <= 1e-4
    assert bool((got[1][2] <= -1e29).all()) and not got[0][2].any()


@pytest.mark.parametrize("arch,shape,b", [("yi-6b", (2, 2), 4),
                                          ("yi-6b", (1, 8), 4),
                                          ("yi-6b", (2, 2), 1),
                                          ("zamba2-2.7b", (2, 2), 2)])
def test_serve_mesh_step_on_card_matches_mesh_free(cuda, arch, shape, b):
    """The mesh serve step over a debug mesh of repeated cuda:0 (every
    coordinate on the card), its weights placed by SERVE_PARAM_RULES,
    against the mesh-free step on the same card,
    3 rounds of SMOKE weights (fp32; yi-6b's 4 kv heads over 'model' 8:
    8 stripes): logits within 1e-4, tokens equal, joined arenas within
    1e-5; each coordinate launches its own kernel."""
    from repro_torch import configs as TC
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as TM
    from repro_torch.models import transformer as TTF
    from repro_torch.models.params import param_axes
    from repro_torch.parallel import sharding as SH
    from repro_torch.serving import engine as TE
    from repro_torch.serving import paged as TP
    cfg = TC.get_smoke(arch)
    with TM.force_device_count(int(np.prod(shape))):
        mesh = TM.make_debug_mesh(*shape)
    assert all(d.type == "cuda" for d in mesh.devices.flat)
    params = TTF.init_model(torch.Generator(device=cuda).manual_seed(0),
                            cfg, cuda)
    geo = dict(batch=b, seq_len=64, kv_heads=cfg.n_kv_heads,
               head_dim=cfg.head_dim, q_heads=cfg.n_heads, block=8)
    geom = TP.plan_geometry(mesh=mesh, **geo)
    free = TP.plan_geometry(**geo)
    glob = TE.init_serve_state(cfg, free, free.cap, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    for k in ("arena", "shared_arena"):
        if k in glob:
            glob[k][:, :free.cap] = torch.randn(
                glob[k][:, :free.cap].shape, generator=g, device=cuda)
    placed = TE.place_state(glob, geom, mesh)
    weights = SH.place_params(params, param_axes(cfg), SH.SERVE_PARAM_RULES,
                              mesh)
    rng = np.random.default_rng(2)
    st, cl, bl = geom.stripe_total, geom.cap_local, geom.batch_local
    free_rows = [list(rng.permutation(cl)) for _ in range(geom.cap // cl)]
    pt = np.full((b, st, geom.nblk_local), -1, np.int32)
    for i in range(b):
        for j in range(geom.nblk):
            pt[i, j % st, j // st] = free_rows[(i // bl) * st + j % st].pop()
    pt = torch.from_numpy(pt).to(cuda)
    lens = torch.tensor([5, 17, 40, 9][:b], dtype=torch.int32, device=cuda)
    tokens = torch.tensor([3, 1, 4, 1][:b], dtype=torch.int32, device=cuda)
    active = torch.ones(b, dtype=torch.bool, device=cuda)
    mesh_step = TE.make_serve_step(cfg, geom, mesh)
    free_step = TE.make_serve_step(cfg, free)
    for _ in range(3):
        wr = TP.mesh_write_rows(geom, pt, lens, active)
        inputs = {"tokens": tokens, "lengths": lens, "write_off": lens % 8,
                  "pt": pt, "blk_start": torch.from_numpy(
                      TP.build_blk_start(geom)).to(cuda), "write_rows": wr}
        before = dict(_build.launches)
        nm, _, lm = mesh_step(weights, placed, inputs)
        torch.cuda.synchronize()
        n_paged = sum(_build.launches[k] - before[k] for k in (
            "paged_attention", "paged_attention_wide", "paged_attention_lse"))
        apps = TTF.n_attn_layers(cfg) + (cfg.n_shared_applications()
                                         if cfg.shared_attn_every else 0)
        assert n_paged == apps * len(TP.coordinates(geom, mesh))
        nf, _, lf = free_step(params, glob, dict(
            inputs, pt=TP.global_page_table(geom, pt)[:, None],
            blk_start=torch.from_numpy(TP.build_blk_start(free)).to(cuda),
            write_rows=TP.global_write_rows(geom, wr)))
        assert float((lm - lf).abs().max()) <= 1e-4
        assert torch.equal(nm, nf)
        tokens, lens = nf, lens + 1
    joined = TE.join_state(placed, geom, mesh)
    for k in ("arena", "shared_arena"):
        if k in glob:
            assert float((joined[k] - glob[k][:, :free.cap]).abs().max()) \
                <= 1e-5


def test_seqpar_attention_on_card_matches_mesh_free(cuda):
    """Sequence-parallel attention over a 'model' axis of 4 (cuda:0
    repeated) through the flash kernel, forward and backward, against the
    same sub-layer without the mesh (bf16 within 2e-2 of the largest)."""
    import dataclasses

    from repro_torch import configs as TC
    from repro_torch.launch import mesh as TM
    from repro_torch.models.layers import attention as TA
    from repro_torch.parallel import sharding as TS
    cfg = TC.get_config("gemma2-2b")
    p = TA.init_attention(torch.Generator(device=cuda).manual_seed(0), cfg,
                          cuda)
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((1, 2048, cfg.d_model), generator=g, device=cuda
                    ).bfloat16().requires_grad_(True)
    pos = torch.arange(2048, device=cuda)[None]
    with TM.force_device_count(4):
        mesh = TM.make_mesh((4,), ("model",))

    def run(c, m):
        with TS.axis_rules(TS.DEFAULT_RULES if m else None, m):
            o = TA.attention_forward(p, c, x, pos, theta=1e4,
                                     window=cfg.window)
            grads = torch.autograd.grad(o.float().square().sum(),
                                        [x] + list(p.values()))
        return o, grads
    o0, g0 = run(cfg, None)
    o1, g1 = run(dataclasses.replace(cfg, attn_seq_shard=True), mesh)
    torch.cuda.synchronize()
    top = float(o0.float().abs().max())
    assert float((o1.float() - o0.float()).abs().max()) <= 2e-2 * top
    for a, c in zip(g1, g0):
        top = float(c.float().abs().max())
        assert float((a.float() - c.float()).abs().max()) <= 2e-2 * top


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    (2, 36, 4, 32, 32, True, 0, 0.0, 0),     # starcoder2-7b SMOKE's heads
    (1, 4, 2, 70, 70, True, 17, 20.0, 0),
    (2, 4, 4, 13, 40, False, 0, 0.0, 0)])
def test_flash_head_dim_4_matches_plain(cuda, dtype, case):
    """Head dim 4 through the wrappers' zero-padded route (the kernels at
    head dim 8), forward with its gradients, against the plain version at
    head dim 4: fp32 within 1e-5 / 1e-4, bf16 within 2e-2 of the
    largest."""
    b, h, kh, sq, sk, causal, window, softcap, q_offset = case
    g = torch.Generator(device=cuda).manual_seed(sum(case[:5]))
    q, k, v, do = (torch.randn(s, generator=g, device=cuda).to(dtype)
                   for s in ((b, h, sq, 4), (b, kh, sk, 4), (b, kh, sk, 4),
                             (b, h, sq, 4)))
    kw = dict(scale=0.5, causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = FA.flash_attention(*leaves, **kw)
    got.backward(do)
    want = FA.flash_attention_ref(q, k, v, **kw)
    o, lse = FA.padded(FA._forward, q, k, v, with_lse=True, **kw)
    wg = FA.flash_attention_bwd_ref(q, k, v, want, FA.attention_lse_ref(
        q, k, **kw), do, **kw)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= tol * max(
        float(want.float().abs().max()), 1.0)
    assert o.shape == want.shape and lse.shape == (b, h, sq)
    gtol = 1e-4 if dtype == torch.float32 else 2e-2
    for t, w in zip(leaves, wg):
        assert t.grad.shape == w.shape
        assert float((t.grad.float() - w).abs().max()) <= gtol * float(
            w.abs().max())


def test_capture_survives_a_collection_of_another_graph(cuda):
    """A gc.collect() on the capturing thread, in the middle of a capture,
    while an unreachable cycle holds another captured graph (as a dropped
    daemon's or engine's plans do): the guard defers that graph's
    destruction to the capture's end, the capture succeeds and replays."""
    import gc

    from repro_torch.core import execache as EC
    side = torch.cuda.Stream()
    x = torch.ones(1024, device=cuda)
    side.wait_stream(torch.cuda.current_stream())

    def captured(fn):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side), EC.capture_guard():
            g.capture_begin(pool=torch.cuda.graph_pool_handle(),
                            capture_error_mode="thread_local")
            out = fn()
            g.capture_end()
        return g, out

    class Owner:
        pass
    before = EC.deferred_total()
    gc.disable()   # the collection happens inside the capture, not before
    try:
        _collect_in_captures(captured, Owner, x, side)
    finally:
        gc.enable()
    assert EC.deferred_total() >= before + 3
    assert EC.deferred_count() == 0 and not EC.capturing()


def _collect_in_captures(captured, Owner, x, side):
    import gc

    from repro_torch.core import execache as EC
    for _ in range(3):
        a, b = Owner(), Owner()
        a.peer, b.peer = b, a
        g0, out0 = captured(lambda: x * 2)
        a.hold = EC.GraphHold(g0, out0)
        del a, b, g0, out0

        def body():
            y = x + 1
            gc.collect()    # the cycle (and its graph) is collected here
            return y * 3
        g1, out1 = captured(body)
        g1.replay()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        assert float(out1[0]) == 6.0
        del g1, out1


def test_placed_dense_decode_on_card_matches_mesh_free(cuda):
    """``decode_step`` over weights placed by SERVE_PARAM_RULES and a cache
    placed by ``place_cache`` over (2, 2) (cuda:0 repeated), yi-6b and
    zamba2-2.7b SMOKE, 3 rounds against the mesh-free step within 1e-4 of
    the largest logit; no kernel launched."""
    from repro_torch import configs as TC
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as TM
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import param_axes
    from repro_torch.parallel import sharding as TS
    for arch in ("yi-6b", "zamba2-2.7b"):
        cfg = TC.get_smoke(arch)
        params = TF.init_model(torch.Generator(device=cuda).manual_seed(0),
                               cfg, cuda)
        with TM.force_device_count(4):
            mesh = TM.make_debug_mesh(2, 2)
        pl = TS.place_params(params, param_axes(cfg), TS.SERVE_PARAM_RULES,
                             mesh)
        cache = TF.init_cache(cfg, 4, 32, cuda)
        placed = TF.place_cache(cfg, TF.init_cache(cfg, 4, 32, cuda), pl)
        lens = torch.tensor([0, 3, 9, 1], device=cuda)
        before = sum(_build.launches.values())
        for r in range(3):
            tok = torch.arange(4, device=cuda, dtype=torch.int32) * 7 + r
            lw, cache = TF.decode_step(params, cfg, tok, cache, lens)
            lg, placed = TF.decode_step(pl, cfg, tok, placed, lens)
            torch.cuda.synchronize()
            top = float(lw[:, :cfg.vocab].abs().max())
            assert float((lg - lw)[:, :cfg.vocab].abs().max()) <= 1e-4 * top
            lens = lens + 1
        assert sum(_build.launches.values()) == before


def test_seq_sharded_train_step_on_card_matches(cuda):
    """The placed train step (TRAIN_PARAM_RULES over (2, 2), cuda:0
    repeated, remat full) of gemma2-2b SMOKE under ``"seq": ("model",)``
    against the same step without the rule: loss within 1e-5 and every
    gradient leaf within 1e-4 of its largest; the residual stream's
    all-reduces over 'model' gone."""
    from repro_torch import configs as TC
    from repro_torch.launch import mesh as TM
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import param_axes
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import collectives as CO
    from repro_torch.parallel import sharding as TS
    from repro_torch.training.step import make_loss_grad_fn
    cfg = TC.get_smoke("gemma2-2b")
    params = TF.init_model(torch.Generator(device=cuda).manual_seed(0), cfg,
                           cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 64), generator=g,
                                     device=cuda, dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab, (4, 64), generator=g,
                                     device=cuda, dtype=torch.int32),
             "loss_mask": torch.ones((4, 64), device=cuda)}
    with TM.force_device_count(4):
        mesh = TM.make_debug_mesh(2, 2)
    pl = TS.place_params(params, param_axes(cfg), TS.TRAIN_PARAM_RULES, mesh)
    out = {}
    for tag, rules in (("none", TS.DEFAULT_RULES),
                       ("seq", dict(TS.DEFAULT_RULES, seq=("model",)))):
        with TS.axis_rules(rules, mesh), CO.recording() as log:
            (loss, _), grads = make_loss_grad_fn(cfg, remat="full")(pl,
                                                                     batch)
        out[tag] = (float(loss), tree_leaves(TS.gather_params(grads)), log)
    assert abs(out["seq"][0] - out["none"][0]) <= 1e-5
    for a, c in zip(out["seq"][1], out["none"][1]):
        assert float((a - c).abs().max()) <= 1e-4 * float(c.abs().max())
    assert not any(r.kind == "all-reduce" and r.axes == ("model",)
                   and r.origin.split("/")[0].endswith((".wo", ".w_down"))
                   for r in out["seq"][2])
    assert any(r.kind == "reduce-scatter" and r.axes == ("model",)
               for r in out["seq"][2])
