"""The port's kernel modules against the JAX reference on the CPU.

The same seeded numpy inputs go through the reference's Pallas kernels
(run in interpret mode, as tests/test_relscan_parity.py and
tests/test_hashidx.py run them) and through the port's wrappers, which
take their plain PyTorch versions for CPU tensors. Everything compared
here is integers and bits, so equality is exact."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import hashidx as JH
from repro.kernels import ref as JR
from repro.kernels.relscan import relscan as j_relscan
from repro_torch.kernels import hashidx as TH
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TR
from repro_torch.kernels import relscan as TRS


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


CASES = [
    (("==",), [2]),
    (("==", "!="), [0, 1]),
    ((">=", "<=", "==", "!="), [1, 3, 2, 9]),
    (("<", ">"), [3, 0]),
    (("<",), [0]),          # no matches
    ((">=",), [0]),         # every valid row matches
]


@pytest.mark.parametrize("cap,limit", [(100, 1), (2500, 64)])
def test_relscan_matches_pallas_interpret(cap, limit):
    rng = np.random.default_rng(cap)
    cols = [rng.integers(0, 5, cap).astype(np.int32) for _ in range(4)]
    valid = rng.random(cap) < 0.8
    for ops, vals in CASES:
        nt = len(ops)
        want = j_relscan(tuple(jnp.asarray(c) for c in cols[:nt]),
                         jnp.asarray(valid), jnp.asarray(vals, jnp.int32),
                         ops=ops, limit=limit, interpret=True)
        got = TOPS.predicate_scan([_t(c) for c in cols[:nt]], _t(valid),
                                  torch.tensor(vals, dtype=torch.int32),
                                  ops=ops, limit=limit)
        for w, g in zip(want, got):
            _eq(w, g)


@pytest.mark.parametrize("cap", [100, 2500])
def test_scan_ref_count_matches_pallas_interpret(cap):
    """The scan's third output, the total each statement matched, against
    the count the reference's relscan returns (its Pallas kernels in
    interpret mode), one statement a row of the [w, nterms] values."""
    rng = np.random.default_rng(cap + 1)
    cols = [rng.integers(0, 5, cap).astype(np.int32) for _ in range(4)]
    valid = rng.random(cap) < 0.8
    for ops, vals in CASES:
        nt = len(ops)
        batch = np.stack([vals, np.roll(vals, 1)]).astype(np.int32)
        mask, cnt, count = TRS.scan_ref([_t(c) for c in cols[:nt]],
                                        _t(valid), torch.from_numpy(batch),
                                        ops)
        assert count.dtype == torch.int32 and count.shape == (2,)
        assert torch.equal(count, cnt.sum(dim=1, dtype=torch.int32))
        for i in range(2):
            want = j_relscan(tuple(jnp.asarray(c) for c in cols[:nt]),
                             jnp.asarray(valid), jnp.asarray(batch[i]),
                             ops=ops, limit=1, interpret=True)
            assert int(want[3]) == int(count[i])
            _eq(want[2], mask[i])


def test_relscan_batched_rows_match_single_statements():
    rng = np.random.default_rng(5)
    cap = 3000
    cols = [_t(rng.integers(-3, 3, cap).astype(np.int32)) for _ in range(2)]
    valid = _t(rng.random(cap) < 0.9)
    vals = torch.tensor(rng.integers(-3, 3, (7, 2)), dtype=torch.int32)
    ops = ("==", ">=")
    ids, present, mask, count = TRS.relscan(cols, valid, vals, ops=ops,
                                            limit=32)
    for i in range(7):
        one = TR.relscan_ref(cols, valid, vals[i:i + 1], ops=ops, limit=32)
        for a, b in zip((ids, present, mask, count), one):
            assert torch.equal(a[i], b[0])
    # the reference oracle agrees too
    jw = JR.relscan_ref(tuple(jnp.asarray(c.numpy()) for c in cols),
                        jnp.asarray(valid.numpy()), jnp.asarray(vals[3]),
                        ops=ops, limit=32)
    for w, g in zip(jw, (ids[3], present[3], mask[3], count[3])):
        _eq(w, g)


def test_compact_plain_matches_reference_compact():
    """compact(mask, limit) -> (ids, count): the reference's compact
    helper's ids and presence, and its relscan oracle's ids and count,
    row by row of a [w, cap] mask."""
    from repro.kernels.relscan import compact as j_compact
    rng = np.random.default_rng(1)
    w, cap = 3, 1000
    for p in (0.0, 0.01, 0.5, 1.0):
        mask = rng.random((w, cap)) < p
        mask[1] = rng.random(cap) < p / 2   # rows of different counts
        for limit in (1, 7, 200):
            ids_t, count_t = TRS.compact(_t(mask), limit)
            assert ids_t.shape == (w, limit) and count_t.shape == (w,)
            for i in range(w):
                ids_j, present_j = j_compact(jnp.asarray(mask[i]),
                                             limit=limit)
                _eq(ids_j, ids_t[i])
                _eq(present_j, torch.arange(limit) < count_t[i])
                # the oracle over a column that equals the mask row
                ids_r, _, _, count_r = JR.relscan_ref(
                    (jnp.asarray(mask[i].astype(np.int32)),),
                    jnp.ones(cap, bool), jnp.asarray([1], jnp.int32),
                    ops=("==",), limit=limit)
                _eq(ids_r, ids_t[i])
                assert int(count_r) == int(count_t[i]) == int(mask[i].sum())


def test_bucket_of_negative_and_large_keys():
    keys = np.array([0, 1, -1, -2, 7, -7, 2**31 - 1, -2**31, 123456789,
                     -987654321], np.int32)
    for nb in (8, 64, 4096, 1 << 20):
        _eq(JH.bucket_of(jnp.asarray(keys), nb),
            TH.bucket_of(_t(keys), nb))


@pytest.mark.parametrize("cap", [64, 300, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_build_matches_pallas_interpret(cap, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-50, 50, cap).astype(np.int32)
    valid = rng.random(cap) < 0.8
    nb = JH.n_buckets_for(cap)
    assert TH.n_buckets_for(cap) == nb
    want = JH.build(jnp.asarray(keys), jnp.asarray(valid), n_buckets=nb,
                    interpret=True)
    got = TH.build(_t(keys), _t(valid), n_buckets=nb)
    for w, g in zip(want, got):
        _eq(w, g)


def test_build_overflow_matches():
    """One key repeated past a bucket's 128 lanes: the same nonzero
    overflow count (the daemon's stale flag)."""
    cap = 512
    keys = np.full(cap, 7, np.int32)
    keys[300:] = np.arange(212, dtype=np.int32)
    valid = np.ones(cap, bool)
    nb = JH.n_buckets_for(cap)
    want = JH.build_ref(jnp.asarray(keys), jnp.asarray(valid), n_buckets=nb)
    got = TH.build_ref(_t(keys), _t(valid), n_buckets=nb)
    assert int(want[2]) == int(got[2]) > 0
    for w, g in zip(want, got):
        _eq(w, g)


def _hot_bucket_keys(rng, cap, nb, n_hot, hot=7):
    """cap keys: ``hot`` at n_hot random rows, and at every other row a key
    whose bucket is not the hot key's, so that bucket holds exactly n_hot
    rows."""
    hot_b = int(TH.bucket_of(torch.tensor([hot], dtype=torch.int32), nb)[0])
    pool = np.arange(-5000, 5000, dtype=np.int32)
    pool = pool[TH.bucket_of(torch.from_numpy(pool), nb).numpy() != hot_b]
    keys = rng.choice(pool, cap).astype(np.int32)
    keys[rng.choice(cap, n_hot, replace=False)] = hot
    return keys


def _build_edge(kind):
    """(keys, valid, n_buckets, the overflow it must give or None) of one
    build edge case, at small cap."""
    rng = np.random.default_rng(len(kind))
    cap = 512
    nb = JH.n_buckets_for(cap)
    valid = np.ones(cap, bool)
    if kind == "one_bucket":        # every valid row in one bucket
        return np.full(cap, 7, np.int32), valid, nb, cap - 128
    if kind in ("bucket_128", "bucket_129"):
        n = int(kind[-3:])
        return _hot_bucket_keys(rng, cap, nb, n), valid, nb, n - 128
    keys = rng.integers(-50, 50, cap).astype(np.int32)
    if kind == "nb_12":             # not a power of two: buckets 8-11 empty
        return keys[:300], rng.random(300) < 0.8, 12, None
    if kind == "all_invalid":
        return keys, np.zeros(cap, bool), nb, 0
    if kind == "cap_1":
        return keys[:1], valid[:1], JH.n_buckets_for(1), 0
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["one_bucket", "bucket_128", "bucket_129",
                                  "nb_12", "all_invalid", "cap_1"])
def test_build_edges_match_pallas_interpret(kind):
    """The build's edges: a bucket of exactly 128 and of 129 rows, every
    row in one bucket, a bucket count that is no power of two, no valid
    row, one row. The port's plain build equals the reference's Pallas
    build (interpret mode) and its oracle lane for lane, overflow
    included."""
    keys, valid, nb, overflow = _build_edge(kind)
    got = TH.build(_t(keys), _t(valid), n_buckets=nb)
    for want in (JH.build(jnp.asarray(keys), jnp.asarray(valid),
                          n_buckets=nb, interpret=True),
                 JH.build_ref(jnp.asarray(keys), jnp.asarray(valid),
                              n_buckets=nb)):
        for w, g in zip(want, got):
            _eq(w, g)
    if overflow is not None:
        assert int(got[2]) == overflow
    if kind == "nb_12":
        assert bool((got[0][8:] == TH.EMPTY).all())


@pytest.mark.parametrize("n_buckets", [0, 1])
def test_build_refuses_fewer_than_two_buckets(n_buckets):
    """A bucket id is the top bit_length(n_buckets) - 1 bits of the hash:
    with fewer than two buckets that is no bit (a shift by 32 in the
    kernel), so both paths refuse it, as the probe does."""
    keys = torch.zeros(16, dtype=torch.int32)
    valid = torch.ones(16, dtype=torch.bool)
    for fn in (TH.build, TH.build_ref):
        with pytest.raises(ValueError, match="n_buckets"):
            fn(keys, valid, n_buckets=n_buckets)


def test_probe_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    keys = rng.integers(-60, 60, 512).astype(np.int32)
    valid = rng.random(512) < 0.8
    nb = JH.n_buckets_for(512)
    rid, key, _ = JH.build_ref(jnp.asarray(keys), jnp.asarray(valid),
                               n_buckets=nb)
    q = rng.integers(-70, 70, 33).astype(np.int32)
    want = JH.probe(rid, key, jnp.asarray(q), interpret=True)
    got = TH.probe(_t(rid), _t(key), _t(q))
    for w, g in zip(want, got):
        _eq(w, g)


@pytest.mark.parametrize("seed", [0, 1])
def test_insert_update_batched_entry_sets(seed):
    """Incremental maintenance: the same per-bucket entry sets and stale
    count as the reference, including a bucket that overflows."""
    rng = np.random.default_rng(seed)
    cap = 256
    nb = JH.n_buckets_for(cap)
    keys = rng.integers(0, 40, cap).astype(np.int32)
    valid = rng.random(cap) < 0.6
    rid, key, stale = JH.build_ref(jnp.asarray(keys), jnp.asarray(valid),
                                   n_buckets=nb)
    idx_j = {"rid": rid, "key": key, "stale": stale}
    idx_t = {k: _t(v) for k, v in idx_j.items()}
    n = 48
    slots = rng.choice(cap, n, replace=False).astype(np.int32)
    new_keys = rng.integers(0, 6, n).astype(np.int32)
    new_keys[:20] = 3  # a hot key
    row_mask = rng.random(n) < 0.9
    keys2 = keys.copy()
    keys2[slots[row_mask]] = new_keys[row_mask]
    valid2 = valid.copy()
    valid2[slots[row_mask]] = True
    out_j = JH.insert_update_batched(
        idx_j, jnp.asarray(slots), jnp.asarray(keys[slots]),
        jnp.asarray(new_keys), jnp.asarray(row_mask), jnp.asarray(valid2))
    out_t = TH.insert_update_batched(
        idx_t, _t(slots), _t(keys[slots]), _t(new_keys), _t(row_mask),
        _t(valid2))
    assert int(out_j["stale"]) == int(out_t["stale"])
    rj, kj = np.asarray(out_j["rid"]), np.asarray(out_j["key"])
    rt, kt = out_t["rid"].numpy(), out_t["key"].numpy()
    for b in range(nb):
        want = {(r, k) for r, k in zip(rj[b], kj[b]) if r != JH.EMPTY}
        got = {(r, k) for r, k in zip(rt[b], kt[b]) if r != TH.EMPTY}
        assert want == got, b


def test_cpu_wrappers_never_launch():
    from repro_torch.kernels import _build
    _build.reset_launches()
    c = torch.zeros(64, dtype=torch.int32)
    v = torch.ones(64, dtype=torch.bool)
    TRS.relscan([c], v, torch.zeros((1, 1), dtype=torch.int32),
                ops=("==",), limit=4)
    rid, key, _ = TH.build(c, v, n_buckets=8)
    TH.probe(rid, key, torch.zeros(2, dtype=torch.int32))
    assert all(n == 0 for n in _build.launches.values())


def test_meta_tensor_is_refused():
    c = torch.zeros(64, dtype=torch.int32, device="meta")
    v = torch.ones(64, dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="not served"):
        TRS.scan([c], v, torch.zeros((1, 1), dtype=torch.int32,
                                     device="meta"), ("==",))
