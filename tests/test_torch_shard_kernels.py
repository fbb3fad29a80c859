"""The shard axis of the port's kernels (plain versions, on the CPU) against
the reference's ``jax.vmap`` of its Pallas kernels in interpret mode, and
against separate calls of the port's unsharded plain versions.

A sharded table's kernels take (shard, statement) PAIRS: ``sid [n]`` names
each pair's shard, and the columns, validity and index are ``[S, ...]``
stacks. The reference reaches the same numbers by vmapping a kernel over
its stacked shards (a fan-out) or over pruned statements on their sliced
shards; here each pair's shard is sliced for it. Cases: a fan-out (every
shard for each statement, shard by shard) and statements routed to random
shards, a shard with no valid row, one bucket over 128 rows in one shard
only, and shard capacities off the kernels' tiles. Bucket contents are
compared as sets of (row, key) entries, not lane positions (the JAX
package's lane layout inside a bucket is its own); counts, masks and ids
compare exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hashidx as JH
from repro.kernels.relscan import compact as j_compact
from repro.kernels.relscan import relscan as j_relscan
from repro_torch.kernels import hashidx as TH
from repro_torch.kernels import relscan as TRS

# (shards, shard capacity): none on the scan's 8-row or 256-row tiles
SHAPES = [(2, 25), (3, 300), (4, 1003)]
OPS = [("<",), ("==", ">="), ("!=", "<=", ">", "<")]


def stacks(n_sh, cap_s, seed):
    """[S, cap_s] key columns and validity: shard 1 has no valid row, and
    shard 0 (when it holds 300 rows) has 300 rows of key 7."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(-20, 20, (n_sh, cap_s)).astype(np.int32)
            for _ in range(4)]
    keys = rng.integers(-5000, 5000, (n_sh, cap_s)).astype(np.int32)
    if cap_s >= 300:
        keys[0, rng.choice(cap_s, 300, replace=False)] = 7
    valid = rng.random((n_sh, cap_s)) < 0.85
    valid[1:2] = False
    return rng, cols, keys, valid


def pairs(rng, n_sh, w, fanout):
    """(sid [n], statement of each pair [n]) of a fan-out or of ``w``
    statements routed to random shards."""
    if fanout:
        return (np.repeat(np.arange(n_sh), w).astype(np.int32),
                np.tile(np.arange(w), n_sh))
    return rng.integers(0, n_sh, w).astype(np.int32), np.arange(w)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n_sh,cap_s", SHAPES)
@pytest.mark.parametrize("fanout", [True, False])
def test_scan_and_compact_match_vmapped_reference(n_sh, cap_s, fanout):
    rng, cols, _, valid = stacks(n_sh, cap_s, cap_s)
    sid, stmt = pairs(rng, n_sh, 3, fanout)
    limit = 8
    for ops in OPS:
        nt = len(ops)
        vals = rng.integers(-10, 10, (3, nt)).astype(np.int32)[stmt]
        ref = jax.vmap(lambda v, x, *c: j_relscan(
            c, v, x, ops=ops, limit=limit, interpret=True))(
            jnp.asarray(valid[sid]), jnp.asarray(vals),
            *(jnp.asarray(c[sid]) for c in cols[:nt]))
        mask, cnt, count = TRS.scan_ref([t(c) for c in cols[:nt]], t(valid),
                                        t(vals), ops, sid=t(sid))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(ref[2]))
        np.testing.assert_array_equal(count.numpy(), np.asarray(ref[3]))
        np.testing.assert_array_equal(cnt.sum(dim=1).numpy(),
                                      np.asarray(ref[3]))
        # the compaction takes the [pairs, cap_s] mask as rows
        ids, n = TRS.compact_ref(mask, limit)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(n.numpy(), np.asarray(ref[3]))
        jids, jpres = jax.vmap(lambda m: j_compact(m, limit=limit))(
            jnp.asarray(mask.numpy()))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("n_sh,cap_s", SHAPES)
def test_scan_equals_separate_calls(n_sh, cap_s):
    rng, cols, _, valid = stacks(n_sh, cap_s, cap_s + 1)
    for fanout in (True, False):
        sid, stmt = pairs(rng, n_sh, 4, fanout)
        for ops in OPS:
            nt = len(ops)
            vals = rng.integers(-10, 10, (4, nt)).astype(np.int32)[stmt]
            got = TRS.scan_ref([t(c) for c in cols[:nt]], t(valid), t(vals),
                               ops, sid=t(sid))
            for q, s in enumerate(sid):
                one = TRS.scan_ref([t(c[s]) for c in cols[:nt]], t(valid[s]),
                                   t(vals[q:q + 1]), ops)
                for a, b in zip(got, one):
                    np.testing.assert_array_equal(a[q].numpy(), b[0].numpy())


def entries(rid, key):
    """Each bucket's entries as a sorted tuple of (row, key) pairs."""
    rid, key = np.asarray(rid), np.asarray(key)
    return [tuple(sorted((int(r), int(k)) for r, k in zip(rr, kk) if r >= 0))
            for rr, kk in zip(rid.reshape(-1, rid.shape[-1]),
                              key.reshape(-1, key.shape[-1]))]


@pytest.mark.parametrize("n_sh,cap_s", SHAPES)
def test_build_matches_vmapped_reference(n_sh, cap_s):
    _, _, keys, valid = stacks(n_sh, cap_s, cap_s + 2)
    nb = TH.n_buckets_for(cap_s)
    jrid, jkey, jov = jax.vmap(lambda k, v: JH.build(
        k, v, n_buckets=nb, interpret=True))(jnp.asarray(keys),
                                             jnp.asarray(valid))
    rid, key, ov = TH.build_ref(t(keys), t(valid), n_buckets=nb)
    assert rid.shape == (n_sh, nb, TH.BUCKET_CAP) and ov.shape == (n_sh,)
    assert entries(rid, key) == entries(jrid, jkey)
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
    if cap_s >= 300:   # the hot bucket overflows in shard 0 alone
        assert ov[0] > 0 and (ov[1:] == 0).all()
    assert (rid[1] == TH.EMPTY).all()   # the shard with no valid row


@pytest.mark.parametrize("n_sh,cap_s", SHAPES)
def test_build_equals_separate_calls(n_sh, cap_s):
    _, _, keys, valid = stacks(n_sh, cap_s, cap_s + 3)
    nb = TH.n_buckets_for(cap_s)
    got = TH.build_ref(t(keys), t(valid), n_buckets=nb)
    for s in range(n_sh):
        one = TH.build_ref(t(keys[s]), t(valid[s]), n_buckets=nb)
        for a, b in zip(got, one):
            np.testing.assert_array_equal(a[s].numpy(), b.numpy())


def probe_case(n_sh, cap_s, seed, fanout):
    rng, cols, keys, valid = stacks(n_sh, cap_s, seed)
    nb = TH.n_buckets_for(cap_s)
    rid, key, _ = TH.build_ref(t(keys), t(valid), n_buckets=nb)
    live = valid.copy()
    live[:, ::5] = False   # rows dead after the build
    sid, stmt = pairs(rng, n_sh, 6, fanout)
    q = keys[sid, rng.integers(0, cap_s, len(sid))]
    q[::3] = rng.integers(-5000, 5000, len(q[::3]))
    q[0] = 7
    return rng, cols, keys, live, rid, key, t(sid), t(q.astype(np.int32))


@pytest.mark.parametrize("n_sh,cap_s", SHAPES)
@pytest.mark.parametrize("fanout", [True, False])
def test_verified_probe_matches_vmapped_reference(n_sh, cap_s, fanout):
    _, _, keys, live, rid, key, sid, q = probe_case(n_sh, cap_s, cap_s + 4,
                                                    fanout)
    s = sid.numpy()
    cand, hit = jax.vmap(lambda r, k, x: JH.probe(r, k, x, interpret=True))(
        jnp.asarray(rid.numpy()[s]), jnp.asarray(key.numpy()[s]),
        jnp.asarray(q.numpy()[:, None]))
    cand, hit = np.asarray(cand)[:, 0], np.asarray(hit)[:, 0]
    limit = 64
    safe, ok, count, ids = TH.probe_verify_ref(
        rid, key, q, valid=t(live), keycol=t(keys), limit=limit, sid=sid)
    for i in range(len(s)):
        c = np.clip(cand[i], 0, cap_s - 1)
        # the reference executors' verification of the probe's candidates
        want = hit[i] & live[s[i], c] & (keys[s[i], c] == q[i].item())
        np.testing.assert_array_equal(safe[i].numpy(), c)
        np.testing.assert_array_equal(ok[i].numpy(), want)
        rows = sorted(c[want].tolist())
        assert count[i].item() == len(rows)
        assert ids[i, :len(rows)].tolist() == rows[:limit]
        assert (ids[i, len(rows):] == 0).all()


@pytest.mark.parametrize("n_sh,cap_s", SHAPES)
def test_verified_probe_equals_separate_calls(n_sh, cap_s):
    for fanout in (True, False):
        rng, cols, keys, live, rid, key, sid, q = probe_case(
            n_sh, cap_s, cap_s + 5, fanout)
        n = sid.shape[0]
        extra = rng.random((n_sh, cap_s)) < 0.7
        active = rng.random(n) < 0.8
        vals = [t(rng.integers(-10, 10, n).astype(np.int32)) for _ in range(2)]
        residual = [(t(cols[0]), "<", vals[0]), (t(cols[1]), ">=", vals[1])]
        got = TH.probe_verify_ref(rid, key, q, valid=t(live), keycol=t(keys),
                                  residual=residual, extra_mask=t(extra),
                                  active=t(active), limit=200, sid=sid)
        for i, s in enumerate(sid.tolist()):
            one = TH.probe_verify_ref(
                rid[s], key[s], q[i:i + 1], valid=t(live[s]),
                keycol=t(keys[s]),
                residual=[(c[s], op, v[i:i + 1]) for c, op, v in residual],
                extra_mask=t(extra[s]), active=t(active[i:i + 1]), limit=200)
            for a, b in zip(got, one):
                np.testing.assert_array_equal(a[i].numpy(), b[0].numpy())


def test_one_shard_at_sid_zero_is_the_unsharded_call():
    """S = 1 with sid = 0 gives the unsharded call's outputs."""
    _, cols, keys, valid = stacks(1, 700, 9)
    zero = torch.zeros(3, dtype=torch.int32)
    vals = t(np.array([[-3, 4], [0, 0], [5, -5]], np.int32))
    a = TRS.scan_ref([t(cols[0][0]), t(cols[1][0])], t(valid[0]), vals,
                     ("<", ">="))
    b = TRS.scan_ref([t(cols[0]), t(cols[1])], t(valid), vals, ("<", ">="),
                     sid=zero)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    nb = TH.n_buckets_for(700)
    c = TH.build_ref(t(keys[0]), t(valid[0]), n_buckets=nb)
    d = TH.build_ref(t(keys), t(valid), n_buckets=nb)
    for x, y in zip(c, d):
        assert torch.equal(x, y[0])
    q = t(keys[0, :3].copy())
    e = TH.probe_verify_ref(c[0], c[1], q, valid=t(valid[0]),
                            keycol=t(keys[0]), limit=8)
    f = TH.probe_verify_ref(d[0], d[1], q, valid=t(valid), keycol=t(keys),
                            limit=8, sid=zero)
    for x, y in zip(e, f):
        assert torch.equal(x, y)
