"""The port's table executors against the reference's, on the CPU.

The same randomized insert / update / delete / expire streams run through
``repro.core.table`` (JAX) and ``repro_torch.core.table`` from seeded
numpy inputs; after every step the whole states must be equal, and
SELECT / DELETE / UPDATE / aggregates with each route forced (index probe,
fused scan, generic scan) must return the same counts, row ids, rows and
values. Integers, bitmaps and ids compare exactly; float aggregates use
rtol=1e-5 because the two backends sum in different orders."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import planner as JPL
from repro.core import predicate as JP
from repro.core import table as JT
from repro.core.schema import ExpiryPolicy as JExp
from repro.core.schema import make_schema as j_make
from repro_torch import convert as CV
from repro_torch.core import planner as TPL
from repro_torch.core import predicate as TP
from repro_torch.core import table as TT
from repro_torch.core.schema import ExpiryPolicy as TExp
from repro_torch.core.schema import make_schema as t_make


def schemas(capacity=192, max_select=32, indexes=("k",), ttl=0, max_rows=0):
    cols = [("k", "INT"), ("w", "INT"), ("f", "FLOAT")]
    return (j_make("t", cols, capacity=capacity, max_select=max_select,
                   expiry=JExp(ttl=ttl, max_rows=max_rows), indexes=indexes),
            t_make("t", cols, capacity=capacity, max_select=max_select,
                   expiry=TExp(ttl=ttl, max_rows=max_rows), indexes=indexes))


def same_state(js, ts):
    want = jax.tree.map(np.asarray, js)
    got = CV.state_to_numpy(ts)

    def walk(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)

    walk(want, got, "")


def both(node_fn):
    """The same AST built from each package's predicate classes."""
    return node_fn(JP), node_fn(TP)


def eq_k(P, v):
    return P.BinOp("=", P.Col("k"), v(P))


def insert_both(jsch, tsch, js, ts, rng, m, ttl=0, key_hi=8):
    k = rng.integers(0, key_hi, m).astype(np.int32)
    w = rng.integers(0, 60, m).astype(np.int32)
    f = rng.standard_normal(m).astype(np.float32)
    js, jslots, jev = JT.insert(jsch, js, {"k": jnp.asarray(k),
                                           "w": jnp.asarray(w),
                                           "f": jnp.asarray(f)}, ttl=ttl)
    ts, tslots, tev = TT.insert(tsch, ts, {"k": torch.from_numpy(k),
                                           "w": torch.from_numpy(w),
                                           "f": torch.from_numpy(f)}, ttl=ttl)
    np.testing.assert_array_equal(np.asarray(jslots), tslots.numpy())
    assert int(jev) == int(tev)
    return js, ts


@functools.lru_cache(maxsize=None)
def random_states(seed, ttl=False, n_ops=7):
    """Both packages' states after one random mutation stream, compared
    after every step (cached: executors never modify a state they are
    given, so tests may share one)."""
    rng = np.random.default_rng(seed)
    jsch, tsch = schemas(ttl=1 if ttl else 0)
    js, ts = JT.init_state(jsch), TT.init_state(tsch, "cpu")
    for _ in range(n_ops):
        op = rng.integers(0, 5)
        if op <= 1:
            # few distinct batch widths: the reference's eager ops
            # compile once per shape
            js, ts = insert_both(jsch, tsch, js, ts, rng,
                                 int(rng.choice([8, 24])),
                                 ttl=int(rng.integers(1, 6)) if ttl else 0)
        elif op == 2:
            c = int(rng.integers(0, 8))
            jw, tw = both(lambda P: eq_k(P, lambda P: P.Const(c)))
            js, jn = JT.delete(jsch, js, jw)
            ts, tn = TT.delete(tsch, ts, tw)
            assert int(jn) == int(tn)
        elif op == 3:
            c = int(rng.integers(0, 8))
            jw, tw = both(lambda P: eq_k(P, lambda P: P.Const(c)))
            js_set = {"w": JP.BinOp("+", JP.Col("w"), JP.Const(7))}
            ts_set = {"w": TP.BinOp("+", TP.Col("w"), TP.Const(7))}
            js, jn = JT.update(jsch, js, jw, js_set)
            ts, tn = TT.update(tsch, ts, tw, ts_set)
            assert int(jn) == int(tn)
        else:
            jw, tw = both(lambda P: P.BinOp("<", P.Col("w"), P.Const(20)))
            js, jn = JT.delete(jsch, js, jw)
            ts, tn = TT.delete(tsch, ts, tw)
            assert int(jn) == int(tn)
        same_state(js, ts)
    if ttl:
        js = dict(js, clock=js["clock"] + 4)
        ts = dict(ts, clock=ts["clock"] + 4)
        js, jn = JT.expire(jsch, js)
        ts, tn = TT.expire(tsch, ts)
        assert int(jn) == int(tn)
        same_state(js, ts)
    return jsch, tsch, js, ts


WHERES = {
    "eq": (lambda P: eq_k(P, lambda P: P.Param(0)), (3,)),
    "eq_const": (lambda P: eq_k(P, lambda P: P.Const(5)), ()),
    "eq_plus_residual": (
        lambda P: P.And(eq_k(P, lambda P: P.Param(0)),
                        P.BinOp(">=", P.Col("w"), P.Param(1))), (2, 10)),
    "eq_plus_range": (
        lambda P: P.And(eq_k(P, lambda P: P.Param(0)),
                        P.Between(P.Col("w"), P.Param(1), P.Param(2))),
        (1, 5, 40)),
}


def forced(jsch, tsch, jw, tw):
    jplan, tplan = JPL.plan_where(jsch, jw), TPL.plan_where(tsch, tw)
    assert isinstance(jplan, JPL.IndexProbe)
    return [(jplan, tplan),
            (JPL.FusedScan(JPL.as_fused(jplan)), TPL.FusedScan(TPL.as_fused(tplan))),
            (JPL.GenericScan(), TPL.GenericScan()),
            (None, None)]


def same_select(jres, tres):
    assert int(jres["count"]) == int(tres["count"])
    np.testing.assert_array_equal(np.asarray(jres["row_ids"]),
                                  tres["row_ids"].numpy())
    np.testing.assert_array_equal(np.asarray(jres["present"]),
                                  tres["present"].numpy())
    for c in jres["rows"]:
        np.testing.assert_array_equal(np.asarray(jres["rows"][c]),
                                      tres["rows"][c].numpy())


@pytest.mark.parametrize("name", sorted(WHERES))
@pytest.mark.parametrize("seed,ttl", [(0, False), (1, True)])
def test_select_every_route_matches_reference(name, seed, ttl):
    fn, params = WHERES[name]
    jsch, tsch, js, ts = random_states(seed, ttl=ttl)
    jw, tw = both(fn)
    for jplan, tplan in forced(jsch, tsch, jw, tw):
        jn, jres = JT.select(jsch, js, jw, params, plan=jplan)
        tn, tres = TT.select(tsch, ts, tw, params, plan=tplan)
        same_select(jres, tres)
        same_state(jn, tn)  # the touch stamps agree too


@pytest.mark.parametrize("seed", [0])
def test_delete_update_aggregate_every_route(seed):
    fn, params = WHERES["eq_plus_residual"]
    jsch, tsch, js, ts = random_states(seed)
    jw, tw = both(fn)
    for jplan, tplan in forced(jsch, tsch, jw, tw):
        jn, jc = JT.delete(jsch, js, jw, params, plan=jplan)
        tn, tc = TT.delete(tsch, ts, tw, params, plan=tplan)
        assert int(jc) == int(tc)
        same_state(jn, tn)
        jn, jc, jids, jpr = JT.delete_returning(jsch, js, jw, params,
                                                plan=jplan)
        tn, tc, tids, tpr = TT.delete_returning(tsch, ts, tw, params,
                                                plan=tplan)
        np.testing.assert_array_equal(np.asarray(jids), tids.numpy())
        np.testing.assert_array_equal(np.asarray(jpr), tpr.numpy())
        jn, jc = JT.update(jsch, js, jw, {"w": JP.BinOp("*", JP.Col("w"),
                                                        JP.Const(2))},
                           params, plan=jplan)
        tn, tc = TT.update(tsch, ts, tw, {"w": TP.BinOp("*", TP.Col("w"),
                                                        TP.Const(2))},
                           params, plan=tplan)
        assert int(jc) == int(tc)
        same_state(jn, tn)
        for agg, col in [("COUNT", None), ("SUM", "w"), ("MIN", "w"),
                         ("MAX", "w"), ("AVG", "w"), ("SUM", "f"),
                         ("AVG", "f"), ("MIN", "f")]:
            jv = JT.aggregate(jsch, js, agg, col, jw, params, plan=jplan)[1]
            tv = TT.aggregate(tsch, ts, agg, col, tw, params, plan=tplan)[1]
            # float sums: another summation order -> rtol 1e-5
            np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=1e-5)
            assert np.asarray(jv).dtype == tv.numpy().dtype


@pytest.mark.parametrize("name", ["eq", "eq_plus_residual",
                                  "eq_plus_range"])
@pytest.mark.parametrize("limit,gate", [(1, False), (5, True), (200, False)])
def test_probe_verify_ref_matches_reference_probe_helpers(name, limit, gate):
    """HX.probe_verify_ref over w keys against the reference's
    _probe_candidates + _probe_ids, one statement at a time, on the index
    both packages built from the same seeded rows: the clamped candidates,
    the match bits, the count and the first ``limit`` ids (limit 200 is
    past the bucket's 128 lanes); ``gate`` adds an extra mask."""
    from repro_torch.kernels import hashidx as HX
    fn, params = WHERES[name]
    jsch, tsch, js, ts = random_states(0)
    jw, tw = both(fn)
    jplan, tplan = JPL.plan_where(jsch, jw), TPL.plan_where(tsch, tw)
    keys = [params[0] if params else 5, 0, 7, 42]
    rows = [(k,) + tuple(params[1:]) if params else () for k in keys]
    if not params:   # eq_const: the key is the plan's constant
        keys, rows = [5], [()]
    gate_np = np.random.default_rng(1).random(jsch.capacity) < 0.7
    em = torch.from_numpy(gate_np) if gate else None
    w = len(keys)
    vals = lambda t: torch.tensor(  # noqa: E731
        [r[t.value[1]] if t.value[0] == "param" else t.value[1]
         for r in rows], dtype=torch.int32)
    idx = ts["indexes"]["k"]
    safe, ok, count, ids = HX.probe_verify_ref(
        idx["rid"], idx["key"], torch.tensor(keys, dtype=torch.int32),
        valid=ts["valid"], keycol=ts["cols"]["k"],
        residual=[(ts["cols"][t.col], t.op, vals(t)) for t in tplan.residual],
        extra_mask=em, limit=limit)
    assert safe.shape == ok.shape == (w, 128) and ids.shape == (w, limit)
    for i, r in enumerate(rows):
        jsafe, jok = JT._probe_candidates(
            jsch, js, jplan, r,
            extra_mask=jnp.asarray(gate_np) if gate else None)
        jids, _, jcount = JT._probe_ids(jsafe, jok, limit, jsch.capacity)
        np.testing.assert_array_equal(np.asarray(jsafe), safe[i].numpy())
        np.testing.assert_array_equal(np.asarray(jok), ok[i].numpy())
        assert int(jcount) == int(count[i])
        np.testing.assert_array_equal(np.asarray(jids), ids[i].numpy())
    assert int(count.sum()) > 0


def test_float_param_demotes_to_scan_and_matches():
    jsch, tsch, js, ts = random_states(1)
    jw, tw = both(WHERES["eq"][0])
    for p in ((3,), (1.5,), (3.0,)):
        _, jres = JT.select(jsch, js, jw, p, touch=False)
        _, tres = TT.select(tsch, ts, tw, p, touch=False)
        same_select(jres, tres)


def test_lru_eviction_with_tied_stamps():
    """A full table whose rows share one _accessed stamp: eviction must
    take the lowest row ids first, like the reference's top_k. (Every
    test here uses capacity 192, so the reference's compiled ops are
    shared between tests.)"""
    jsch, tsch = schemas(max_select=16)
    js, ts = JT.init_state(jsch), TT.init_state(tsch, "cpu")
    rng = np.random.default_rng(0)
    js, ts = insert_both(jsch, tsch, js, ts, rng, 192)      # one stamp
    js, ts = insert_both(jsch, tsch, js, ts, rng, 8)        # evicts 8
    same_state(js, ts)
    jw, tw = both(WHERES["eq"][0])
    js, _ = JT.select(jsch, js, jw, (2,))                   # touch a few
    ts, _ = TT.select(tsch, ts, tw, (2,))
    js, ts = insert_both(jsch, tsch, js, ts, rng, 24)
    same_state(js, ts)


def test_bulk_insert_stale_index_and_fallback():
    jsch, tsch = schemas(max_select=192)
    js, ts = JT.init_state(jsch), TT.init_state(tsch, "cpu")
    n = 150  # one key past the bucket's 128 lanes -> stale
    k = np.full(n, 7, np.int32)
    w = np.arange(n, dtype=np.int32)
    js, _, _ = JT.insert(jsch, js, {"k": jnp.asarray(k), "w": jnp.asarray(w)})
    ts, _, _ = TT.insert(tsch, ts, {"k": torch.from_numpy(k),
                                    "w": torch.from_numpy(w)})
    assert int(ts["indexes"]["k"]["stale"]) > 0
    same_state(js, ts)
    jw, tw = both(WHERES["eq"][0])
    _, jres = JT.select(jsch, js, jw, (7,), touch=False)
    _, tres = TT.select(tsch, ts, tw, (7,), touch=False)
    same_select(jres, tres)
    assert int(tres["count"]) == n
    js, jn = JT.delete(jsch, js, jw, (7,))
    ts, tn = TT.delete(tsch, ts, tw, (7,))
    assert int(jn) == int(tn) == n
    same_state(JT.build_index(jsch, js), TT.build_index(tsch, ts))


def test_int32_sum_wraps_like_the_reference():
    jsch, tsch = schemas(indexes=())
    js, ts = JT.init_state(jsch), TT.init_state(tsch, "cpu")
    w = np.full(10, 2**31 - 5, np.int32)
    js, _, _ = JT.insert(jsch, js, {"w": jnp.asarray(w)})
    ts, _, _ = TT.insert(tsch, ts, {"w": torch.from_numpy(w)})
    jv = JT.aggregate(jsch, js, "SUM", "w", None)[1]
    tv = TT.aggregate(tsch, ts, "SUM", "w", None)[1]
    assert int(jv) == int(tv) and tv.dtype == torch.int32


def test_max_rows_expiry_and_order_by():
    jsch, tsch = schemas(max_select=16, indexes=(), max_rows=10)
    js, ts = JT.init_state(jsch), TT.init_state(tsch, "cpu")
    rng = np.random.default_rng(9)
    for m in (8, 8, 8):
        js, ts = insert_both(jsch, tsch, js, ts, rng, m)
    js, jn = JT.expire(jsch, js)
    ts, tn = TT.expire(tsch, ts)
    assert int(jn) == int(tn) == 14
    same_state(js, ts)
    for col, desc in (("w", False), ("w", True), ("f", False), ("f", True)):
        _, jres = JT.select(jsch, js, None, (), order_by=col,
                            descending=desc, limit=5, touch=False)
        _, tres = TT.select(tsch, ts, None, (), order_by=col,
                            descending=desc, limit=5, touch=False)
        same_select(jres, tres)


def test_delete_many_eq_matches():
    jsch, tsch, js, ts = random_states(0)
    for w in (3, 20):
        vals = np.random.default_rng(w).integers(0, 9, w).astype(np.int32)
        act = np.arange(w) < w - 1
        for per in (False, True):
            jo = JT.delete_many_eq(jsch, js, "k", jnp.asarray(vals),
                                   jnp.asarray(act), per_statement=per)
            to = TT.delete_many_eq(tsch, ts, "k", torch.from_numpy(vals),
                                   torch.from_numpy(act), per_statement=per)
            same_state(jo[0], to[0])
            for a, b in zip(jo[1:], to[1:]):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
