"""The port's ``core/baseline.MemcachedLike`` against the reference's: a
seeded stream of get / gets / set (with and without a TTL) / delete /
incr / decr / cas / flush_all, both caches on one patched monotonic
clock that the stream advances, gives equal results operation by
operation, and equal sizes."""
import numpy as np
import pytest

from repro.core import baseline as JB
from repro_torch.core import baseline as TB

OPS = ("get", "gets", "set", "set_ttl", "delete", "incr", "decr", "cas",
       "flush_all", "tick")


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_memcached_like_matches_the_reference(monkeypatch, seed):
    clock = Clock()
    monkeypatch.setattr(JB.time, "monotonic", clock)
    monkeypatch.setattr(TB.time, "monotonic", clock)
    ref, port = JB.MemcachedLike(), TB.MemcachedLike()
    rng = np.random.default_rng(seed)
    p = np.array([12, 4, 12, 6, 5, 5, 3, 4, 1, 4], float)
    tokens = {}
    for _ in range(2000):
        op = OPS[rng.choice(len(OPS), p=p / p.sum())]
        key = f"k{int(rng.integers(0, 24))}"
        val = (int(rng.integers(-50, 50)) if rng.random() < 0.6
               else f"v{int(rng.integers(0, 1000))}")
        if op == "tick":
            clock.t += float(rng.exponential(2.0))
            continue
        if op == "set_ttl":
            ttl = float(rng.uniform(0.5, 6.0))
            got = [c.set(key, val, ttl) for c in (ref, port)]
        elif op == "set":
            got = [c.set(key, val) for c in (ref, port)]
        elif op in ("incr", "decr"):
            d = int(rng.integers(1, 5))
            got = [getattr(c, op)(key, d) for c in (ref, port)]
        elif op == "cas":
            # a token seen by gets, or a stale one
            tok = tokens.get(key, -1) + int(rng.random() < 0.3)
            got = [c.cas(key, val, tok) for c in (ref, port)]
        elif op == "gets":
            got = [c.gets(key) for c in (ref, port)]
            tokens[key] = got[0][1]
        elif op == "flush_all":
            got = [c.flush_all() for c in (ref, port)]
        else:
            got = [getattr(c, op)(key) for c in (ref, port)]
        assert got[0] == got[1], (op, key, got)
        assert len(ref) == len(port)
