"""Memcached-like baseline (the port's own copy of
``repro.core.baseline``): the opaque key->blob cache the paper compares
against (§2.1). Values are serialized (pickle ≙ PHP serialize()); the only
operations are exact-key get/set/delete/incr/decr, CAS, and whole-set
flush, with an optional TTL read from ``time.monotonic``. It runs on the
host and touches no device: ``examples/torch_cms_cache_sim.py`` compares
the daemon against it.
"""
from __future__ import annotations

import pickle
import time
from typing import Any


class MemcachedLike:
    def __init__(self):
        self._store: dict[str, tuple[bytes, float, int]] = {}
        self._cas_counter = 0

    # -- memcached command set
    def set(self, key: str, value: Any, ttl: float = 0.0) -> None:
        self._cas_counter += 1
        exp = time.monotonic() + ttl if ttl > 0 else 0.0
        self._store[key] = (pickle.dumps(value), exp, self._cas_counter)

    def get(self, key: str) -> Any | None:
        ent = self._store.get(key)
        if ent is None:
            return None
        blob, exp, _ = ent
        if exp and time.monotonic() > exp:
            del self._store[key]
            return None
        return pickle.loads(blob)

    def gets(self, key: str) -> tuple[Any | None, int]:
        ent = self._store.get(key)
        if ent is None:
            return None, -1
        return pickle.loads(ent[0]), ent[2]

    def cas(self, key: str, value: Any, token: int) -> bool:
        ent = self._store.get(key)
        if ent is None or ent[2] != token:
            return False
        self.set(key, value)
        return True

    def delete(self, key: str) -> bool:
        return self._store.pop(key, None) is not None

    def incr(self, key: str, delta: int = 1) -> int | None:
        v = self.get(key)
        if not isinstance(v, int):
            return None
        v += delta
        self.set(key, v)
        return v

    def decr(self, key: str, delta: int = 1) -> int | None:
        return self.incr(key, -delta)

    def flush_all(self) -> int:
        n = len(self._store)
        self._store.clear()
        return n

    def __len__(self) -> int:
        return len(self._store)
