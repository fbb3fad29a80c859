"""The port's checkpoint store (``repro_torch.checkpoint.store``) against
the reference's (``repro.checkpoint.store``): the same on-disk format, so
a tree saved by either package restores through the other with equal
keys, dtypes and values. Every comparison is exact (values are only
copied; bfloat16 leaves travel as float32 and are cast back)."""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as JCK
from repro_torch.checkpoint import store as TCK


def tree_np(seed=0):
    """A nested dict in the shape of a table state and of model weights:
    int32, bool, float32 and bfloat16 leaves, 0-d leaves, an empty dict."""
    rng = np.random.default_rng(seed)
    return {
        "cols": {"k": rng.integers(-2**31, 2**31 - 1, 37).astype(np.int32),
                 "v": rng.random(37).astype(np.float32)},
        "valid": rng.random(37) < 0.5,
        "clock": np.asarray(7, np.int32),
        "indexes": {"k": {"rid": rng.integers(-1, 37, (4, 128))
                          .astype(np.int32),
                          "stale": np.asarray(3, np.int32)}},
        "payloads": {},
        "w": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
    }


def to_torch(t):
    if isinstance(t, dict):
        return {k: to_torch(v) for k, v in t.items()}
    if t.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(t.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(t))


def to_jax(t):
    if isinstance(t, dict):
        return {k: to_jax(v) for k, v in t.items()}
    return jnp.asarray(t)


def assert_same(got, want, path=""):
    """``got`` (tensors) equals ``want`` (numpy / jax): keys, dtypes,
    shapes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    if want.dtype == ml_dtypes.bfloat16:
        assert got.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))
        return
    assert got.dtype == torch.from_numpy(want).dtype, path
    np.testing.assert_array_equal(got.numpy(), want)


def test_round_trip_every_dtype(tmp_path):
    t = to_torch(tree_np())
    final = TCK.save(tmp_path, 3, t, meta={"note": "x"})
    assert final == tmp_path / "step_3"
    like = {k: v for k, v in t.items()}
    got, info = TCK.restore(tmp_path, 3, like)
    assert_same(got, tree_np())
    assert info["step"] == 3 and info["meta"] == {"note": "x"}
    assert info["dtypes"]["w"] == "bfloat16"
    assert info["dtypes"]["valid"] == "bool"
    # leaves numbered in sorted key order; the empty dict has none
    keys = sorted(info["names"])
    assert keys == ["clock", "cols/k", "cols/v", "indexes/k/rid",
                    "indexes/k/stale", "valid", "w"]
    assert [info["names"][k] for k in keys] == [
        f"leaf_{i}.npy" for i in range(len(keys))]
    # a like tree on the meta device only gives shapes and dtypes
    meta_like = {k: (v if not isinstance(v, torch.Tensor)
                     else torch.empty_like(v, device="meta"))
                 for k, v in t.items()}
    meta_like["cols"] = {k: torch.empty_like(v, device="meta")
                         for k, v in t["cols"].items()}
    got, _ = TCK.restore(tmp_path, 3, meta_like, device="cpu")
    assert_same(got["cols"], tree_np()["cols"])


def test_restore_refuses_missing_and_reshaped_leaves(tmp_path):
    t = to_torch(tree_np())
    TCK.save(tmp_path, 0, t)
    with pytest.raises(KeyError):
        TCK.restore(tmp_path, 0, dict(t, extra=torch.zeros(2)))
    with pytest.raises(ValueError, match="cols/k"):
        TCK.restore(tmp_path, 0, dict(t, cols=dict(
            t["cols"], k=torch.zeros(36, dtype=torch.int32))))
    with pytest.raises(FileNotFoundError):
        TCK.restore(tmp_path, 1, t)


def test_latest_step_ignores_tmp(tmp_path):
    assert TCK.latest_step(tmp_path / "none") is None
    assert TCK.latest_step(tmp_path) is None
    t = {"a": torch.arange(4, dtype=torch.int32)}
    for step in (1, 5, 3):
        TCK.save(tmp_path, step, t)
    (tmp_path / "step_9.tmp").mkdir()   # a write cut off mid-way
    assert TCK.latest_step(tmp_path) == 5 == JCK.latest_step(tmp_path)


def test_async_checkpointer_keeps_last_steps(tmp_path):
    ck = TCK.AsyncCheckpointer(tmp_path, keep=2)
    t = {"a": torch.arange(6, dtype=torch.int32),
         "b": {"c": torch.ones(2, dtype=torch.bfloat16)}}
    for step in range(5):
        ck.save_async(step, t, meta={"step": step})
        t["a"] += 1   # the snapshot was taken on the caller's thread
    ck.wait()
    assert ck.saved_steps == [0, 1, 2, 3, 4]
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_3", "step_4"]
    got, info = TCK.restore(tmp_path, 4, t)
    np.testing.assert_array_equal(got["a"].numpy(), np.arange(6) + 4)
    assert got["b"]["c"].dtype == torch.bfloat16 and info["meta"]["step"] == 4


def test_async_checkpointer_raises_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = TCK.AsyncCheckpointer(blocker)
    ck.save_async(0, {"a": torch.zeros(1)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()   # the failure is raised once


def test_host_copy_shares_no_memory():
    t = {"a": torch.arange(5, dtype=torch.int32), "b": {"c": torch.ones(3)}}
    h = TCK.host_copy(t)
    t["a"] += 10
    np.testing.assert_array_equal(h["a"].numpy(), np.arange(5))
    assert h["b"]["c"].dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_checkpoint_restores_in_port(tmp_path, seed):
    want = tree_np(seed)
    JCK.save(tmp_path, 2, to_jax(want), meta={"shards": 4})
    got, info = TCK.restore(tmp_path, 2, to_torch(tree_np(seed + 7)))
    assert_same(got, want)
    assert info["meta"] == {"shards": 4}


@pytest.mark.parametrize("seed", [0, 1])
def test_port_checkpoint_restores_in_reference(tmp_path, seed):
    want = tree_np(seed)
    TCK.save(tmp_path / "port", 2, to_torch(want), meta={"shards": 4})
    JCK.save(tmp_path / "ref", 2, to_jax(want), meta={"shards": 4})
    # the two packages write the same meta.json and the same arrays
    metas = [json.loads((tmp_path / d / "step_2" / "meta.json").read_text())
             for d in ("port", "ref")]
    assert metas[0] == metas[1]
    for name in metas[0]["names"].values():
        a, b = (np.load(tmp_path / d / "step_2" / name)
                for d in ("port", "ref"))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    got, info = JCK.restore(tmp_path / "port", 2, to_jax(tree_np(seed + 7)))
    assert_same(to_torch(jax.tree.map(np.asarray, got)), want)
    assert info["meta"] == {"shards": 4}
