"""Checkpointing over nested dicts of tensors (port of
``repro.checkpoint.store``): atomic, asynchronous, in the reference's
on-disk format, so a snapshot written by either package restores in the
other.

- **Atomic**: a step is written to ``step_<n>.tmp/`` and renamed to
  ``step_<n>/``, so a crash mid-write never leaves a half-written latest
  step.
- **Async**: :class:`AsyncCheckpointer` copies the tree to host memory on
  the caller's thread and writes it on a background thread.
- **Format**: one ``leaf_<i>.npy`` per leaf and a ``meta.json`` holding
  ``step``, ``names`` (leaf key -> file), ``dtypes`` (leaf key -> numpy
  dtype name) and the caller's ``meta``. A leaf's key is its dict path
  joined by ``/`` (``cols/page_id``, ``indexes/page_id/rid``, ``valid``),
  the names ``jax.tree_util.tree_flatten_with_path`` gives, with a list or
  plain tuple entry by its index and a NamedTuple field (the optimizer's
  ``AdamWState``) as ``.<field>``: ``opt/.mu/embed``, ``opt/.count``;
  leaves are numbered in sorted key order. An empty dict has no leaves.
  bfloat16 is stored as float32 with ``"bfloat16"`` in ``dtypes`` and
  restored to the dtype of the ``like`` tree's leaf.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree):
    """(path entry, child) pairs of a container: a dict's keys, a
    NamedTuple's ``.<field>``, a list's or tuple's index."""
    if isinstance(tree, dict):
        return list(tree.items())
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    return list(enumerate(tree))


def _flatten(tree, path: tuple = ()) -> dict[str, Any]:
    """``{key: leaf}`` of a nested dict / NamedTuple / list / tuple; None
    and empty containers have no leaves."""
    if isinstance(tree, (dict, list, tuple)):
        out = {}
        for k, v in _children(tree):
            out.update(_flatten(v, path + (k,)))
        return out
    if tree is None:
        return {}
    return {"/".join(str(p) for p in path): tree}


def _rebuild(tree, fn: Callable[[str, Any], Any], path: tuple = ()):
    """``tree``'s structure with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(tree, (dict, list, tuple)):
        kids = [_rebuild(v, fn, path + (k,)) for k, v in _children(tree)]
        if isinstance(tree, dict):
            return dict(zip(tree, kids))
        if _is_namedtuple(tree):
            return type(tree)(*kids)
        return type(tree)(kids)
    if tree is None:
        return None
    return fn("/".join(str(p) for p in path), tree)


def _host(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name to record) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.float().numpy(), "bfloat16"
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":   # ml_dtypes' bfloat16 from JAX
        return arr.astype(np.float32), "bfloat16"
    return arr, str(arr.dtype)


def save(path: str | os.PathLike, step: int, tree, meta: dict | None = None):
    """Synchronous atomic save of ``tree``; returns the step's directory."""
    root = pathlib.Path(path)
    final = root / f"step_{step}"
    tmp = root / f"step_{step}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    names, dtypes = {}, {}
    for i, (key, leaf) in enumerate(sorted(_flatten(tree).items())):
        arr, dtypes[key] = _host(leaf)
        np.save(tmp / f"leaf_{i}.npy", arr)
        names[key] = f"leaf_{i}.npy"
    (tmp / "meta.json").write_text(json.dumps(
        {"step": step, "names": names, "dtypes": dtypes,
         "meta": meta or {}}))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _steps(root: pathlib.Path) -> list[int]:
    return [int(p.name.split("_")[1]) for p in root.glob("step_*")
            if not p.name.endswith(".tmp")]


def latest_step(path: str | os.PathLike) -> int | None:
    """The newest complete step under ``path`` (``*.tmp`` is ignored)."""
    root = pathlib.Path(path)
    if not root.exists():
        return None
    steps = _steps(root)
    return max(steps) if steps else None


def restore(path: str | os.PathLike, step: int, like, device=None):
    """Load step ``step`` into the structure of ``like`` (a nested dict of
    tensors: only its keys, shapes and dtypes are read; ``device="meta"``
    tensors do). Each leaf lands on ``device`` (default: the like leaf's
    device) in the like leaf's dtype. Returns ``(tree, info)``, ``info``
    being the parsed ``meta.json``. Raises ``FileNotFoundError`` for a
    missing step, ``KeyError`` for a leaf the step does not hold and
    ``ValueError`` for a leaf of another shape."""
    root = pathlib.Path(path) / f"step_{step}"
    info = json.loads((root / "meta.json").read_text())
    names = info["names"]

    def load(key: str, like_leaf: torch.Tensor) -> torch.Tensor:
        arr = np.load(root / names[key])
        if tuple(arr.shape) != tuple(like_leaf.shape):
            raise ValueError(f"leaf {key!r} is {tuple(arr.shape)} in the "
                             f"checkpoint, {tuple(like_leaf.shape)} here")
        dev = like_leaf.device if device is None else device
        return torch.from_numpy(arr).to(device=dev, dtype=like_leaf.dtype)

    return _rebuild(like, load), info


CHUNK_BYTES = 1 << 30


def host_copy(tree):
    """``tree`` with every leaf copied to the host (it shares no memory
    with ``tree``). The tensors of each card travel in few device-to-host
    copies: their bytes are concatenated on the card into runs of at most
    ``CHUNK_BYTES`` first (a table's state is one run, one copy), and a
    leaf larger than that travels alone. So the card holds at most
    ``CHUNK_BYTES`` more than the tree while it copies, even for a
    training state as large as the card allows."""
    chunk_bytes = CHUNK_BYTES
    flat = _flatten(tree)
    out: dict[str, Any] = {}
    runs: list[list[str]] = []
    open_run: dict[torch.device, tuple[list[str], int]] = {}
    for k, x in flat.items():
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            n = x.numel() * x.element_size()
            if n > chunk_bytes:
                out[k] = x.detach().cpu()
                continue
            keys, size = open_run.get(x.device, (None, 0))
            if keys is None or size + n > chunk_bytes:
                keys, size = [], 0
                runs.append(keys)
            keys.append(k)
            open_run[x.device] = (keys, size + n)
        elif isinstance(x, torch.Tensor):
            out[k] = x.detach().clone()
        else:
            out[k] = np.array(x, copy=True)
    for keys in runs:
        buf = torch.cat([flat[k].detach().contiguous().reshape(-1)
                         .view(torch.uint8) for k in keys]).cpu()
        off = 0
        for k in keys:
            x = flat[k]
            n = x.numel() * x.element_size()
            # the clone realigns the slice for the dtype view
            out[k] = buf[off:off + n].clone().view(x.dtype).reshape(x.shape)
            off += n
    return _rebuild(tree, lambda k, _: out[k])


class AsyncCheckpointer:
    """Copy to host on the caller's thread, write on a background thread,
    keep the newest ``keep`` steps. One write is in flight at a time; a
    write's failure is raised by the next :meth:`wait` or
    :meth:`save_async`."""

    def __init__(self, path: str | os.PathLike, keep: int = 3):
        self.path = pathlib.Path(path)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.saved_steps: list[int] = []

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def save_async(self, step: int, tree, meta: dict | None = None) -> None:
        self.wait()
        snapshot = host_copy(tree)

        def work():
            try:
                save(self.path, step, snapshot, meta)
                self.saved_steps.append(step)
                self._gc()
            except Exception as e:  # noqa: BLE001 — raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True,
                                        name=f"checkpoint-{step}")
        self._thread.start()

    def _gc(self) -> None:
        for s in sorted(_steps(self.path))[: -self.keep]:
            shutil.rmtree(self.path / f"step_{s}", ignore_errors=True)
