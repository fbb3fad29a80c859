"""Carry table contents and model weights between the reference and the
port.

A table's data plays the part that weights play for a model: both daemons
start from the same contents when one's state is carried into the other.
The reference's ``SQLCached.table_state(name)`` returns a nested dict of
arrays (``cols`` / ``payloads`` / ``valid`` / ``clock`` / ``ops`` /
``indexes``); converted to numpy with ``numpy.asarray`` on each leaf, it
becomes a state of the port here, and the port's state goes back the
same way.

TEXT columns hold interner ids, so the strings must agree too:
:func:`copy_interner` replays one daemon's string table into another's.

A sharded table is more than its state: the reference keeps one state per
shard (``t.lanes``) and lazy-clock bookkeeping beside them (the ticks
applied to each lane, the expiries a lane still owes, the per-shard
counters), and the port one stacked state with the same bookkeeping.
:func:`table_snapshot` reads either daemon's table into numpy and
:func:`load_table` installs a snapshot into either, so both daemons start
from the same contents.

Model weights travel the same way: the reference's parameter tree (after
``repro.models.params.split``, every leaf through ``numpy.asarray``) has
the port's names and stacked layout (an MoE's ``[layers, e, ...]`` expert
leaves and router, an encoder-decoder's ``encoder`` subtree and each
decoder layer's ``norm_x`` and ``cross``), so :func:`params_from_numpy`
is one mapping and :func:`params_to_numpy` its inverse;
:func:`opt_from_numpy` and :func:`opt_to_numpy` do the same for the
optimizer's state (``AdamWState``: fp32 moments of the parameters' tree
and an int32 step count), so both packages can start training from the
same state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def state_from_numpy(state: Any, device) -> Any:
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (dtypes kept; the reference stores 32-bit widths)."""
    if isinstance(state, dict):
        return {k: state_from_numpy(v, device) for k, v in state.items()}
    arr = np.array(state, copy=True, order="C")  # keeps 0-d leaves 0-d
    return torch.from_numpy(arr).to(device)


def state_to_numpy(state: Any) -> Any:
    """Nested dict of tensors -> the same dict of numpy arrays."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    return state.detach().cpu().numpy()


_BOOKKEEPING = ("host_ops", "ticks_total", "lane_ticks", "expire_due",
                "stmt_routed", "writes_routed", "rows_in")


def _numpy(tree: Any) -> Any:
    """Nested dict of arrays (JAX's or the port's tensors) -> numpy."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.array(tree, copy=True)


def table_snapshot(t) -> dict:
    """One daemon's live table (the reference's or the port's ``_Table``)
    as numpy: ``lanes`` (one state a shard, raw: no catch-up applied) for
    a sharded table, else ``state``, plus the bookkeeping."""
    out = {k: (np.array(v, copy=True) if isinstance(v, np.ndarray)
               else (list(v) if isinstance(v, list) else v))
           for k in _BOOKKEEPING for v in (getattr(t, k),)}
    if t.lanes is None:
        out["state"] = _numpy(t.state)
    else:
        out["lanes"] = [_numpy(lane) for lane in t.lanes]
    return out


def load_table(db, name: str, snap: dict, array=None) -> None:
    """Install :func:`table_snapshot`'s ``snap`` into table ``name`` of
    ``db``, which must have the snapshot's schema. ``array`` is None for
    the port (the lanes are stacked and copied into the table's tensors)
    and the reference's array constructor (``jax.numpy.asarray``) for the
    reference daemon, whose lanes stay separate."""
    t = db.tables[name]
    if array is None:
        state = snap["state"] if "state" in snap else _stack(snap["lanes"])
        db.swap_table_state(name, state_from_numpy(state, db.device))
    elif "state" in snap:
        t.state = _map(array, snap["state"])
    else:
        t.lanes = [_map(array, lane) for lane in snap["lanes"]]
    with t.lock:
        for k in _BOOKKEEPING:
            v = snap[k]
            setattr(t, k, np.array(v, copy=True) if isinstance(v, np.ndarray)
                    else (list(v) if isinstance(v, list) else v))


def _stack(lanes: list) -> dict:
    if isinstance(lanes[0], dict):
        return {k: _stack([lane[k] for lane in lanes]) for k in lanes[0]}
    return np.stack(lanes)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def copy_interner(src, dst) -> None:
    """Intern ``src``'s strings into ``dst`` in id order, so that TEXT ids
    agree between the two daemons. ``dst`` must not yet hold a string at
    an id where ``src`` holds another one."""
    for i, s in enumerate(src._rev[1:], start=1):
        got = dst.intern(s)
        if got != i:
            raise ValueError(f"interner ids disagree: {s!r} is {i} in the "
                             f"source and {got} in the destination")


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; bfloat16 arrays (the ``ml_dtypes`` type numpy
    gets from JAX) travel as their 16-bit patterns."""
    arr = np.array(arr, copy=True, order="C")  # JAX's views are read-only
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(cfg, tree: Any, device) -> Any:
    """The reference's parameter tree (nested dict of numpy arrays) ->
    the port's parameters on ``device``: each leaf in the reference's own
    dtype, which is ``cfg.dtype`` except for the Mamba2 leaves the
    reference keeps in fp32 (``ssm.FP32_LEAVES``: ``A_log``, ``D``,
    ``dt_bias``)."""
    from repro_torch.models.layers.ssm import FP32_LEAVES
    from repro_torch.models.transformer import check_supported
    check_supported(cfg)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        dtype = torch.float32 if name in FP32_LEAVES else cfg.dtype
        return _tensor(np.asarray(node)).to(device=device, dtype=dtype)
    return walk(tree, "")


def params_to_numpy(params: Any) -> Any:
    """The port's parameters -> nested dict of float32 numpy arrays (the
    reference casts them to its config's dtype)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()


def opt_from_numpy(state, device):
    """The reference's ``AdamWState`` (leaves through ``numpy.asarray``) ->
    the port's ``AdamWState`` on ``device``: fp32 moments, int32 count."""
    from repro_torch.optim.adamw import AdamWState

    def f32(node):
        if isinstance(node, dict):
            return {k: f32(v) for k, v in node.items()}
        return _tensor(np.asarray(node)).to(device=device,
                                             dtype=torch.float32)
    return AdamWState(mu=f32(state.mu), nu=f32(state.nu),
                      count=torch.tensor(int(np.asarray(state.count)),
                                         dtype=torch.int32, device=device))


def opt_to_numpy(state):
    """The port's ``AdamWState`` -> (mu, nu, count) as numpy: fp32 moment
    trees and an int32 scalar, for the reference's ``AdamWState``."""
    return (params_to_numpy(state.mu), params_to_numpy(state.nu),
            np.asarray(state.count.detach().cpu().numpy(), dtype=np.int32))
