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

Model weights travel the same way: the reference's parameter tree (after
``repro.models.params.split``, every leaf through ``numpy.asarray``) has
the port's names and stacked layout, so :func:`params_from_numpy` is one
mapping and :func:`params_to_numpy` its inverse.
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
