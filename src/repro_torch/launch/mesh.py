"""The cache daemon's placement mesh (port of ``repro.launch.mesh``, its
lane mesh; the production and debug meshes of the model stack are not
ported yet).

A lane mesh is an ordered tuple of ``torch.device``: ``core/shards.py``
places a sharded table's stack over it in contiguous blocks, one block a
device, and the mesh's first entry is the home device where a fan-out's
partials merge. The number of devices a mesh may use comes from one
function, :func:`visible_devices` (``torch.cuda.device_count()`` for the
card, 1 for the CPU), which tests and a one-card run may raise with
:func:`force_device_count`, as the reference's tests force host devices:
a mesh then lists more entries than there are cards, and an entry
repeats a card (``cuda:0, cuda:0``) or the CPU. Placement code runs in
full either way; only ordering between two physical cards needs more
than one.
"""
from __future__ import annotations

import contextlib
import functools

import torch

# the reference's mesh axis name; nothing in the port reads it until the
# model stack's meshes come (ROADMAP Queue 1 item 5)
LANE_AXIS = "lane"

_forced: list = []   # the device count a force_device_count scope set


def visible_devices(device_type: str) -> int:
    """How many devices of ``device_type`` a lane mesh may use: the forced
    count inside :func:`force_device_count`, else the cards present (CUDA)
    or 1 (the CPU)."""
    if _forced:
        return _forced[-1]
    if device_type == "cuda":
        return torch.cuda.device_count()
    return 1


@contextlib.contextmanager
def force_device_count(n: int):
    """Make :func:`visible_devices` report ``n`` inside the scope (the
    daemon reads it when it places a table: at CREATE, RESHARD and
    RESTORE)."""
    _forced.append(int(n))
    try:
        yield
    finally:
        _forced.pop()


@functools.lru_cache(maxsize=None)
def make_lane_mesh(n_devices: int, home: torch.device) -> tuple:
    """1-D lane mesh of ``n_devices`` entries starting at ``home``: the
    next cards in index order (wrapping, and repeating when there are
    fewer cards than entries), or the CPU repeated. Cached, so every
    table of one device count shares one mesh object."""
    if home.type != "cuda":
        return (home,) * n_devices
    cards = max(torch.cuda.device_count(), 1)
    base = home.index or 0
    return tuple(torch.device("cuda", (base + i) % cards)
                 for i in range(n_devices))


def lane_mesh_for(n_shards: int, n_devices: int | None = None, *,
                  home: torch.device | str = "cuda"):
    """The placement mesh of an ``n_shards``-way table, or None when
    placement is pointless (one device would hold every lane).

    Policy: ``d`` devices, where ``d`` is the largest divisor of
    ``n_shards`` with ``d <= min(n_shards, devices)``: each device then
    owns a contiguous block of ``n_shards // d`` lanes. ``n_devices``
    defaults to :func:`visible_devices` of ``home``'s type."""
    home = torch.device(home)
    if home.type == "cuda" and home.index is None:
        home = torch.device("cuda", 0)
    if n_devices is None:
        n_devices = visible_devices(home.type)
    lim = min(int(n_shards), int(n_devices))
    d = max((k for k in range(1, lim + 1) if n_shards % k == 0), default=1)
    return make_lane_mesh(d, home) if d > 1 else None
