"""Device meshes (port of ``repro.launch.mesh``): the cache daemon's lane
mesh, and the model stack's named meshes (the debug mesh and the
production mesh's plan).

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

A :class:`Mesh` is a named grid of ``torch.device`` entries driven by one
process (the counterpart of ``jax.sharding.Mesh``): ``axis_names``,
``shape`` (name -> size, as the reference's ``mesh.shape``), ``devices``
(a numpy object array of that shape) and ``home``, its first entry. The
mesh code of the serving step (``serving/paged.py``) and of the
sequence-parallel attention runs each coordinate's work on that
coordinate's entry and everything else on ``home``.
:func:`make_debug_mesh` builds one over the visible devices (repeating the
card or the CPU, as :func:`make_lane_mesh` does); :func:`make_production_mesh`
gives the reference's production axes and shape over the ``meta`` device:
a plan for shapes and specs. A step over a plan runs only inside
:func:`walking` (``launch/dryrun.py``'s scope: meta tensors, nothing
launched); anywhere else it raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import numpy as np
import torch

# the reference's mesh axis name of the lane mesh (its 1-D jax mesh); the
# port's lane mesh is a plain tuple and never reads it
LANE_AXIS = "lane"

_forced: list = []   # the device count a force_device_count scope set
_walks: list = []    # open walking() scopes


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
    return tuple(_grid(n_devices, home))


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


# ---------------------------------------------------------- named meshes
@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of devices driven by one process. ``devices`` is a
    numpy object array whose shape is the mesh's (one axis a name)."""

    axis_names: tuple
    devices: np.ndarray

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d device grid")

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order (the reference's mesh.shape)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def home(self) -> torch.device:
        """The first entry: where the unsharded work runs and the
        coordinates' partials meet."""
        return self.devices.flat[0]

    @property
    def is_plan(self) -> bool:
        """A mesh over the ``meta`` device: shapes and specs only."""
        return self.home.type == "meta"

    def device_at(self, coord: dict) -> torch.device:
        """The entry at ``coord`` ({axis name: index}; an axis left out is
        index 0)."""
        return self.devices[tuple(int(coord.get(a, 0))
                                  for a in self.axis_names)]

    def coords(self):
        """Every coordinate as {axis name: index}, in row-major order."""
        for idx in np.ndindex(*self.devices.shape):
            yield dict(zip(self.axis_names, idx))

    def sub(self, axis: str, i: int) -> "Mesh":
        """The mesh of the entries at index ``i`` of ``axis``, without that
        axis (e.g. one pod's ``(data, model)`` mesh)."""
        pos = self.axis_names.index(axis)
        return Mesh(tuple(a for a in self.axis_names if a != axis),
                    np.take(self.devices, i, axis=pos))

    def require_runnable(self, what: str) -> None:
        """Raise where ``what`` would run on a plan-only mesh outside a dry
        run's :func:`walking` scope."""
        if self.is_plan and not _walks:
            raise RuntimeError(
                f"{what}: the mesh {self.shape} is a plan over the meta "
                f"device (make_production_mesh); run steps over "
                f"make_debug_mesh, or walk them in a dry run "
                f"(launch/dryrun.walking)")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, home={self.home})"


@contextlib.contextmanager
def walking():
    """The dry run's scope: steps over a plan mesh (``meta`` entries) run
    inside it, on meta tensors, launching nothing."""
    _walks.append(True)
    try:
        yield
    finally:
        _walks.pop()


def is_walking() -> bool:
    """Whether this process is inside a :func:`walking` scope."""
    return bool(_walks)


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is None or a :class:`Mesh` (the model stack's
    mesh entry points take nothing else)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"a mesh must be a repro_torch.launch.mesh.Mesh, "
                        f"not {type(mesh).__name__}")


def _grid(n: int, home: torch.device) -> list:
    """``n`` entries from ``home`` on: the next cards in index order
    (wrapping, and repeating when there are fewer cards than entries), or
    the CPU (or ``meta``) repeated."""
    if home.type != "cuda":
        return [home] * n
    cards = max(torch.cuda.device_count(), 1)
    base = home.index or 0
    return [torch.device("cuda", (base + i) % cards) for i in range(n)]


def _named(shape: tuple, axes: tuple, home: torch.device) -> Mesh:
    grid = np.empty(math.prod(shape), dtype=object)
    grid[:] = _grid(len(grid), home)
    return Mesh(tuple(axes), grid.reshape(shape))


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, pods: int = 0,
                    device=None) -> Mesh:
    """The reference's small mesh, ``(data, model)`` or ``(pod, data,
    model)``, over the visible devices of ``device``'s type (None: the
    card). As the reference needs that many forced host devices, it needs
    :func:`visible_devices` to reach the product: raise it with
    :func:`force_device_count` to repeat the card or the CPU."""
    home = torch.device("cuda" if device is None else device)
    if home.type == "cuda" and home.index is None:
        home = torch.device("cuda", 0)
    shape = (pods, n_data, n_model) if pods else (n_data, n_model)
    axes = ("pod", "data", "model") if pods else ("data", "model")
    n = math.prod(shape)
    if home.type != "meta" and visible_devices(home.type) < n:
        raise RuntimeError(
            f"a {shape} mesh needs {n} devices of type {home.type}, "
            f"{visible_devices(home.type)} visible (force_device_count)")
    return _named(shape, axes, home)


def make_mesh(shape: tuple, axes: tuple, *, device=None) -> Mesh:
    """A mesh of any shape and axis names over ``device``'s entries
    (repeated as :func:`make_debug_mesh` repeats them), with the same
    device-count check: e.g. ``make_mesh((4,), ("model",))``."""
    home = torch.device("cuda" if device is None else device)
    if home.type == "cuda" and home.index is None:
        home = torch.device("cuda", 0)
    n = math.prod(shape)
    if home.type != "meta" and visible_devices(home.type) < n:
        raise RuntimeError(
            f"a {tuple(shape)} mesh needs {n} devices of type {home.type}, "
            f"{visible_devices(home.type)} visible (force_device_count)")
    return _named(tuple(shape), tuple(axes), home)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: 16x16 (``data``, ``model``) or
    2x16x16 (``pod``, ``data``, ``model``), over the ``meta`` device. It
    plans geometries and specs (``serving/paged.plan_geometry``,
    ``serving/engine.lower_serve_step``), and the dry run walks steps over
    it inside :func:`walking` (``launch/dryrun.py``); outside that scope a
    step over it raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _named(shape, axes, torch.device("meta"))
