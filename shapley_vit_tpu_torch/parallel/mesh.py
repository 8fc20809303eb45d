"""The ``(coalition, data)`` device grid and its placement helpers.

The port of ``shapley_vit_tpu/parallel/mesh.py``. The workload has two scale
axes: the *coalition* axis (up to 2^N stacked model variants) and the *data*
axis (the validation batch). A :class:`Mesh` lays devices out on a 2-D grid
with those axis names:

  * stacked coalition trees split their leading axis over ``coalition``;
  * image/label batches split their leading axis over ``data``;
  * the frozen ViT base is replicated, once per distinct device.

PyTorch has no sharded array, so a placement returns the per-cell pieces: a
dict from each of this process's cells ``(c, d)`` to the tensor (or tree)
that cell works on, on that cell's device. Cells that share a device share
one copy.

A device may repeat in the grid. Torch has one CPU device, so the tests
build 2×4 or 2×2 grids from ``"cpu"`` (the JAX tests use
``--xla_force_host_platform_device_count=8`` for the same purpose), and a
grid of ``cuda:0`` repeated measures the sharding's overhead on one card.

In a multi-process world (``parallel.distributed``) a mesh spans every
rank's devices; each cell records its owner rank, and a process places and
evaluates only its own cells.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from shapley_vit_tpu_torch.ops.tree_math import tree_leaves, tree_map, tree_nbytes
from shapley_vit_tpu_torch.utils import profiling

Tree = Any
Cell = Tuple[int, int]

COALITION_AXIS = "coalition"
DATA_AXIS = "data"


def local_devices(kind: str = "cuda") -> List[torch.device]:
    """This process's devices of ``kind``: every visible CUDA device, or the
    one CPU device."""
    if torch.device(kind).type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class Mesh:
    """A 2-D grid of devices with axes ``(coalition, data)``.

    ``devices`` is an object array ``[n_coalition, n_data]`` of
    ``torch.device``; ``ranks`` the owner rank of each cell (all this
    process's by default); ``world`` the size of the ``torch.distributed``
    world the grid spans (1 for a grid of local devices)."""

    axis_names = (COALITION_AXIS, DATA_AXIS)

    def __init__(self, devices: np.ndarray, ranks: Optional[np.ndarray] = None,
                 world: int = 1, rank: int = 0):
        self.devices = devices
        self.ranks = ranks if ranks is not None else np.full(devices.shape, rank, np.int64)
        self.world = world
        self.rank = rank

    @property
    def shape(self) -> Dict[str, int]:
        return {COALITION_AXIS: self.devices.shape[0], DATA_AXIS: self.devices.shape[1]}

    def local_cells(self) -> List[Cell]:
        """This process's cells, coalition-major."""
        n_c, n_d = self.devices.shape
        return [(c, d) for c in range(n_c) for d in range(n_d) if self.ranks[c, d] == self.rank]

    def device(self, cell: Cell) -> torch.device:
        return self.devices[cell]


def make_mesh(
    n_coalition: int = 1,
    n_data: Optional[int] = None,
    devices: Optional[Sequence] = None,
    ranks: Optional[Sequence[int]] = None,
    world: int = 1,
    rank: int = 0,
) -> Mesh:
    """Build a ``(coalition, data)`` mesh over ``devices`` (default: every
    visible CUDA device). A device may repeat (see the module docstring).

    ``n_data`` defaults to ``len(devices) // n_coalition``. ``ranks`` gives
    each device's owner rank in a multi-process ``world`` (this process is
    ``rank``); ``parallel.distributed.make_global_mesh`` fills them."""
    devices = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    if not devices:
        raise ValueError("no devices to build a mesh over")
    if n_data is None:
        if len(devices) % n_coalition:
            raise ValueError(
                f"{len(devices)} devices not divisible by coalition axis {n_coalition}"
            )
        n_data = len(devices) // n_coalition
    if n_coalition * n_data > len(devices):
        raise ValueError(
            f"mesh {n_coalition}x{n_data} needs more than {len(devices)} devices"
        )
    k = n_coalition * n_data
    grid = np.empty(k, dtype=object)
    grid[:] = devices[:k]
    owners = None
    if ranks is not None:
        owners = np.asarray(list(ranks)[:k], np.int64).reshape(n_coalition, n_data)
    return Mesh(grid.reshape(n_coalition, n_data), owners, world=world, rank=rank)


@dataclass(frozen=True)
class Sharding:
    """Where a tree goes on a mesh: split over ``axis`` (``"coalition"`` or
    ``"data"``), or replicated (``axis`` None)."""

    mesh: Mesh
    axis: Optional[str] = None


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(mesh: Mesh) -> Sharding:
    """Leading batch dim over the data axis."""
    return Sharding(mesh, DATA_AXIS)


def shard_coalitions(mesh: Mesh) -> Sharding:
    """Leading coalition dim over the coalition axis."""
    return Sharding(mesh, COALITION_AXIS)


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is, or a host array as a tensor (no copy)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def device_put(tree: Tree, sharding: Sharding) -> Dict[Cell, Tree]:
    """Each of this process's cells -> its piece of ``tree`` on its device:
    the ``i``-th of ``n`` equal slices of every leaf's leading axis (``i``
    the cell's index along ``sharding.axis``), or the whole tree. Cells with
    the same piece and device share one copy; a piece already on its device
    is not copied."""
    mesh = sharding.mesh
    axis = sharding.axis
    n = mesh.shape[axis] if axis is not None else 1
    if axis is not None:
        for leaf in tree_leaves(tree):
            if as_tensor(leaf).shape[0] % n:
                raise ValueError(
                    f"leading dim {as_tensor(leaf).shape[0]} does not split over "
                    f"{axis} axis of size {n}"
                )
    pieces: Dict[Tuple[int, torch.device], Tree] = {}
    out: Dict[Cell, Tree] = {}
    for cell in mesh.local_cells():
        i = 0 if axis is None else cell[0 if axis == COALITION_AXIS else 1]
        dev = mesh.device(cell)
        key = (i, dev)
        if key not in pieces:
            def place(leaf, i=i, dev=dev):
                t = as_tensor(leaf)
                if axis is not None:
                    k = t.shape[0] // n
                    t = t[i * k:(i + 1) * k]
                return t.to(dev)
            pieces[key] = tree_map(place, tree)
        out[cell] = pieces[key]
    return out


def put_batch(mesh: Mesh, images, labels) -> Tuple[Dict[Cell, torch.Tensor], Dict[Cell, torch.Tensor]]:
    """A validation batch split over the data axis (one upload; reused for
    every coalition and round)."""
    s = shard_batch(mesh)
    return device_put(images, s), device_put(labels, s)


def put_replicated(mesh: Mesh, tree: Tree) -> Dict[Cell, Tree]:
    return device_put(tree, replicated(mesh))


def put_coalition_stacked(mesh: Mesh, tree: Tree) -> Dict[Cell, Tree]:
    """``tree`` split over the coalition axis. While the program's spans
    record, counts ``eval.place_bytes``: the bytes of each distinct piece
    laid out, once per (piece, device), copied or already there."""
    out = device_put(tree, shard_coalitions(mesh))
    if profiling.recording():
        pieces = {id(p): p for p in out.values()}
        profiling.count("eval.place_bytes", sum(tree_nbytes(p) for p in pieces.values()))
    return out
