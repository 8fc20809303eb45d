"""Multi-process initialization and the collectives the mesh needs.

The port of ``shapley_vit_tpu/parallel/distributed.py``: the reference's
``--dist-num/--dist-rank/--master-addr/--master-port`` flags (opts.py:22-25,
unused there) drive ``torch.distributed.init_process_group`` here, and the
mesh helpers span every rank's devices.

The backend is ``nccl`` when the port runs on the card and ``gloo`` on the
CPU. NCCL refuses two ranks on one GPU, so a multi-process world on one
host needs a card per rank: each rank sets its card
(``torch.cuda.set_device``), and a rank that names no ``devices`` lays its
cells on that card alone (:func:`default_local_devices`). The tests run two
ranks on the CPU over gloo.

One process (the common case) needs nothing: :func:`initialize_from_config`
does nothing for a world of one, and :func:`make_global_mesh` then lays the
mesh over the local devices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from shapley_vit_tpu_torch.config import DistConfig
from shapley_vit_tpu_torch.parallel.mesh import Mesh, local_devices, make_mesh


def initialize_from_config(dist: DistConfig, num_processes: Optional[int] = None,
                           device="cuda") -> bool:
    """Join the ``torch.distributed`` world the reference flags describe:
    ``tcp://master_addr:master_port``, world ``dist_num`` (or
    ``num_processes``), rank ``dist_rank``; ``nccl`` when ``device`` is a
    CUDA device, ``gloo`` otherwise. ``dist_num`` doubles as the process
    count (the reference used it as the party count; cross-silo parties and
    hosts coincide in its deployment). Returns True if it joined a world."""
    world = num_processes if num_processes is not None else dist.dist_num
    if world <= 1 or tdist.is_initialized():
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    tdist.init_process_group(
        backend,
        init_method=f"tcp://{dist.master_addr}:{dist.master_port}",
        world_size=world,
        rank=dist.dist_rank,
    )
    return True


def world_size() -> int:
    return tdist.get_world_size() if tdist.is_available() and tdist.is_initialized() else 1


def rank() -> int:
    return tdist.get_rank() if tdist.is_available() and tdist.is_initialized() else 0


def collective_device() -> torch.device:
    """The device the world's collectives take their tensors on: the current
    card under ``nccl``, the CPU under ``gloo``."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_host(array: np.ndarray, op: str = "sum") -> np.ndarray:
    """``array`` reduced over the world (``"sum"`` or ``"max"``), as a host
    array of the same dtype; the identity outside a world."""
    if not tdist.is_initialized():
        return array
    t = torch.from_numpy(np.ascontiguousarray(array)).to(collective_device())
    tdist.all_reduce(t, op=tdist.ReduceOp.SUM if op == "sum" else tdist.ReduceOp.MAX)
    return t.cpu().numpy()


def default_local_devices(device="cuda") -> List[torch.device]:
    """This rank's devices when the caller names none: every visible card
    of ``device``'s type (or the CPU) in one process; in a world of several
    ranks on the card, only the rank's current card, where its collectives
    run (a rank on every card would put two ranks on each GPU)."""
    if world_size() > 1 and torch.device(device).type == "cuda":
        return [torch.device("cuda", torch.cuda.current_device())]
    return local_devices(device)


def global_devices(local: Sequence) -> Tuple[List[torch.device], List[int]]:
    """Every rank's ``local`` devices, rank-major, with each one's rank (the
    local list alone outside a world)."""
    local = [str(torch.device(d)) for d in local]
    if not tdist.is_initialized():
        return [torch.device(d) for d in local], [0] * len(local)
    gathered: List[Optional[List[str]]] = [None] * tdist.get_world_size()
    tdist.all_gather_object(gathered, local)
    devices, ranks = [], []
    for r, devs in enumerate(gathered):
        devices += [torch.device(d) for d in devs]
        ranks += [r] * len(devs)
    return devices, ranks


def make_global_mesh(dist: DistConfig, n_coalition: int = 1,
                     local: Optional[Sequence] = None, device="cuda") -> Mesh:
    """``(coalition, data)`` mesh over the global device set: every rank's
    ``local`` devices (default: :func:`default_local_devices`) after
    :func:`initialize_from_config`, the local ones otherwise. ``dist`` is
    kept for the JAX signature; the world is the initialized one."""
    devices, ranks = global_devices(local if local is not None
                                    else default_local_devices(device))
    return make_mesh(n_coalition=n_coalition, devices=devices, ranks=ranks,
                     world=world_size(), rank=rank())


def process_info(local: Optional[Sequence] = None, device="cuda") -> dict:
    local = list(local) if local is not None else default_local_devices(device)
    return {
        "process_index": rank(),
        "process_count": world_size(),
        "local_devices": len(local),
        "global_devices": len(global_devices(local)[0]),
    }
