"""The clients' local LoRA steps sharded over the ``(coalition, data)`` mesh.

The port of the JAX package's sharded ``make_multi_client_train_step``
(``__graft_entry__.dryrun_multichip``: the stacked clients split over the
mesh's ``coalition`` axis, each client's batch over its ``data`` axis, the
frozen base replicated). PyTorch has no sharded array, so the layout is
explicit:

* row ``c`` of the mesh holds clients ``c·k .. c·k + k - 1`` (``k = n /
  n_coalition``); every cell of the row keeps its own trainable copy of the
  row's stacked overlay and its own optimizer over it
  (:class:`ShardedClients`), and takes its ``B / n_data`` slice of each
  client's batch;
* a cell computes ``sum(CE on its slice) / B`` for each of its clients and
  runs the backward; the row's gradients (and losses) are summed over the
  data axis, and every cell of the row applies that same sum, so the row's
  copies stay equal (the ``psum`` XLA puts in the JAX step);
* in a ``torch.distributed`` world (``parallel.distributed``, joined by the
  caller) each rank steps its own cells, and one ``all_reduce`` of the
  zero-filled ``[rows, gradient]`` buffer gives every rank each row's sum,
  with nccl or gloo alike (the evaluator's grid of partial sums does the
  same);
* labels are flipped per client on the whole batch before it is split, so
  one generator seed gives the same flips on every grid as on one device.

As under ``NamedSharding``, a client count that the coalition axis does
not divide, or a batch that the data axis does not divide, is refused.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as tdist
import torch.nn.functional as F

from shapley_vit_tpu_torch.fl.training import Optimizer, label_flip, trainable
from shapley_vit_tpu_torch.ops.tree_math import tree_leaves, tree_map
from shapley_vit_tpu_torch.parallel import distributed as pdist
from shapley_vit_tpu_torch.parallel.mesh import (
    COALITION_AXIS,
    DATA_AXIS,
    Cell,
    Mesh,
    as_tensor,
    put_replicated,
)

Tree = Any


def _clients_per_row(mesh: Mesh, n_clients: int) -> int:
    n_c = mesh.shape[COALITION_AXIS]
    if n_clients % n_c:
        raise ValueError(
            f"{n_clients} clients do not split over the coalition axis of size {n_c}"
        )
    return n_clients // n_c


def _in_world(mesh: Mesh) -> bool:
    return tdist.is_initialized() and mesh.world > 1 and mesh.world == pdist.world_size()


class ShardedClients:
    """The stacked overlays and optimizer states of ``n_clients`` clients
    laid on a mesh: for each of this process's cells, a trainable copy of
    its row's ``[k, ...]`` stacked overlay (``lora[cell]``) and a
    ``torch.optim`` optimizer over it (``opt[cell]``)."""

    def __init__(self, mesh: Mesh, lora: Dict[Cell, Tree], opt: Dict[Cell, Any],
                 n_clients: int):
        self.mesh = mesh
        self.lora = lora
        self.opt = opt
        self.n_clients = n_clients

    def stacked(self) -> Tree:
        """Every client's overlay as one ``[n, ...]`` tree on the CPU (each
        row read from its first cell; across ranks by an ``all_reduce`` of
        the zero-filled rows, so every rank gets them all)."""
        mesh, n_c = self.mesh, self.mesh.shape[COALITION_AXIS]
        owned = {c: (c, 0) for c in range(n_c) if (c, 0) in self.lora}
        if not _in_world(mesh):
            if len(owned) != n_c:
                raise ValueError("this process holds no cell of some coalition row")
            return tree_map(lambda *rows: torch.cat([r.detach().cpu() for r in rows]),
                            *(self.lora[owned[c]] for c in range(n_c)))
        like = next(iter(self.lora.values()))
        shapes: List[torch.Size] = []
        tree_map(lambda t: shapes.append(t.shape), like)
        buf = torch.zeros(n_c, sum(s.numel() for s in shapes), device=pdist.collective_device())
        for c, cell in owned.items():
            flat: List[torch.Tensor] = []
            tree_map(lambda t: flat.append(t.detach().reshape(-1)), self.lora[cell])
            buf[c] = torch.cat(flat).to(buf.device)
        tdist.all_reduce(buf)
        rows, out, off = buf.cpu(), [], 0
        for s in shapes:
            out.append(rows[:, off:off + s.numel()].reshape(n_c * s[0], *s[1:]))
            off += s.numel()
        it = iter(out)
        return tree_map(lambda _: next(it), like)


class ShardedMultiClientStep:
    """``make_multi_client_train_step`` sharded over ``mesh``.

    ``init(stacked_lora)`` lays the clients out;
    ``step(base, clients, images[n, B, ...], labels[n, B], generators) ->
    (clients, losses[n])`` takes one step of every client, the overlays
    updated in place; ``losses`` is a CPU tensor of each client's mean
    cross-entropy (all clients, on every rank). ``forward_fn(base, lora,
    images) -> logits`` is the single-client forward; the frozen base is
    placed once per distinct device and kept while the caller passes the
    same object."""

    def __init__(self, forward_fn, optimizer: Optimizer, num_classes: int, mesh: Mesh,
                 label_flip_prob: float = 0.0):
        if not isinstance(optimizer, Optimizer):
            raise TypeError("the sharded step takes adam() or sgd() (elementwise updates)")
        self.forward_fn = forward_fn
        self.optimizer = optimizer
        self.num_classes = num_classes
        self.mesh = mesh
        self.label_flip_prob = label_flip_prob
        self._base: Dict[str, Any] = {"obj": None, "rep": None}

    def init(self, stacked_lora: Tree) -> ShardedClients:
        """Lay ``stacked_lora`` (leaves ``[n, ...]``, host arrays or
        tensors) on the mesh: each of this process's cells gets a trainable
        copy of its row's clients on its device and ``optimizer.init`` of
        it."""
        n = int(as_tensor(tree_leaves(stacked_lora)[0]).shape[0])
        k = _clients_per_row(self.mesh, n)
        lora, opt = {}, {}
        for cell in self.mesh.local_cells():
            c, dev = cell[0], self.mesh.device(cell)
            lora[cell] = trainable(tree_map(lambda a: as_tensor(a)[c * k:(c + 1) * k].to(dev),
                                            stacked_lora))
            opt[cell] = self.optimizer.init(lora[cell])
        return ShardedClients(self.mesh, lora, opt, n)

    def _replicated(self, base: Tree) -> Dict[Cell, Tree]:
        if self._base["obj"] is not base:
            self._base = {"obj": base, "rep": put_replicated(self.mesh, base)}
        return self._base["rep"]

    def __call__(self, base: Tree, clients: ShardedClients, images, labels,
                 generators: Optional[List[torch.Generator]] = None):
        mesh = self.mesh
        n_c, n_d = mesh.shape[COALITION_AXIS], mesh.shape[DATA_AXIS]
        images, labels = as_tensor(images), as_tensor(labels)
        n, B = int(labels.shape[0]), int(labels.shape[1])
        if n != clients.n_clients:
            raise ValueError(f"{n} clients' batches for {clients.n_clients} clients")
        k = _clients_per_row(mesh, n)
        if B % n_d:
            raise ValueError(f"batch {B} does not split over the data axis of size {n_d}")
        b = B // n_d
        cells = mesh.local_cells()
        base_d = self._replicated(base)
        flipped = {j: label_flip(None if generators is None else generators[j], labels[j],
                                 self.num_classes, self.label_flip_prob)
                   for j in sorted({c * k + i for c, _ in cells for i in range(k)})}

        # every cell's forward and backward, queued before anything is read
        partial: Dict[Cell, torch.Tensor] = {}
        for cell in cells:
            (c, d), dev = cell, mesh.device(cell)
            lora = clients.lora[cell]
            clients.opt[cell].zero_grad(set_to_none=True)
            losses = []
            for i in range(k):
                j = c * k + i
                x = images[j, d * b:(d + 1) * b].to(dev)
                y = flipped[j][d * b:(d + 1) * b].to(dev).long()
                logits = self.forward_fn(base_d[cell], tree_map(lambda a: a[i], lora), x)
                loss = F.cross_entropy(logits.float(), y, reduction="sum") / B
                loss.backward()
                losses.append(loss.detach())
            partial[cell] = torch.cat([p.grad.reshape(-1) for p in tree_leaves(lora)]
                                      + [torch.stack(losses)])

        # the data-axis sum of each row: in cell order on the row's first
        # local cell, or across ranks over the zero-filled rows
        rows: Dict[int, torch.Tensor] = {}
        for (c, d), v in partial.items():
            rows[c] = v if c not in rows else rows[c] + v.to(rows[c].device)
        if _in_world(mesh):
            width = next(iter(rows.values())).numel()
            buf = torch.zeros(n_c, width, device=pdist.collective_device())
            for c, v in rows.items():
                buf[c] = v.to(buf.device)
            tdist.all_reduce(buf)
            rows = {c: buf[c] for c in range(n_c)}

        for cell in cells:
            total = rows[cell[0]]
            off = 0
            for p in tree_leaves(clients.lora[cell]):
                p.grad = total[off:off + p.numel()].view(p.shape).to(p.device, p.dtype, copy=True)
                off += p.numel()
            clients.opt[cell].step()
        losses = torch.zeros(n)
        for c, v in rows.items():
            losses[c * k:(c + 1) * k] = v[-k:].float().cpu()
        return clients, losses


def make_sharded_multi_client_train_step(forward_fn, optimizer: Optimizer, num_classes: int,
                                         mesh: Mesh, label_flip_prob: float = 0.0
                                         ) -> ShardedMultiClientStep:
    """:class:`ShardedMultiClientStep` (the JAX multi-client step under the
    mesh's shardings)."""
    return ShardedMultiClientStep(forward_fn, optimizer, num_classes, mesh, label_flip_prob)
