"""Eval-side server: holds the initial global params and the validation data,
and provides the aggregation entry points.

The port of ``shapley_vit_tpu/fl/server.py`` over dict-of-tensor trees
(``ops.tree_math``); the checkpoint loader is the port's ``fl.ingestion``.

Reference: ``server2.py:15-127`` ServerBase (deepcopy of the global model,
valid_loader, FedAvg ratios, model_agg flavors, model_agg_lazy). Pure
functional here: aggregation returns new pytrees; nothing is mutated in
place, so the reference's pervasive ``copy.deepcopy`` disappears.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from shapley_vit_tpu_torch.ops import tree_math as tm

PyTree = Any


class EvalServer:
    """Functional ServerBase equivalent."""

    def __init__(
        self,
        global_params: PyTree,
        clients: Sequence,
        valid_batches=None,
        valid_size: Optional[int] = None,
    ):
        self.global_params = global_params
        self.clients = list(clients)
        self.num_clients = len(self.clients)
        self.valid_batches = valid_batches
        self.valid_size = valid_size

    def get_agg_ratio(self, selected_clients=None) -> np.ndarray:
        """FedAvg ratio n_i/Σn (server2.py:68-81)."""
        cs = self.clients if selected_clients is None else selected_clients
        return tm.fedavg_ratio([c.num_local_data_train for c in cs])

    def model_agg(self, client_params: Sequence[PyTree], selected_clients=None) -> PyTree:
        """FedAvg over full client weight sets (server2.py:83-102 model_agg/2)."""
        ratio = self.get_agg_ratio(selected_clients)
        return tm.tree_weighted_sum(tm.tree_stack(client_params), ratio)

    def model_agg_delta(
        self, init_params: PyTree, client_deltas: Sequence[PyTree], selected_clients=None
    ) -> PyTree:
        """init + FedAvg(deltas) (server2.py:105-118 model_agg3 semantics)."""
        ratio = self.get_agg_ratio(selected_clients)
        agg = tm.aggregate_deltas(tm.tree_stack(client_deltas), ratio)
        return tm.apply_deltas(init_params, agg)

    def model_agg_lazy(self, init_params: PyTree, aggregated_deltas: Sequence[PyTree]) -> PyTree:
        """global = init + Σ pre-aggregated deltas (server2.py:121-127) —
        returns the new params instead of mutating a module."""
        return tm.apply_deltas(init_params, *aggregated_deltas)

    def init_net(self, path: Optional[str] = None, init_fn=None) -> PyTree:
        """Re-initialize or load the global params (server2.py:49-54
        ``init_net``: torch load of 'model_state_dict', else kaiming re-init
        via ``init_new_net``). Here: npz/torch checkpoint via the ingestion
        loader (numpy leaves), or a caller-provided ``init_fn()``
        (functional re-init)."""
        if path is not None:
            from shapley_vit_tpu_torch.fl.ingestion import load_checkpoint_state_dict

            sd = load_checkpoint_state_dict(path)
            # flat 'a.b.c' keys -> nested pytree
            tree: dict = {}
            for key, value in sd.items():
                node = tree
                parts = key.split(".")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = value
            self.global_params = tree
        elif init_fn is not None:
            self.global_params = init_fn()
        else:
            raise ValueError("init_net needs a checkpoint path or an init_fn")
        return self.global_params

    def clients_sel(self, frac: float = 1.0, rng: Optional[np.random.Generator] = None):
        """Client subsampling (server.py:53-63)."""
        if frac >= 1.0:
            return self.clients
        k = max(1, int(round(frac * self.num_clients)))
        rng = rng or np.random.default_rng()
        idx = rng.choice(self.num_clients, size=k, replace=False)
        return [self.clients[i] for i in sorted(idx)]
