"""Tree algebra for federated aggregation, on nested dicts of tensors.

The port of ``shapley_vit_tpu/ops/tree_math.py``. A tree is a nested
``dict`` (or list/tuple) whose leaves are tensors (or numpy arrays, for the
host-side helpers); dict keys are visited in sorted order, the order
``jax.tree.leaves`` uses, so leaf sequences line up between the packages.

Client deltas live as a *stacked* tree with a leading client axis
``[n_clients, ...]``; materializing every coalition model is one
``[C, n] @ [n, ...]`` contraction per leaf (:func:`materialize_coalitions`).
The JAX package contracts those at ``precision="highest"``; here they run in
float32 with TF32 off (set in ``shapley_vit_tpu_torch.ops``), which the
Shapley-value parity bar needs. ``fedavg_ratio`` and
``coalition_weight_matrix`` stay numpy.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import numpy as np
import torch

from shapley_vit_tpu_torch.utils.profiling import span

Tree = Any


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def graph_ready(t):
    """``t``, or a normal copy of it when it was made in inference mode (a
    tensor made under ``torch.inference_mode`` cannot enter a graph)."""
    return t.clone() if isinstance(t, torch.Tensor) and t.is_inference() else t


def tree_leaves(tree: Tree) -> List[Any]:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_nbytes(tree: Tree) -> int:
    """Bytes of every leaf of ``tree`` (tensors or numpy arrays)."""
    return int(sum(leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf).nbytes for leaf in tree_leaves(tree)))


def tree_structure_equal(a: Tree, b: Tree) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return (
            isinstance(a, dict) and isinstance(b, dict) and sorted(a) == sorted(b)
            and all(tree_structure_equal(a[k], b[k]) for k in a)
        )
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (
            type(a) is type(b) and len(a) == len(b)
            and all(tree_structure_equal(x, y) for x, y in zip(a, b))
        )
    return True


# ---------------------------------------------------------------------------
# Elementwise tree arithmetic
# ---------------------------------------------------------------------------

def tree_add(a: Tree, b: Tree) -> Tree:
    """Leafwise a + b."""
    return tree_map(lambda x, y: x + y, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    """Leafwise a - b: client delta vs. the initial global model
    (reference utils.py:735-749)."""
    return tree_map(lambda x, y: x - y, a, b)


def tree_scale(a: Tree, s) -> Tree:
    """Leafwise s * a."""
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(a: Tree) -> Tree:
    return tree_map(torch.zeros_like, a)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tree_param_difference(a: Tree, b: Tree) -> float:
    """Total absolute parameter difference Σ|a−b| (reference
    ``net_param_difference``, utils.py:846-858)."""
    return float(
        sum(
            np.abs(_host(x) - _host(y)).sum()
            for x, y in zip(tree_leaves(a), tree_leaves(b))
        )
    )


def tree_allclose(a: Tree, b: Tree, atol: float = 1e-6, rtol: float = 1e-5) -> bool:
    """Equality probe (reference ``compare_model_param``, utils.py:825-844);
    trees of different structure never compare equal."""
    if not tree_structure_equal(a, b):
        return False
    la, lb = tree_leaves(a), tree_leaves(b)
    return all(
        np.allclose(_host(x), _host(y), atol=atol, rtol=rtol) for x, y in zip(la, lb)
    )


# ---------------------------------------------------------------------------
# Stacking: the client axis
# ---------------------------------------------------------------------------

def tree_stack(trees: Sequence[Tree]) -> Tree:
    """Stack n structurally-identical trees of tensors along a new leading
    axis (the ``[n_clients, ...]`` layout)."""
    return tree_map(lambda *leaves: torch.stack(leaves, dim=0), *trees)


def tree_stack_host(trees: Sequence[Tree]) -> Tree:
    """:func:`tree_stack` on the host, for numpy trees (ingested client
    deltas): stack once, upload the stacked tree once."""
    with span("tree.stack_host"):
        return tree_map(lambda *leaves: np.stack([_host(l) for l in leaves], axis=0), *trees)


def tree_unstack(tree: Tree) -> list:
    """Inverse of :func:`tree_stack`."""
    n = tree_leaves(tree)[0].shape[0]
    return [tree_map(lambda leaf, i=i: leaf[i], tree) for i in range(n)]


# ---------------------------------------------------------------------------
# FedAvg
# ---------------------------------------------------------------------------

def fedavg_ratio(num_local_data: Sequence[float]) -> np.ndarray:
    """FedAvg weights n_i / Σ n_j (reference server2.py:68-81 ``get_agg_ratio``
    and game2.py:129-139)."""
    n = np.asarray(num_local_data, dtype=np.float64)
    if n.sum() <= 0:
        raise ValueError("total client data size must be positive")
    return (n / n.sum()).astype(np.float32)


def _weights_like(weights, leaf: torch.Tensor) -> torch.Tensor:
    w = torch.as_tensor(np.asarray(weights) if not isinstance(weights, torch.Tensor) else weights)
    return w.to(device=leaf.device, dtype=torch.promote_types(leaf.dtype, w.dtype))


def tree_weighted_sum(stacked: Tree, weights) -> Tree:
    """Σ_i weights[i] · stacked[i] per leaf — one contraction on the client
    axis (reference ``add_net_state*``, utils.py:689-733)."""

    def combine(leaf):
        w = _weights_like(weights, leaf)
        return torch.tensordot(w, leaf.to(w.dtype), dims=([0], [0])).to(leaf.dtype)

    return tree_map(combine, stacked)


def aggregate_deltas(stacked_deltas: Tree, ratio) -> Tree:
    """FedAvg-combine client deltas with data-size ratios
    (reference ``get_aggregated_model``, utils.py:781-792)."""
    return tree_weighted_sum(stacked_deltas, ratio)


def apply_deltas(init_params: Tree, *aggregated_deltas: Tree) -> Tree:
    """global = init + Σ aggregated-deltas
    (reference ``ServerBase.model_agg_lazy``, server2.py:121-127)."""
    out = init_params
    for d in aggregated_deltas:
        out = tree_add(out, d)
    return out


# ---------------------------------------------------------------------------
# Coalition materialization — the batched primitive
# ---------------------------------------------------------------------------

def coalition_weight_matrix(
    coalitions: Sequence[Sequence[int]],
    num_local_data: Sequence[float],
    n_clients: int,
) -> np.ndarray:
    """Build W[C, n]: row c holds FedAvg ratios of coalition c's members
    (zero for non-members, n_i/Σ_{j∈S} n_j for members — game2.py:89-100).
    An empty coalition yields an all-zero row (the init model unchanged,
    game2.py:80-81)."""
    n = np.asarray(num_local_data, dtype=np.float64)
    if len(n) != n_clients:
        raise ValueError("num_local_data must have one entry per client")
    W = np.zeros((len(coalitions), n_clients), dtype=np.float32)
    for c, members in enumerate(coalitions):
        members = list(members)
        if not members:
            continue
        total = n[members].sum()
        if total <= 0:
            raise ValueError(f"coalition {members} has zero total data")
        for j in members:
            W[c, j] = n[j] / total
    return W


def materialize_coalitions(init_params: Tree, stacked_deltas: Tree, weight_matrix) -> Tree:
    """Materialize all coalition models at once: per leaf
    ``out[c] = init + Σ_j W[c, j] · delta[j]``, one ``[C, n] × [n, ...]``
    contraction (game2.py:97-106). Leaves come back with a leading
    coalition axis ``[C, ...]``."""

    def combine(init_leaf, delta_leaf):
        W = _weights_like(weight_matrix, delta_leaf)
        mixed = torch.tensordot(W, delta_leaf.to(W.dtype), dims=([1], [0]))
        return (init_leaf[None].to(W.dtype) + mixed).to(init_leaf.dtype)

    return tree_map(combine, init_params, stacked_deltas)
