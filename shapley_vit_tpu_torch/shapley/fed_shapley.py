"""Multi-round federated Shapley utilities.

A numpy copy of ``shapley_vit_tpu/shapley/fed_shapley.py`` (reference
``fed_client_contribution/utils_fed_shapley.py``, a dead module in the
reference — nothing imports it, and its three scoring entry points call an
undefined ``compute_shapley_corrected`` at lines 214/227/239; the documented
intent is the closed-form ``shapley_value`` of compared_methods.py:81-91,
which is used here as in the JAX package).

Capabilities covered:
  * per-round utility matrices over the subset enumeration
    (``compute_utilities_lazy``: reconstruct coalition models from stored
    per-round client deltas + a selection matrix, utils_fed_shapley.py:146-196)
    — the round/coalition reconstruction is a weight-matrix build followed by
    ONE batched evaluation (on the card: ``ops.tree_math.materialize_coalitions``
    over the stacked (round, client) deltas, through the coalition evaluator);
  * baseline/groundtruth/completed-matrix SV scorers (lines 30-91);
  * per-round scoring wrappers (lines 200-230);
  * optimal-subset selection incl. the 2-objective acc/loss normalization
    (lines 262-331).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from shapley_vit_tpu_torch.shapley.estimators import ncr, powerset
from shapley_vit_tpu_torch.shapley.compared_methods import roundly_mask  # noqa: F401 (re-export)


def all_subsets_enumeration(num_clients: int) -> Dict[tuple, int]:
    """Subset -> column index for utility matrices."""
    return powerset(range(num_clients))


def compute_shapley_corrected(
    utilities_dict: Dict[tuple, float], participating_clients: Sequence[int]
) -> Dict[int, float]:
    """The function the reference calls but never defines: closed-form SV
    over ``participating_clients`` from a tabulated utility dict (empty set
    utility taken as 0 if absent)."""
    N = len(participating_clients)
    sv = {int(c): 0.0 for c in participating_clients}
    if N == 0:
        return sv
    members = set(int(c) for c in participating_clients)
    for S, u in utilities_dict.items():
        if S == ():
            continue
        # utilities_dict may enumerate the FULL client powerset (e.g. from
        # compute_utilities_lazy); the formula runs over subsets of the
        # participating set only, so skip any subset containing outsiders.
        if not members.issuperset(int(c) for c in S):
            continue
        for cid in S:
            rest = tuple(i for i in S if i != cid)
            u_rest = utilities_dict.get(rest, 0.0)
            sv[int(cid)] += (u - u_rest) / (ncr(N - 1, len(S) - 1) * N)
    return sv


def compute_shapley_value_baseline(num_clients, utilities_dict, idxs_users) -> np.ndarray:
    """Marginal-form SV over the participating users (utils_fed_shapley.py:30-42)."""
    N = len(idxs_users)
    out = np.zeros(num_clients)
    for i in range(N):
        tmp = list(idxs_users)
        current = tmp.pop(i)
        val = 0.0
        for s in powerset(tmp):
            si = tuple(sorted(list(s) + [current]))
            val += (utilities_dict[si] - utilities_dict[s]) / ncr(N - 1, len(s))
        val += utilities_dict[(current,)]  # marginal over the empty set
        out[current] = val / N
    return out


def compute_shapley_value_from_matrix(
    rounds: int, num_users: int, utility_matrix: np.ndarray, all_subsets: Dict[tuple, int]
) -> np.ndarray:
    """ComFedSV completed-matrix SV summed over rounds
    (utils_fed_shapley.py:72-91)."""
    out = np.zeros(num_users)
    for i in range(num_users):
        sublist = [c for c in range(num_users) if c != i]
        for s in powerset(sublist):
            id1 = all_subsets[s]
            id2 = all_subsets[tuple(sorted(list(s) + [i]))]
            for t in range(rounds):
                out[i] += (utility_matrix[t, id2] - utility_matrix[t, id1]) / ncr(
                    num_users - 1, len(s)
                )
        out[i] /= num_users
    return out


def compute_utilities_lazy(
    num_clients: int,
    previous_utility: Sequence[float],
    client_deltas_all_rounds: Sequence[Sequence],  # [round][client] delta or None
    client_selection_matrix: Sequence[Sequence[bool]],  # [round][client]
    num_local_data: Sequence[float],
    eval_coalitions_fn: Callable[[np.ndarray], np.ndarray],
    all_subsets: Dict[tuple, int],
    utility_dim: int,
    current_round: int,
    include_from_round: int = 0,
):
    """Round-wise coalition reconstruction + evaluation
    (utils_fed_shapley.py:146-196).

    For each subset S the reference rebuilds the model as
    ``init + Σ_rounds FedAvg({delta_rj : j ∈ S ∩ participants_r})`` and runs
    one validation pass. Here that whole double loop collapses into a single
    weight matrix: row(S) = Σ_r ratios_r(S ∩ p_r) over the stacked
    [rounds × clients] delta axis — then ONE batched evaluation. The caller's
    ``eval_coalitions_fn`` must treat its weight matrix as acting on the
    flattened (round, client) delta stack.

    Returns (utilities [dim][n_subsets], utilities_dict [dim]{subset: u})
    with utilities stored as deltas vs. previous_utility (lines 190-195).
    """
    subsets = list(all_subsets.keys())
    n_rounds = current_round + 1
    num_local_data = np.asarray(num_local_data, dtype=np.float64)

    W = np.zeros((len(subsets), n_rounds * num_clients), dtype=np.float32)
    for row, indices in enumerate(subsets):
        for r in range(n_rounds):
            if r < include_from_round:
                continue
            participating = [
                j
                for j in indices
                if client_selection_matrix[r][j]
                and client_deltas_all_rounds[r][j] is not None
            ]
            if not participating:
                continue
            total = num_local_data[participating].sum()
            for j in participating:
                W[row, r * num_clients + j] = num_local_data[j] / total

    results = np.asarray(eval_coalitions_fn(W))  # [n_subsets, utility_dim] absolute
    utilities = [np.zeros(len(all_subsets)) for _ in range(utility_dim)]
    utilities_dict: List[Dict[tuple, float]] = [{} for _ in range(utility_dim)]
    for row, indices in enumerate(subsets):
        for i in range(utility_dim):
            u = float(results[row, i]) - previous_utility[i]
            utilities[i][all_subsets[indices]] = u
            utilities_dict[i][indices] = u
    return utilities, utilities_dict


def compute_shapley_value_for_participating_clients(
    rounds: int,
    num_clients: int,
    utilities_dict_list: Sequence[Dict[tuple, float]],
    mask: Optional[np.ndarray],
    shapley_non_participating_clients: bool,
) -> List[Dict[int, float]]:
    """Per-round SV (utils_fed_shapley.py:200-218)."""
    valuation_per_round = []
    for t in range(rounds):
        if not shapley_non_participating_clients and mask is not None:
            participating = np.where(mask[:, :num_clients][t] == 1)[0]
        else:
            participating = np.arange(num_clients)
        valuation_per_round.append(
            compute_shapley_corrected(utilities_dict_list[t], participating.tolist())
        )
    return valuation_per_round


def compute_shapley_value_lazy_approach(
    num_clients: int, utilities_dict_list: Sequence[Dict[tuple, float]]
) -> List[Dict[int, float]]:
    """All-clients per-round SV (utils_fed_shapley.py:221-230)."""
    return [
        compute_shapley_corrected(d, list(range(num_clients)))
        for d in utilities_dict_list
    ]


def get_selection_dict(num_clients: int, idxs_participating_clients) -> Dict[int, bool]:
    """(utils_fed_shapley.py:253-259)."""
    d = {i: False for i in range(num_clients)}
    for i in idxs_participating_clients:
        d[i] = True
    return d


def get_optimal_subset(utilities_dict: Dict[tuple, float]) -> tuple:
    """Minimum-utility subset key (utils_fed_shapley.py:262-278 — the
    reference minimizes because its loss-dim utilities are deltas where lower
    is better)."""
    return min(utilities_dict, key=utilities_dict.get)


def get_optimal_subset_multi_objectives(
    utilities_dict_list: Sequence[Sequence[Dict[tuple, float]]]
) -> tuple:
    """2-objective subset selection with min-max normalized acc minus
    normalized loss (utils_fed_shapley.py:281-331). ``utilities_dict_list``
    is [dim][round]{subset: u}; the last round is scored."""
    acc_d = utilities_dict_list[0][-1]
    loss_d = utilities_dict_list[1][-1]
    max_acc, min_acc = max(acc_d.values()), min(acc_d.values())
    max_loss, min_loss = max(loss_d.values()), min(loss_d.values())
    combined = {}
    for key in acc_d:
        combined[key] = 0.0
        combined[key] += 1.0 if max_acc == min_acc else (acc_d[key] - min_acc) / (max_acc - min_acc)
        combined[key] -= 1.0 if max_loss == min_loss else (loss_d[key] - min_loss) / (max_loss - min_loss)
    return max(combined, key=combined.get)
