"""The coalition game (a numpy copy of ``shapley_vit_tpu/shapley/game.py``).

Reference: ``fed_client_contribution/game2.py`` — Game caches 2-dim utilities
per frozenset(coalition); a cache miss FedAvg-aggregates member deltas
(data-size ratios), applies them to the initial global model, runs a full
validation pass, and stores ``(acc - prev_acc, loss - prev_loss)``
(game2.py:74-122).

TPU-first inversion (SURVEY.md §7): the memo dict becomes "enumerate distinct
coalitions up front, evaluate once batched, index". The Game is decoupled
from models: it drives an injected ``eval_coalitions_fn(weight_matrix[C, n])
-> [C, 2]`` of absolute (accuracy, loss) rows, which the driver builds from
``ops.materialize_coalitions`` + ``fl.evaluation.make_coalition_evaluator``.
The serial ``eval_utility`` API is preserved for estimator compatibility; it
batches lazily through the same path.

Reference quirks handled deliberately:
  * ``default_shapley_value`` returns a FRESH structure per call — the
    reference aliases one dict into every estimator and ``shapley_monte_carlo``
    mutates it in place (utils_shapley.py:254), a bug we do not replicate.
  * empty coalition -> zero utility without evaluation (game2.py:80-81).
  * ``_n_all`` is a constructor arg, not hardcoded 3 (game2.py:25).
  * utilities are ABSOLUTE minus ``previous_utility`` (game2.py:113-114).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence

import numpy as np

PyTree = Any


class Game:
    """A Shapley game over FL clients with ``utility_dim``-dimensional utility."""

    def __init__(
        self,
        eval_coalitions_fn: Callable[[np.ndarray], np.ndarray],
        num_local_data: Sequence[float],
        client_selection_vector: Sequence[bool],
        previous_utility: Sequence[float],
        utility_dim: int = 2,
        n_all: Optional[int] = None,
    ):
        self.eval_coalitions_fn = eval_coalitions_fn
        self.num_local_data = list(num_local_data)
        self.client_selection_vector = list(client_selection_vector)
        self._n_all = n_all if n_all is not None else len(self.client_selection_vector)
        self.selected_clients = [
            i for i in range(self._n_all) if self.client_selection_vector[i]
        ]
        self.n = len(self.selected_clients)
        self.previous_utility = list(previous_utility)
        self.utility_dim = utility_dim
        assert self.utility_dim == len(self.previous_utility)
        # memo: frozenset(coalition) -> list[utility_dim] (game2.py:32-34)
        self.utility: Dict[FrozenSet[int], List[float]] = {}
        self.num_evaluations = 0  # distinct coalition evals (perf counter)

    # -- default SV (game2.py:40-43) --------------------------------------

    @property
    def default_shapley_value(self) -> List[Dict[int, float]]:
        """Zeros for every client in every utility dim; fresh per call."""
        return [
            {client_id: 0.0 for client_id in range(self._n_all)}
            for _ in range(self.utility_dim)
        ]

    def get_default_shapley_value(self):
        return self.default_shapley_value

    # -- aggregation ratios (game2.py:125-139) -----------------------------

    def get_agg_ratio(self, members: Sequence[int]) -> np.ndarray:
        n = np.asarray([self.num_local_data[j] for j in members], dtype=np.float64)
        return (n / n.sum()).astype(np.float32)

    def _weight_row(self, members: Sequence[int]) -> np.ndarray:
        row = np.zeros(self._n_all, dtype=np.float32)
        members = [j for j in members if self.client_selection_vector[j]]
        if members:
            ratios = self.get_agg_ratio(members)
            for j, r in zip(members, ratios):
                row[j] = r
        return row

    # -- evaluation ---------------------------------------------------------

    def pending(self, coalitions: Sequence[Sequence[int]]) -> List[List[int]]:
        """Distinct, not-yet-memoized coalitions (sorted member lists, in
        first-seen order) — exactly the work :meth:`precompute` would
        evaluate. Exposed so wrappers (e.g. block-wise persistence in
        fl/checkpoint.checkpointed_game) split work without re-implementing
        the memo filter."""
        todo: List[List[int]] = []
        seen = set()
        for coalition in coalitions:
            key = frozenset(coalition)
            if key and key not in self.utility and key not in seen:
                seen.add(key)
                todo.append(sorted(key))
        return todo

    def precompute(self, coalitions: Sequence[Sequence[int]]) -> None:
        """Batch-evaluate all not-yet-cached coalitions in ONE call to the
        injected evaluator, then fill the memo. This is where the TPU win
        happens: C coalition models in one vmapped validation pass."""
        todo = self.pending(coalitions)
        if not todo:
            return
        W = np.stack([self._weight_row(members) for members in todo])
        results = np.asarray(self.eval_coalitions_fn(W))  # [C, dim] absolute
        assert results.shape == (len(todo), self.utility_dim)
        self.num_evaluations += len(todo)
        for members, row in zip(todo, results):
            self.utility[frozenset(members)] = [
                float(row[i]) - self.previous_utility[i]
                for i in range(self.utility_dim)
            ]

    def eval_utility(self, coalition) -> List[float]:
        """Serial-compatible API (game2.py:74-122): memoized utility of one
        coalition, as ``[u_acc, u_loss]`` deltas vs. previous_utility."""
        key = frozenset(coalition)
        if len(key) == 0:
            return [0.0 for _ in range(self.utility_dim)]
        if key not in self.utility:
            self.precompute([key])
        return list(self.utility[key])


class TabularGame(Game):
    """A fake game over tabulated coalition utilities — the test fixture the
    reference never had (SURVEY.md §4): estimators run against closed-form
    games with zero model evaluations."""

    def __init__(
        self,
        table: Dict[FrozenSet[int], Sequence[float]],
        n_all: int,
        utility_dim: int = 2,
        previous_utility: Optional[Sequence[float]] = None,
        client_selection_vector: Optional[Sequence[bool]] = None,
        num_local_data: Optional[Sequence[float]] = None,
    ):
        self._table = {frozenset(k): list(v) for k, v in table.items()}

        def eval_fn(W: np.ndarray) -> np.ndarray:
            out = []
            for row in W:
                members = frozenset(int(i) for i in np.nonzero(row)[0])
                out.append(self._table[members])
            return np.asarray(out, dtype=np.float64)

        super().__init__(
            eval_coalitions_fn=eval_fn,
            num_local_data=num_local_data or [1.0] * n_all,
            client_selection_vector=client_selection_vector or [True] * n_all,
            previous_utility=previous_utility or [0.0] * utility_dim,
            utility_dim=utility_dim,
            n_all=n_all,
        )


def additive_table(values: np.ndarray) -> Dict[FrozenSet[int], np.ndarray]:
    """Closed-form additive game u(S) = Σ_{i∈S} v_i (exact SV = v_i)."""
    from itertools import combinations

    n, dim = values.shape
    table = {}
    for r in range(1, n + 1):
        for comb in combinations(range(n), r):
            table[frozenset(comb)] = values[list(comb)].sum(axis=0)
    return table
