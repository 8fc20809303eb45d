"""MILP round selection: choose which FL rounds get a Shapley computation
under a budget.

A copy of ``shapley_vit_tpu/shapley/milp.py`` (reference
``fed_client_contribution/milp.py``: three formulations solved with scipy's
HiGHS ``milp``, and the archived coverage formulation + binary search in
``_test_milp_formulation.py:7-161``). Host code: the selected rounds gate the
coalition evaluations on the card.

Formulations (selection_matrix is [T rounds × N clients] binary):
  * :class:`MILP_Shapley` — maximize epoch weight blended (by ``gamma``) with
    client-participation weight, s.t. 1 ≤ Σw_t ≤ k_max (milp.py:8-91).
  * :class:`MILP_Shapley_Two_Sided` — adds |pairwise client coverage diff|
    auxiliary LP variables to the objective (milp.py:96-207).
  * :class:`MILP_Shapley_Two_Sided_Approx` — penalizes each round's pdist of
    normalized selection rows instead of exact aux vars (milp.py:211-305).
  * :class:`MILP_Shapley_prev` — archived: minimize #selected rounds s.t.
    every client is covered ≥ k times (_test_milp_formulation.py:7-110).
  * :func:`binary_search` — max feasible coverage k via repeated MILP
    feasibility (_test_milp_formulation.py:112-161).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import optimize
from scipy.optimize import milp
from scipy.spatial.distance import pdist


def _solve(objective, A, lb, ub, integrality, verbose=False, tag=""):
    constraints = optimize.LinearConstraint(A=A, lb=lb, ub=ub)
    res = milp(
        c=objective,
        constraints=constraints,
        integrality=integrality,
        bounds=optimize.Bounds(0, 1),
    )
    if res.success:
        if verbose:
            print(f"---------Solution {tag}")
            print(f"optimal value: {res.fun}")
            print(f"optimal var: {res.x}")
            print(f"message: {res.message}")
        return True, res.fun, res.x
    return False, None, None


class MILP_Shapley:
    """Epoch-weight + client-participation objective (milp.py:8-91)."""

    def __init__(self, selection_matrix, max_shapley_computation=None, gamma=0.5,
                 weight_epochs=None, verbose=False):
        self.selection_matrix = np.asarray(selection_matrix, dtype=float)
        self.num_epochs, self.num_clients = self.selection_matrix.shape
        self.max_shapley_computation = (
            self.num_epochs if max_shapley_computation is None else max_shapley_computation
        )
        assert 0 <= gamma <= 1
        self.gamma = gamma
        self.verbose = verbose
        w = (np.ones(self.num_epochs) / self.num_epochs
             if weight_epochs is None else np.asarray(weight_epochs, dtype=float))
        # blend with per-round client weight from the column-normalized matrix
        norm = self.selection_matrix / self.selection_matrix.sum(axis=0)
        client_weight = norm.sum(axis=1)
        client_weight = client_weight / client_weight.sum()
        self.weight_epochs = w * gamma + client_weight * (1 - gamma)
        if verbose:
            print(f"weight epochs: {self.weight_epochs}")

    def solve(self) -> Tuple[bool, Optional[float], Optional[np.ndarray]]:
        ok, fun, x = _solve(
            objective=-self.weight_epochs,
            A=np.ones((1, self.num_epochs)),
            lb=np.array([1]),
            ub=np.array([self.max_shapley_computation]),
            integrality=np.ones(self.num_epochs),
            verbose=self.verbose,
            tag="MILP_Shapley",
        )
        return ok, fun, None if x is None else x[: self.num_epochs]


class MILP_Shapley_Two_Sided:
    """Pairwise-coverage |diff| aux-variable formulation (milp.py:96-207)."""

    def __init__(self, selection_matrix, max_shapley_computation=None, gamma=0.5,
                 weight_epochs=None, verbose=False):
        self.selection_matrix = np.asarray(selection_matrix, dtype=float)
        self.num_epochs, self.num_clients = self.selection_matrix.shape
        self.max_shapley_computation = (
            self.num_epochs if max_shapley_computation is None else max_shapley_computation
        )
        assert 0 <= gamma <= 1
        self.gamma = gamma
        self.verbose = verbose
        self.weight_epochs = (
            np.ones(self.num_epochs) / self.num_epochs
            if weight_epochs is None else np.asarray(weight_epochs, dtype=float)
        )
        self.aux_dim = self.num_clients * (self.num_clients - 1) // 2

    def solve(self):
        T, A_dim = self.num_epochs, self.aux_dim
        objective = np.concatenate([
            -self.gamma * self.weight_epochs,
            (1 - self.gamma) * np.ones(A_dim) / A_dim,
        ])
        # Σw_t budget row
        rows = [np.concatenate([np.ones(T), np.zeros(A_dim)])]
        lb, ub = [1], [self.max_shapley_computation]
        # |Σ_t w_t (p_ti − p_tj)/N| ≤ d_ij  as two one-sided rows (milp.py:135-149)
        norm = self.selection_matrix / self.selection_matrix.sum(axis=0)
        aux = 0
        for i in range(self.num_clients):
            for j in range(i + 1, self.num_clients):
                diff = (norm[:, i] - norm[:, j]) / self.num_clients
                aux_row = np.zeros(A_dim)
                aux_row[aux] = 1
                rows.append(np.concatenate([-diff, aux_row]))
                lb.append(0); ub.append(1)
                rows.append(np.concatenate([diff, aux_row]))
                lb.append(0); ub.append(1)
                aux += 1
        ok, fun, x = _solve(
            objective=objective,
            A=np.stack(rows),
            lb=np.array(lb),
            ub=np.array(ub),
            integrality=np.concatenate([np.ones(T), np.zeros(A_dim)]),
            verbose=self.verbose,
            tag="MILP_Shapley_Two_Sided",
        )
        return ok, fun, None if x is None else x[:T]


class MILP_Shapley_Two_Sided_Approx:
    """pdist-penalized epoch weights (milp.py:211-305)."""

    def __init__(self, selection_matrix, max_shapley_computation=None, gamma=0.5,
                 weight_epochs=None, verbose=False):
        self.selection_matrix = np.asarray(selection_matrix, dtype=float)
        self.num_epochs, self.num_clients = self.selection_matrix.shape
        self.max_shapley_computation = (
            self.num_epochs if max_shapley_computation is None else max_shapley_computation
        )
        assert 0 <= gamma <= 1
        self.gamma = gamma
        self.verbose = verbose
        w = (np.ones(self.num_epochs) / self.num_epochs
             if weight_epochs is None else np.asarray(weight_epochs, dtype=float))
        norm = self.selection_matrix / self.selection_matrix.sum(axis=0)
        absolute_diff = np.array([
            pdist(norm[t].reshape(-1, norm[t].shape[0]).T).sum()
            for t in range(self.num_epochs)
        ])
        absolute_diff = absolute_diff / absolute_diff.sum()
        self.weight_epochs = w * gamma - absolute_diff * (1 - gamma)

    def solve(self):
        ok, fun, x = _solve(
            objective=-self.weight_epochs,
            A=np.ones((1, self.num_epochs)),
            lb=np.array([1]),
            ub=np.array([self.max_shapley_computation]),
            integrality=np.ones(self.num_epochs),
            verbose=self.verbose,
            tag="MILP_Shapley_Two_Sided_Approx",
        )
        return ok, fun, None if x is None else x[: self.num_epochs]


class MILP_Shapley_prev:
    """Archived coverage formulation (_test_milp_formulation.py:7-110):
    minimize Σw_t s.t. every client is covered ≥ k times, where client i is
    covered in round t only if w_t selects the round AND i participated."""

    def __init__(self, selection_matrix, min_shapley_computation,
                 max_shapley_computation=None, verbose=False):
        self.selection_matrix = np.asarray(selection_matrix, dtype=float)
        self.num_epochs, self.num_clients = self.selection_matrix.shape
        self.min_shapley_computation = min_shapley_computation
        self.max_shapley_computation = (
            self.num_epochs if max_shapley_computation is None else max_shapley_computation
        )
        self.verbose = verbose

    def solve(self):
        T, N = self.num_epochs, self.num_clients
        nvar = T + T * N  # w_t then b_{i,t} blocks
        objective = np.concatenate([np.ones(T), np.zeros(T * N)])
        rows, lb, ub = [], [], []
        # coverage: Σ_t s_ti · b_it ≥ k per client
        for i in range(N):
            row = np.zeros(nvar)
            row[T + T * i : T + T * (i + 1)] = self.selection_matrix[:, i]
            rows.append(row)
            lb.append(self.min_shapley_computation)
            ub.append(self.max_shapley_computation)
        # linking: w_t·|i_t| − Σ_{i∈i_t} b_it ≥ 0 (== 0 bounds in reference)
        for t in range(T):
            row = np.zeros(nvar)
            row[t] = self.selection_matrix[t].sum()
            for i in range(N):
                if self.selection_matrix[t, i] == 1:
                    row[T + T * i + t] = -1
            rows.append(row)
            lb.append(0)
            ub.append(0)
        ok, fun, x = _solve(
            objective=objective,
            A=np.stack(rows),
            lb=np.array(lb),
            ub=np.array(ub),
            integrality=np.concatenate([np.ones(T), np.zeros(T * N)]),
            verbose=self.verbose,
            tag="MILP_Shapley_prev",
        )
        return ok, fun, None if x is None else x[:T]


def binary_search(selection_matrix, max_value=None, verbose=False):
    """Max feasible per-client coverage k via repeated MILP feasibility
    (_test_milp_formulation.py:112-161). Returns the round-selection vector
    for the best feasible k. Never-selected clients are dropped first."""
    selection_matrix = np.asarray(selection_matrix, dtype=float)
    never = np.where(selection_matrix.sum(axis=0) == 0)[0]
    if verbose and len(never):
        print(f"Never selected clients: {never}")
    selection_matrix = np.delete(selection_matrix, never, axis=1)

    min_value = 1
    if max_value is None:
        max_value = selection_matrix.shape[0]
    solver = MILP_Shapley_prev(selection_matrix, min_value, max_value, verbose=verbose)
    best_x = None
    while min_value < max_value:
        mid = (min_value + max_value) // 2
        solver.min_shapley_computation = mid
        success, fun, x = solver.solve()
        if success:
            min_value = mid + 1
            best_x = x
        else:
            max_value = mid
    return best_x
