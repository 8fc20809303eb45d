"""The port's Shapley estimators against ``shapley_vit_tpu.shapley.estimators``.

Each family runs on seeded tabular games (random utilities for every
coalition, two utility dimensions, a non-zero previous utility) with n of
3, 5 and 8, from the same ``np.random.Generator`` seed in both packages.
The two copies draw in the same order and do the same float64 arithmetic,
so the Shapley values (and standard errors) agree within 1e-12.
"""

import itertools

import numpy as np
import pytest

from shapley_vit_tpu.shapley import TabularGame as JGame
from shapley_vit_tpu.shapley import estimators as jest
from shapley_vit_tpu_torch.shapley import TabularGame as TGame
from shapley_vit_tpu_torch.shapley import estimators as test_

ATOL = 1e-12
SIZES = (3, 5, 8)


def _table(n, seed):
    rng = np.random.default_rng(seed)
    return {frozenset(c): rng.normal(size=2) for r in range(1, n + 1)
            for c in itertools.combinations(range(n), r)}


def _games(n, seed=0):
    table = _table(n, seed)
    kw = dict(n_all=n, utility_dim=2, previous_utility=[0.25, 1.5])
    return JGame(table, **kw), TGame(table, **kw)


def _rows(out, n):
    """A list of per-dim {client: value} dicts (or a tuple of such lists)
    as one flat array."""
    parts = out if isinstance(out, tuple) else (out,)
    return np.concatenate([np.array([d[c] for c in range(n)]) for part in parts for d in part])


def _hold(fn_j, fn_t, n, seed=0):
    gj, gt = _games(n, seed)
    want = fn_j(gj)
    got = fn_t(gt)
    np.testing.assert_allclose(_rows(got, n), _rows(want, n), atol=ATOL, rtol=0)
    assert gt.num_evaluations == gj.num_evaluations


FAMILIES = {
    "exact_own": lambda mod, g: mod.shapley_exact_own(g),
    "monte_carlo": lambda mod, g: mod.shapley_monte_carlo(g, 40, rng=np.random.default_rng(1)),
    "monte_carlo_antithetic_se": lambda mod, g: mod.shapley_monte_carlo(
        g, 41, rng=np.random.default_rng(2), antithetic=True, return_se=True),
    "owen_se": lambda mod, g: mod.shapley_owen(g, q_num=6, m_per_q=3,
                                               rng=np.random.default_rng(3), return_se=True),
    "kernel_enumerated": lambda mod, g: mod.shapley_kernel(g),
    "kernel_sampled_se": lambda mod, g: mod.shapley_kernel(g, m=200, rng=np.random.default_rng(4),
                                                           return_se=True),
    "beta_enumerated": lambda mod, g: mod.shapley_beta(g, alpha=1.0, beta=4.0),
    "beta_sampled_se": lambda mod, g: mod.shapley_beta(g, alpha=2.0, beta=8.0, m=30,
                                                       rng=np.random.default_rng(5),
                                                       return_se=True),
    "banzhaf_enumerated": lambda mod, g: mod.banzhaf_value(g),
    "banzhaf_sampled_se": lambda mod, g: mod.banzhaf_value(g, m=30, rng=np.random.default_rng(6),
                                                           return_se=True),
}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_estimator_family_matches_jax(family, n):
    fn = FAMILIES[family]
    _hold(lambda g: fn(jest, g), lambda g: fn(test_, g), n, seed=n)


@pytest.mark.parametrize("n", SIZES)
def test_score_iid_marginal_draws_matches_jax(n):
    """The shared semivalue scorer on the same draws, in another order than
    either sampler emits them (the per-client counter, not the position,
    indexes the SE rows)."""
    rng = np.random.default_rng(n)
    draws = []
    for _ in range(4):
        for i in rng.permutation(n):
            others = [k for k in range(n) if k != i]
            mask = rng.random(n - 1) < 0.5
            draws.append((int(i), tuple(np.array(others)[mask])))
    gj, gt = _games(n, seed=10 + n)
    sel = np.arange(n)
    want = jest._score_iid_marginal_draws(gj, sel, draws, 4, True)
    got = test_._score_iid_marginal_draws(gt, sel, draws, 4, True)
    np.testing.assert_allclose(_rows(got, n), _rows(want, n), atol=ATOL, rtol=0)


@pytest.mark.parametrize("m,num", [(10, 3), (12, 4), (7, 7), (5, 2)])
def test_split_helpers_match_jax(m, num):
    assert test_.split_permutation(m, num) == jest.split_permutation(m, num)
    np.testing.assert_array_equal(test_.split_permutation_num(m, num),
                                  jest.split_permutation_num(m, num))
    budgets = [m, 0, m + 3]
    np.testing.assert_array_equal(test_.split_num(budgets, num, rng=np.random.default_rng(m)),
                                  jest.split_num(budgets, num, rng=np.random.default_rng(m)))


def test_the_port_exports_the_jax_package_names():
    import shapley_vit_tpu.shapley as jshap
    import shapley_vit_tpu_torch.shapley as tshap

    names = [n for n in dir(jshap) if not n.startswith("_")
             and not isinstance(getattr(jshap, n), type(jshap))]
    missing = [n for n in names if not hasattr(tshap, n)]
    assert not missing, missing
