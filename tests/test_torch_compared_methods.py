"""The port's multi-round Shapley machinery against the JAX package's:
``shapley/compared_methods.py`` (Fed-SV, GTG, MR, TMR, ComFedSV, the
closed-form ``shapley_value``), ``shapley/fed_shapley.py``,
``shapley/milp.py`` and the rest of ``data/partition.py``.

Games are seeded tabular ones (an additive part plus noise, so GTG's
relative convergence test settles), built from the same table in both
packages; every sampler gets a generator of the same seed. The copies do
the same float64 arithmetic in the same order: Shapley values agree within
1e-12, MILP solutions and partitions are identical.
"""

import itertools

import numpy as np
import pytest

from shapley_vit_tpu.data import arrays as jarrays
from shapley_vit_tpu.data import partition as jpart
from shapley_vit_tpu.shapley import TabularGame as JGame
from shapley_vit_tpu.shapley import compared_methods as jcm
from shapley_vit_tpu.shapley import fed_shapley as jfs
from shapley_vit_tpu.shapley import milp as jmilp
from shapley_vit_tpu_torch.data import arrays as tarrays
from shapley_vit_tpu_torch.data import partition as tpart
from shapley_vit_tpu_torch.shapley import TabularGame as TGame
from shapley_vit_tpu_torch.shapley import compared_methods as tcm
from shapley_vit_tpu_torch.shapley import fed_shapley as tfs
from shapley_vit_tpu_torch.shapley import milp as tmilp

ATOL = 1e-12


def _table(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    values = rng.uniform(0.5, 2.0, size=(n, 2)) * scale
    return {frozenset(c): values[list(c)].sum(axis=0) + 0.05 * scale * rng.normal(size=2)
            for r in range(1, n + 1) for c in itertools.combinations(range(n), r)}


def _games(n, seed=0, scale=1.0, selection=None):
    table = _table(n, seed, scale)
    kw = dict(n_all=n, utility_dim=2, previous_utility=[0.0, 0.0],
              client_selection_vector=selection)
    return JGame(table, **kw), TGame(table, **kw)


def _arr(sv, n):
    return np.array([sv[c] for c in range(n)])


def _close(got, want, n):
    np.testing.assert_allclose(_arr(got, n), _arr(want, n), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# compared methods
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 4])
def test_fed_sv_matches_jax(n):
    gj, gt = _games(n, seed=n)
    for t in range(2):  # the second round consumes the first's carried-over draws
        want = jcm.Fed_SV(0, rng=np.random.default_rng(7)).compute_shapley_value(gj, t)
        got = tcm.Fed_SV(0, rng=np.random.default_rng(7)).compute_shapley_value(gt, t)
        _close(got, want, n)
    fj, ft = jcm.Fed_SV(1, rng=np.random.default_rng(8)), tcm.Fed_SV(1, rng=np.random.default_rng(8))
    for t in range(2):
        _close(ft.compute_shapley_value(gt, t), fj.compute_shapley_value(gj, t), n)
    assert ft._pending == fj._pending


def test_fed_sv_bootstrap_se_matches_jax():
    gj, gt = _games(3, seed=11)
    svj, sej = jcm.Fed_SV(0, rng=np.random.default_rng(9)).compute_shapley_value(
        gj, 0, return_se=True, n_boot=10)
    svt, set_ = tcm.Fed_SV(0, rng=np.random.default_rng(9)).compute_shapley_value(
        gt, 0, return_se=True, n_boot=10)
    _close(svt, svj, 3)
    _close(set_, sej, 3)


@pytest.mark.parametrize("n", [3, 5, 8])
@pytest.mark.parametrize("batch_prefixes", [False, True])
def test_gtg_matches_jax(n, batch_prefixes):
    gj, gt = _games(n, seed=20 + n)
    for dim in range(2):
        want = jcm.GTG(dim, rng=np.random.default_rng(dim),
                       batch_prefixes=batch_prefixes).compute_shapley_value(gj, 0, return_se=True)
        got = tcm.GTG(dim, rng=np.random.default_rng(dim),
                      batch_prefixes=batch_prefixes).compute_shapley_value(gt, 0, return_se=True)
        for g, w in zip(got, want):
            _close(g, w, n)


def test_gtg_truncates_a_flat_round_as_jax_does():
    gj, gt = _games(3, seed=3, scale=1e-3)
    want = jcm.GTG(0, rng=np.random.default_rng(0)).compute_shapley_value(gj, 0)
    got = tcm.GTG(0, rng=np.random.default_rng(0)).compute_shapley_value(gt, 0)
    assert got == want and all(v == 0.0 for v in got.values())


@pytest.mark.parametrize("n", [3, 5, 8])
@pytest.mark.parametrize("method", ["MR", "TMR"])
def test_mr_and_tmr_match_jax(method, n):
    selection = [True] * n
    selection[1] = False  # a non-participant keeps 0.0
    gj, gt = _games(n, seed=30 + n, selection=selection)
    for dim in range(2):
        want = getattr(jcm, method)(dim).compute_shapley_value(gj, 0)
        got = getattr(tcm, method)(dim).compute_shapley_value(gt, 0)
        _close(got, want, n)
        assert got[1] == 0.0


def test_tmr_truncates_a_flat_round_as_jax_does():
    gj, gt = _games(4, seed=4, scale=1e-3)
    want = jcm.TMR(0).compute_shapley_value(gj, 0)
    got = tcm.TMR(0).compute_shapley_value(gt, 0)
    assert got == want and all(v == 0.0 for v in got.values())
    assert gt.num_evaluations == gj.num_evaluations


@pytest.mark.parametrize("n", [3, 5])
def test_comfedsv_and_shapley_value_match_jax(n):
    all_subsets = tfs.all_subsets_enumeration(n)
    assert all_subsets == jfs.all_subsets_enumeration(n)
    rng = np.random.default_rng(n)
    matrix = rng.normal(size=(3, len(all_subsets)))
    args = {"rounds": 3, "num_clients": n}
    want, _ = jcm.comfedsv(args, matrix, all_subsets)
    got, _ = tcm.comfedsv(args, matrix, all_subsets)
    for g, w in zip(got, want):
        _close(g, w, n)

    selection = [c != 0 for c in range(n)]
    gj, gt = _games(n, seed=40 + n, selection=selection)
    (uj, mj), (ut, mt) = jcm.call_comfedsv(gj, all_subsets), tcm.call_comfedsv(gt, all_subsets)
    np.testing.assert_array_equal(mt, mj)
    for a, b in zip(ut, uj):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tcm.roundly_mask([0, 2], all_subsets),
                                  jcm.roundly_mask([0, 2], all_subsets))

    util = {S: gt.eval_utility(S)[0] for S in tfs.all_subsets_enumeration(n) if 0 not in S}
    util[()] = 0.0
    _close(tcm.shapley_value(util, gt), jcm.shapley_value(util, gj), n)


# ---------------------------------------------------------------------------
# fed_shapley
# ---------------------------------------------------------------------------

PARTICIPATION = np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1]], dtype=bool)
SIZES = [120.0, 300.0, 580.0]


@pytest.mark.parametrize("include_from_round", [0, 1])
def test_compute_utilities_lazy_matches_jax(include_from_round):
    """A tabular ``eval_coalitions_fn``: a linear utility of the stacked
    (round, client) weights. A (round, client) without a delta gets weight
    0 in every row."""
    n, rounds = 3, 3
    V = np.random.default_rng(1).normal(size=(rounds * n, 2))
    deltas = [[object() if PARTICIPATION[r][j] else None for j in range(n)] for r in range(rounds)]
    seen = {}

    def run(mod, key):
        def eval_fn(W):
            seen[key] = W
            return W @ V
        return mod.compute_utilities_lazy(
            num_clients=n, previous_utility=[0.3, 1.2], client_deltas_all_rounds=deltas,
            client_selection_matrix=PARTICIPATION, num_local_data=SIZES, eval_coalitions_fn=eval_fn,
            all_subsets=mod.all_subsets_enumeration(n), utility_dim=2, current_round=rounds - 1,
            include_from_round=include_from_round)

    (uj, dj), (ut, dt) = run(jfs, "jax"), run(tfs, "torch")
    np.testing.assert_array_equal(seen["torch"], seen["jax"])
    assert not seen["torch"][:, 1 * n + 1].any()
    for a, b in zip(ut, uj):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    assert dt == dj


def _utility_dicts(n, seed):
    rng = np.random.default_rng(seed)
    return [{S: float(rng.normal()) for S in jfs.all_subsets_enumeration(n)} for _ in range(3)]


@pytest.mark.parametrize("n", [3, 4])
def test_fed_shapley_scorers_match_jax(n):
    dicts = _utility_dicts(n, n)
    parts = [0, 2] if n == 3 else [1, 2, 3]
    want = jfs.compute_shapley_corrected(dicts[0], parts)
    got = tfs.compute_shapley_corrected(dicts[0], parts)
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[c] for c in parts], [want[c] for c in parts], atol=ATOL, rtol=0)

    np.testing.assert_allclose(tfs.compute_shapley_value_baseline(n, dicts[1], parts),
                               jfs.compute_shapley_value_baseline(n, dicts[1], parts),
                               atol=ATOL, rtol=0)
    all_subsets = tfs.all_subsets_enumeration(n)
    matrix = np.random.default_rng(n + 1).normal(size=(3, len(all_subsets)))
    np.testing.assert_allclose(tfs.compute_shapley_value_from_matrix(3, n, matrix, all_subsets),
                               jfs.compute_shapley_value_from_matrix(3, n, matrix, all_subsets),
                               atol=ATOL, rtol=0)
    mask = np.ones((3, n + 2))
    mask[1, 0] = 0
    for flag in (False, True):
        for g, w in zip(tfs.compute_shapley_value_for_participating_clients(3, n, dicts, mask, flag),
                        jfs.compute_shapley_value_for_participating_clients(3, n, dicts, mask, flag)):
            assert g.keys() == w.keys()
            np.testing.assert_allclose(list(g.values()), list(w.values()), atol=ATOL, rtol=0)
    for g, w in zip(tfs.compute_shapley_value_lazy_approach(n, dicts),
                    jfs.compute_shapley_value_lazy_approach(n, dicts)):
        _close(g, w, n)


def test_subset_selection_matches_jax():
    dicts = _utility_dicts(4, 9)
    assert tfs.get_optimal_subset(dicts[0]) == jfs.get_optimal_subset(dicts[0])
    per_dim = [[dicts[0], dicts[1]], [dicts[2], dicts[1]]]
    assert (tfs.get_optimal_subset_multi_objectives(per_dim)
            == jfs.get_optimal_subset_multi_objectives(per_dim))
    assert tfs.get_selection_dict(5, [1, 4]) == jfs.get_selection_dict(5, [1, 4])


# ---------------------------------------------------------------------------
# MILP
# ---------------------------------------------------------------------------

def _selection_matrices():
    fixed = np.array([[1, 1, 0, 0], [0, 1, 1, 0], [0, 0, 1, 1], [1, 0, 0, 1], [1, 1, 1, 1]])
    rng = np.random.default_rng(5)
    out = [fixed, PARTICIPATION.astype(int)]
    while len(out) < 5:
        m = rng.integers(0, 2, size=(6, 4))
        if m.sum(axis=0).min() > 0 and m.sum(axis=1).min() > 0:
            out.append(m)
    return out


def _same_solution(got, want):
    assert got[0] == want[0]
    if want[2] is None:
        assert got[2] is None
    else:
        np.testing.assert_array_equal(got[2], want[2])
        assert got[1] == want[1]


@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("formulation", ["MILP_Shapley", "MILP_Shapley_Two_Sided",
                                         "MILP_Shapley_Two_Sided_Approx"])
def test_milp_formulations_match_jax(formulation, k):
    sel = _selection_matrices()[k]
    for budget, gamma in ((1, 0.5), (2, 0.0), (3, 1.0)):
        want = getattr(jmilp, formulation)(sel, max_shapley_computation=budget, gamma=gamma).solve()
        got = getattr(tmilp, formulation)(sel, max_shapley_computation=budget, gamma=gamma).solve()
        _same_solution(got, want)


@pytest.mark.parametrize("k", range(5))
def test_milp_prev_and_binary_search_match_jax(k):
    sel = _selection_matrices()[k]
    for cover in (1, 2):
        _same_solution(tmilp.MILP_Shapley_prev(sel, cover).solve(),
                       jmilp.MILP_Shapley_prev(sel, cover).solve())
    want, got = jmilp.binary_search(sel), tmilp.binary_search(sel)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the rest of data/partition.py
# ---------------------------------------------------------------------------

LABELS = np.random.default_rng(0).integers(0, 4, size=400)


@pytest.mark.parametrize("n_parties,beta,min_class_size", [(3, 0.5, 10), (5, 1.0, 4)])
def test_partition_labeldir2_matches_jax(n_parties, beta, min_class_size):
    dj, mj = jpart.partition_labeldir2(LABELS, num_classes=4, n_parties=n_parties, beta=beta,
                                       min_class_size=min_class_size, seed=3)
    dt, mt = tpart.partition_labeldir2(LABELS, num_classes=4, n_parties=n_parties, beta=beta,
                                       min_class_size=min_class_size, seed=3)
    np.testing.assert_array_equal(dt, dj)
    assert mt == mj


@pytest.mark.parametrize("n_parties,beta", [(3, 0.1), (4, 0.5)])
def test_partition_labeldir_med_matches_jax(n_parties, beta):
    mj = jpart.partition_labeldir_med("octmnist", LABELS, n_parties, beta=beta, seed=1)
    mt = tpart.partition_labeldir_med("octmnist", LABELS, n_parties, beta=beta, seed=1)
    assert mt == mj
    assert tpart.MED_NUM_CLASSES == jpart.MED_NUM_CLASSES
    with pytest.raises(ValueError, match="unknown medical dataset"):
        tpart.partition_labeldir_med("cifar10", LABELS, n_parties)


def test_record_net_data_stats_and_client_datasets_match_jax():
    _, mapping = tpart.partition_labeldir(LABELS, num_classes=4, n_parties=3, beta=0.5)
    assert tpart.record_net_data_stats(LABELS, mapping) == jpart.record_net_data_stats(LABELS, mapping)
    assert tpart.record_net_data_stats(LABELS, None) == jpart.record_net_data_stats(LABELS, None)
    images = np.random.default_rng(1).normal(size=(400, 2, 2, 1)).astype(np.float32)
    names = [f"img_{i}" for i in range(400)]
    dj = jpart.make_client_datasets(jarrays.ArrayDataset(images, LABELS, names=names), 3, mapping)
    dt = tpart.make_client_datasets(tarrays.ArrayDataset(images, LABELS, names=names), 3, mapping)
    assert sorted(dt) == sorted(dj) == [0, 1, 2]
    for c in range(3):
        np.testing.assert_array_equal(dt[c].images, dj[c].images)
        np.testing.assert_array_equal(dt[c].labels, dj[c].labels)
        assert dt[c].names == dj[c].names
