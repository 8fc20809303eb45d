"""The port's ``utils.eval_metrics`` and ``utils.plots`` against the JAX
package's.

``get_metrics`` and ``compute_accuracy`` (sklearn there, numpy in the
port) agree within 1e-12 on binary and multi-class logits, tied scores
included, and the confusion matrix is identical; the fairness gaps and
``collect_logits`` agree on a linear model within 1e-6 (float32
forwards). Each plot helper writes its PNG (matplotlib is installed here);
plotly is gated as in the JAX package.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.metrics import balanced_accuracy_score

from shapley_vit_tpu.data.arrays import ArrayDataset as JDataset
from shapley_vit_tpu.utils import eval_metrics as jem
from shapley_vit_tpu_torch.data.arrays import ArrayDataset
from shapley_vit_tpu_torch.utils import eval_metrics as tem
from shapley_vit_tpu_torch.utils import plots as tplots
from torch_one_thread import one_torch_thread  # noqa: F401


def _logits(kind, n=60, seed=0):
    rng = np.random.default_rng(seed)
    k = 2 if kind == "binary" else 5
    labels = np.concatenate([np.arange(k), rng.integers(0, k, size=n - k)])
    logits = rng.normal(size=(n, k))
    if kind == "tied":
        logits = np.round(logits)  # many equal scores in each column
    return logits, labels


@pytest.mark.parametrize("kind", ["binary", "multiclass", "tied"])
def test_get_metrics_matches_sklearn(kind):
    logits, labels = _logits(kind)
    got, want = tem.get_metrics(logits, labels), jem.get_metrics(logits, labels)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    if kind == "binary":
        return
    # a class that is never true (so no one-vs-rest AUC), one never predicted
    labels2 = np.where(labels == 1, 0, labels)
    logits2 = logits.copy()
    logits2[:, 3] -= 100.0
    with pytest.raises(ValueError, match="Number of classes"):
        tem.get_metrics(logits2, labels2)
    assert tem.balanced_accuracy(labels2, logits2.argmax(1)) == pytest.approx(
        balanced_accuracy_score(labels2, logits2.argmax(1)), abs=1e-12)


def test_binary_auc_needs_both_classes():
    with pytest.raises(ValueError, match="Only one class"):
        tem.binary_auc(np.ones(4, bool), np.arange(4.0))


def _linear(seed=1, k=3, d=6):
    rng = np.random.default_rng(seed)
    w, b = rng.normal(size=(d, k)).astype(np.float32), rng.normal(size=k).astype(np.float32)
    x = rng.normal(size=(23, d)).astype(np.float32)
    y = rng.integers(0, k, size=23)
    groups = [np.arange(0, 10), np.arange(10, 23)]
    t_fwd = lambda p, xs: xs @ p["w"] + p["b"]
    j_fwd = lambda p, xs: xs @ p["w"] + p["b"]
    return (w, b, x, y, groups, t_fwd, j_fwd)


def test_accuracy_confusion_and_fairness_match_jax():
    w, b, x, y, groups, t_fwd, j_fwd = _linear()
    tp = {"w": torch.tensor(w), "b": torch.tensor(b)}
    jp = {"w": w, "b": b}
    tds, jds = ArrayDataset(images=x, labels=y), JDataset(images=x, labels=y)
    gl, gy = tem.collect_logits(t_fwd, tp, tds, batch_size=8)
    wl, wy = jem.collect_logits(j_fwd, jp, jds, batch_size=8)
    np.testing.assert_allclose(gl, np.asarray(wl), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(gy, wy)
    acc, cm = tem.compute_accuracy(t_fwd, tp, [tds, tds], get_confusion_matrix=True, batch_size=8)
    wacc, wcm = jem.compute_accuracy(j_fwd, jp, [jds, jds], get_confusion_matrix=True, batch_size=8)
    assert acc == pytest.approx(wacc, abs=1e-12)
    np.testing.assert_array_equal(cm, wcm)
    assert tem.compute_accuracy(t_fwd, tp, tds) == pytest.approx(jem.compute_accuracy(j_fwd, jp, jds))
    tg = [tds.subset(g) for g in groups]
    jg = [jds.subset(g) for g in groups]
    assert tem.statistical_parity_gap(t_fwd, tp, tg) == pytest.approx(
        jem.statistical_parity_gap(j_fwd, jp, jg), abs=1e-12)
    np.testing.assert_allclose(tem.group_fairness_gaps(t_fwd, tp, tg),
                               jem.group_fairness_gaps(j_fwd, jp, jg), atol=1e-6, rtol=0)


def test_plot_helpers_write_pngs(tmp_path):
    rng = np.random.default_rng(2)
    paths = {n: str(tmp_path / f"{n}.png") for n in
             ("series", "mul", "band", "bar", "multi", "hist", "bar1")}
    tplots.plot_series([0.1, 0.5, 0.7], title="acc", save=True, save_path=paths["series"])
    tplots.plot_series_mul([[0.1, 0.2], [0.3, 0.4]], save=True, save_path=paths["mul"],
                           labels=["a", "b"])
    np.testing.assert_array_equal(tplots.monotone_curve([0.1, 0.3, 0.2, 0.5]), [0.1, 0.3, 0.3, 0.5])
    df = pd.DataFrame({"method": ["a", "a", "b", "b"] * 2, "epoch": [0, 1] * 4,
                       "acc": rng.random(8)})
    agg = tplots.mean_std_df(df, ["method", "epoch"], ["acc"])
    assert list(agg.columns) == ["method", "epoch", "acc_mean", "acc_std"]
    tplots.nice_plot(df, "epoch", "acc", group_by="method", save_path=paths["band"])
    tplots.nice_bar(df, "epoch", "acc", group_by="method", save_path=paths["bar"])
    tplots.nice_bar(df, "epoch", "acc", save_path=paths["bar1"])
    df2 = pd.DataFrame({"epoch": [0, 1, 0, 1], "acc": rng.random(4), "auc": rng.random(4)})
    tplots.nice_plot_multi_columns(df2, "epoch", ["acc", "auc"], save_path=paths["multi"])
    tplots.plot_client_histogram(rng.integers(0, 4, 100), {0: list(range(50)),
                                                           1: list(range(50, 100))}, 4,
                                 save_path=paths["hist"])
    for p in paths.values():
        assert os.path.getsize(p) > 0, p


def test_plotly_is_gated(monkeypatch):
    df = pd.DataFrame({"epoch": [0, 1, 0, 1], "acc": [0.1, 0.2, 0.3, 0.4], "run": [0, 0, 1, 1]})
    if tplots._plotly() is None:
        with pytest.raises(ImportError, match="plotly"):
            tplots.nice_plot(df, "epoch", "acc", backend="plotly")
    assert tplots.nice_plot(df, "epoch", "acc", backend="auto") is not None

    df = pd.concat([df, df.assign(acc=df.acc + 0.1)])  # two runs' rows a point: a band
    traces = []

    class StubGo:
        class Figure:
            def add_trace(self, t):
                traces.append(t)

            def update_layout(self, **kw):
                self.layout = kw

        @staticmethod
        def Scatter(**kw):
            return kw

    monkeypatch.setattr(tplots, "_plotly", lambda: StubGo)
    fig = tplots.nice_plot(df, "epoch", "acc", group_by="run", backend="plotly")
    assert isinstance(fig, StubGo.Figure) and len(traces) == 4  # mean + band per run
