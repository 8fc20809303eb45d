"""Evaluation extras: fairness metrics, richer classification metrics and
the confusion matrix (the port of ``shapley_vit_tpu/utils/eval_metrics.py``).

Reference: ``federated_learning/utils.py:928-1043``
(``evaluation_statistical_parity``, ``evaluation_group_fairness``,
``get_metrics`` acc/AUC/balanced-acc, ``compute_accuracy`` + confusion
matrix). The model forward runs on the model's device; the metrics run on
host numpy. The JAX package calls sklearn for them; the port computes them
in numpy (sklearn is not one of its dependencies): accuracy, balanced accuracy
(the mean recall over the classes present in the labels), one-vs-rest AUC
(each class's Mann-Whitney statistic with ties given their average rank,
as ``roc_auc_score`` does; macro average) and the confusion matrix over
the sorted union of labels and predictions.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from shapley_vit_tpu_torch.data.arrays import ArrayDataset, batches as make_batches
from shapley_vit_tpu_torch.fl.evaluation import evaluate_model
from shapley_vit_tpu_torch.ops.tree_math import tree_leaves


def _device(params) -> torch.device:
    """Where ``params`` live (the forward's inputs go there)."""
    for leaf in tree_leaves(params):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _on(device, images, labels):
    return (torch.as_tensor(np.asarray(images), device=device),
            torch.as_tensor(np.asarray(labels), device=device))


def collect_logits(
    forward_fn: Callable, params, ds: ArrayDataset, batch_size: int = 128
) -> Tuple[np.ndarray, np.ndarray]:
    """Run ``forward_fn(params, images)`` over a dataset on the device of
    ``params``; gather the logits and labels on the host."""
    dev = _device(params)
    logits_all = []
    with torch.inference_mode():
        for images, _ in make_batches(ds, batch_size):
            x = torch.as_tensor(np.asarray(images), device=dev)
            logits_all.append(forward_fn(params, x).float().cpu().numpy())
    return np.concatenate(logits_all, axis=0), np.asarray(ds.labels)


def statistical_parity_gap(
    forward_fn: Callable, params, group_datasets: Sequence[ArrayDataset],
    positive_class: int = 1, batch_size: int = 128,
) -> float:
    """Max-min positive-prediction rate across sensitive groups
    (utils.py:928-950: only class==1 counts as a positive prediction)."""
    rates = []
    for ds in group_datasets:
        logits, _ = collect_logits(forward_fn, params, ds, batch_size)
        rates.append(float((logits.argmax(axis=1) == positive_class).mean()))
    rates = np.asarray(rates)
    return float(rates.max() - rates.min())


def group_fairness_gaps(
    forward_fn: Callable, params, group_datasets: Sequence[ArrayDataset],
    batch_size: int = 128,
) -> Tuple[float, float]:
    """(max-min accuracy, max-min loss) across groups (utils.py:953-966)."""
    dev = _device(params)
    accs, losses = [], []
    for ds in group_datasets:
        acc, loss = evaluate_model(
            forward_fn, params, (_on(dev, x, y) for x, y in make_batches(ds, batch_size)),
            dataset_size=len(ds),
        )
        accs.append(acc)
        losses.append(loss)
    accs, losses = np.asarray(accs), np.asarray(losses)
    return float(accs.max() - accs.min()), float(losses.max() - losses.min())


def _logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=1, keepdims=True))


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks of ``x``, ties sharing their average rank."""
    order = np.argsort(x, kind="mergesort")
    sx = x[order]
    bounds = np.concatenate(([0], np.nonzero(np.diff(sx))[0] + 1, [len(x)]))
    ranks = np.empty(len(x), np.float64)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        ranks[order[lo:hi]] = 0.5 * (lo + 1 + hi)
    return ranks


def binary_auc(y_true: np.ndarray, score: np.ndarray) -> float:
    """ROC AUC of ``score`` for ``y_true`` (booleans): the Mann-Whitney U
    over the positives' average ranks (``roc_auc_score``'s value, ties
    counting one half)."""
    y_true = np.asarray(y_true, bool)
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Only one class present in y_true. ROC AUC score is not defined "
                         "in that case.")
    ranks = _average_ranks(np.asarray(score, np.float64))
    return float((ranks[y_true].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def roc_auc_ovr(labels: np.ndarray, prob: np.ndarray) -> float:
    """Macro one-vs-rest AUC over the classes in ``labels``, which must be
    as many as the columns of ``prob`` (``roc_auc_score(...,
    multi_class="ovr")``)."""
    classes = np.unique(labels)
    if len(classes) != prob.shape[1]:
        raise ValueError("Number of classes in y_true not equal to the number of columns "
                         "in 'y_score'")
    return float(np.mean([binary_auc(labels == c, prob[:, i]) for i, c in enumerate(classes)]))


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    """Counts ``[true, predicted]`` over the sorted union of the labels seen
    in either (``sklearn.metrics.confusion_matrix``)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    classes = np.union1d(y_true, y_pred)
    t, p = np.searchsorted(classes, y_true), np.searchsorted(classes, y_pred)
    cm = np.zeros((len(classes), len(classes)), np.int64)
    np.add.at(cm, (t, p), 1)
    return cm


def balanced_accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Mean recall over the classes present in ``y_true``."""
    cm = confusion_matrix(y_true, y_pred)
    support = cm.sum(axis=1)
    present = support > 0
    return float(np.mean(np.diag(cm)[present] / support[present]))


def get_metrics(logits: np.ndarray, labels: np.ndarray):
    """(loss, acc, auc, balanced_acc) from gathered logits
    (utils.py:969-994, including its quirk of feeding log-probabilities
    back through CrossEntropyLoss: a double log-softmax on the loss)."""
    logits = np.asarray(logits, dtype=np.float64)
    labels = np.asarray(labels)
    logp = logits - _logsumexp(logits)
    # reference: criterion(log_softmax(logits), y) -> CE over log-probs
    logp2 = logp - _logsumexp(logp)
    loss = float(-logp2[np.arange(len(labels)), labels].sum() / len(labels))

    pred = logp.argmax(axis=1)
    prob = np.exp(logp)
    acc = float((pred == labels).mean())
    bal_acc = balanced_accuracy(labels, pred)
    if prob.shape[1] == 2:
        auc = binary_auc(labels == np.max(labels), prob[:, 1])
    else:
        auc = roc_auc_ovr(labels, prob)
    return loss, acc, float(auc), bal_acc


def compute_accuracy(
    forward_fn: Callable, params, datasets, get_confusion_matrix: bool = False,
    batch_size: int = 128,
):
    """Accuracy (+ optional confusion matrix) over one or several datasets
    (utils.py:997-1043)."""
    if isinstance(datasets, ArrayDataset):
        datasets = [datasets]
    preds: List[np.ndarray] = []
    trues: List[np.ndarray] = []
    for ds in datasets:
        logits, labels = collect_logits(forward_fn, params, ds, batch_size)
        preds.append(logits.argmax(axis=1))
        trues.append(labels)
    preds_all = np.concatenate(preds)
    trues_all = np.concatenate(trues)
    acc = float((preds_all == trues_all).mean())
    if get_confusion_matrix:
        return acc, confusion_matrix(trues_all, preds_all)
    return acc
