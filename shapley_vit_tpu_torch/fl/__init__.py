"""Federated-learning core: the evaluation primitive (single-model and
coalition-batched), checkpoint ingestion, client records and the resumable
utility table (ports of ``shapley_vit_tpu.fl``)."""

from shapley_vit_tpu_torch.fl.client import EvalClient  # noqa: F401
from shapley_vit_tpu_torch.fl.evaluation import (  # noqa: F401
    eval_step_metrics,
    evaluate_model,
    make_coalition_evaluator,
)
