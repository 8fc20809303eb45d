"""Contribution / Shapley layer: the Game and the estimators the Shapley
round runs (numpy copies of ``shapley_vit_tpu.shapley``)."""

from shapley_vit_tpu_torch.shapley.game import Game, TabularGame  # noqa: F401
from shapley_vit_tpu_torch.shapley.estimators import (  # noqa: F401
    call_shapley_computation_method,
    ncr,
    powerset,
    run_configured_comp_contrib,
    shapley_comp_contrib,
    shapley_comp_contrib_adaptive,
    shapley_exact,
)
