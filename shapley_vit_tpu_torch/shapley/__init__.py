"""Contribution / Shapley layer: the Game, the estimators, the compared
multi-round methods, the MILP round selection and the multi-round utilities
(numpy copies of ``shapley_vit_tpu.shapley``, exporting the same names).

``Game`` caches coalition utilities and drives ONE batched coalition-eval
primitive; estimators sample coalitions first, batch-evaluate the distinct
ones, then do the scoring arithmetic on the host.
"""

from shapley_vit_tpu_torch.shapley.game import Game, TabularGame  # noqa: F401
from shapley_vit_tpu_torch.shapley.estimators import (  # noqa: F401
    call_shapley_computation_method,
    run_configured_comp_contrib,
    powerset,
    ncr,
    shapley_exact,
    shapley_exact_own,
    shapley_monte_carlo,
    shapley_comp_contrib,
    shapley_comp_contrib_adaptive,
    shapley_owen,
    shapley_kernel,
    shapley_beta,
    banzhaf_value,
    split_permutation,
    split_permutation_num,
    split_num,
)
from shapley_vit_tpu_torch.shapley.compared_methods import (  # noqa: F401
    Fed_SV,
    GTG,
    MR,
    TMR,
    comfedsv,
    call_comfedsv,
    shapley_value,
)
from shapley_vit_tpu_torch.shapley.milp import (  # noqa: F401
    MILP_Shapley,
    MILP_Shapley_Two_Sided,
    MILP_Shapley_Two_Sided_Approx,
    MILP_Shapley_prev,
    binary_search,
)
from shapley_vit_tpu_torch.shapley.fed_shapley import (  # noqa: F401
    all_subsets_enumeration,
    compute_shapley_corrected,
    compute_utilities_lazy,
    get_optimal_subset,
    get_optimal_subset_multi_objectives,
)
