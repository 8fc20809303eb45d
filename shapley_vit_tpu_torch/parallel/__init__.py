"""Parallelism layer: the ``(coalition, data)`` device grid and coalition
evaluation sharded over it, on one process or a ``torch.distributed`` world
(the port of ``shapley_vit_tpu/parallel``)."""

from shapley_vit_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    replicated,
    shard_batch,
    shard_coalitions,
)
from shapley_vit_tpu_torch.parallel.coalition_eval import (  # noqa: F401
    EvalBackend,
    make_eval_backend,
    make_sharded_coalition_evaluator,
    shard_batches,
)
