"""Client records (the port of ``shapley_vit_tpu/fl/client.py``).

``EvalClient`` is the stateless eval-side record (reference
``client2.py:7-42`` ClientBase: id, train set handle, ``num_local_data_train``
driving FedAvg weights)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

Tree = Any


@dataclass
class EvalClient:
    """Eval-only client (reference client2.py ClientBase).

    ``num_local_data_train`` drives the FedAvg ratio (server2.py:68-81);
    ``delta`` is this client's weight delta vs. the initial global model
    (start.py:163 via get_difference_between_network_weights) as a tree.
    """

    client_id: int
    num_local_data_train: int
    delta: Optional[Tree] = None
    train_set: Any = None
    metadata: dict = field(default_factory=dict)

    @property
    def model_weights(self) -> Optional[Tree]:
        """Stand-in for client2.py's deepcopy property: the delta is never
        mutated in place, so no copy is needed."""
        return self.delta
