"""Data layer: array-backed datasets, the OCT folder loader and the dataset
registry's OCT entry (copies of the ``shapley_vit_tpu.data`` parts the
Shapley round uses)."""

from shapley_vit_tpu_torch.data.arrays import ArrayDataset, batches  # noqa: F401
from shapley_vit_tpu_torch.data.oct import CellDataset  # noqa: F401
from shapley_vit_tpu_torch.data.registry import get_dataset  # noqa: F401
