"""Data layer: array-backed datasets, the OCT folder loader, the native
dataset formats, the medical loaders, the batch pipeline and the dataset
registry (copies of ``shapley_vit_tpu.data``'s modules; condensation is
not ported yet)."""

from shapley_vit_tpu_torch.data.arrays import ArrayDataset, batches  # noqa: F401
from shapley_vit_tpu_torch.data.oct import CellDataset  # noqa: F401
from shapley_vit_tpu_torch.data.registry import get_dataset  # noqa: F401
