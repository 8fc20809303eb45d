"""Compute-path ops: dict-of-tensor tree algebra for FL aggregation, and the
wrappers of the three hand-written Hopper kernels of the ViT hot path
(``patch_embed``, ``attention``, ``mlp_block``; sources in ``../csrc``).

f32 means f32: importing this package turns TF32 off for matrix products and
for cuDNN. The JAX package contracts the coalition mixing and the LoRA fold
at ``precision="highest"`` (tree_math.py:137-141, :212-214; vit.py:440-445),
and its float32 parity runs are float32 throughout; on the card PyTorch
would otherwise run float32 convolutions (and, where enabled, matrix
products) in TF32, which keeps about three decimal digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
