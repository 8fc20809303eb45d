"""Model layer: the functional ViT with a LoRA overlay (the live-path model),
the weight conversion/carrier between numpy, peft, flax and this package,
Inception-v3 with its defense, and the reference's model zoo
(``models.zoo``)."""

from shapley_vit_tpu_torch.models.vit import (  # noqa: F401
    VIT_VARIANTS,
    ViTSpec,
    init_lora,
    init_vit,
    make_spec,
    merge_lora,
    trainable_params,
    vit_forward,
)
