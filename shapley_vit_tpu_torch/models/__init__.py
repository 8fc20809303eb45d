"""Model layer: the functional ViT with a LoRA overlay (the live-path model)
and the weight conversion/carrier between numpy, peft and this package."""

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
