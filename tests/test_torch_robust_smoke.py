"""``chip_smoke.py``'s ``robust`` phase rehearsed on the CPU at the micro ViT.

The same runs and checks as on the card (FGSM, PGD-10 inside the ε-ball and
[0, 1], the multi-ε sweep, the float32 FGSM and saliency maps held against
the CPU, the saliency image events, the Inception-v3 defense and a defended
FGSM), at 16 px with a small Denoise and Inception3 at 75 px; all but the
launch counts, which hold only where the kernels launch.
"""

import importlib.util
import json
import os

from shapley_vit_tpu_torch.config import Config
from shapley_vit_tpu_torch.ops.attention import fused_attention, fused_attention_packed
from shapley_vit_tpu_torch.ops.mlp_block import fused_mlp_block
from shapley_vit_tpu_torch.ops.patch_embed import patch_embed


def test_chip_smoke_robust_phase_holds_on_the_cpu(capsys):
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = Config()
    cfg.model.vit_variant, cfg.model.compute_dtype = "micro", "float32"
    cfg.data.synthetic_scale = 0.1  # 40 validation images
    cfg.data.eval_batch_size = 16
    smoke.phase_robust((patch_embed, fused_attention_packed, fused_mlp_block, fused_attention),
                       cfg=cfg, device="cpu")
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith('{"phase": "robust"')]
    out = json.loads(line[-1])
    assert out["ok"], out["checks"]
    assert out["validation_images"] == 40 and out["pgd"]["steps"] == 10
    assert out["pgd"]["max_dist_from_clean"] <= smoke.ROBUST_EPS + 1e-6
    assert out["fgsm"]["adv_loss"] > out["fgsm"]["clean_loss"]
    assert out["interpretability"]["tensorboard_events"] == [
        f"saliency/grad_cam/img_{i}" for i in range(4)]
