"""chip_smoke's ``mesh_train`` and ``zoo`` phases rehearsed on the CPU at a
small size (micro ViT at 16 px, 4 clients of 8 images; a depth-2 ConvNet,
an MLP and a ConvNetBN on a CIFAR-10 of 40 images a pickle batch), where the plain versions
run and nothing is launched: the phases' control flow, the sharded step's
agreement with the single-device one (losses and overlays within 1e-5
relative in float32) and the zoo's checks. On the card the same functions
also hold the launches and their routes."""

import os
import sys

import torch

from shapley_vit_tpu_torch.config import Config
from shapley_vit_tpu_torch.ops.attention import fused_attention
from shapley_vit_tpu_torch.ops.patch_embed import patch_embed
from torch_one_thread import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402


def test_mesh_train_phase_rehearsed_on_the_cpu(capsys):
    cfg = Config()
    cfg.model.vit_variant, cfg.data.image_size = "micro", 16
    smoke.phase_mesh_train((patch_embed, fused_attention), cfg=cfg, device="cpu", batch=8)
    line = [l for l in capsys.readouterr().out.splitlines() if '"mesh_train"' in l][-1]
    assert '"ok": true' in line


def test_zoo_phase_rehearsed_on_the_cpu(tmp_path):
    out = smoke.phase_zoo(device="cpu", work=str(tmp_path), per_batch=40, cent_epochs=1,
                          logit_models=("ConvNetD2",), cent_model="MLP",
                          coalition_model="ConvNetBN")
    assert out["ok"] and out["coalition_round"]["accuracies_equal"]
    assert out["cent_sgd"]["checkpoint"] and out["cent_sgd"]["train_images_per_s"] > 0
    assert out["cent_sgd"]["train_images"] == 200 and out["cent_sgd"]["test_images"] == 20
    assert out["coalition_round"]["validation_images"] == 20
    assert torch.get_num_threads() == 1
