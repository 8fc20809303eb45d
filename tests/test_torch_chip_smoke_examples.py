"""chip_smoke's ``examples`` and ``condense`` phases rehearsed on the CPU at
a small size (the quickstart and the service demo on the micro ViT at 16
px; a depth-2 ConvNet at 16 px, 8 real and 2 synthetic images a class, 32
images for the representation metrics), where the plain versions run and
nothing is launched: the phases' control flow and their checks (on the
CPU the "card" run of ``condense_run`` is a second CPU run). On the card
the same functions also hold the launches."""

import os
import sys

from shapley_vit_tpu_torch.examples import serve_demo
from shapley_vit_tpu_torch.ops.attention import fused_attention, fused_attention_packed
from shapley_vit_tpu_torch.ops.mlp_block import fused_mlp_block
from shapley_vit_tpu_torch.ops.patch_embed import patch_embed
from torch_one_thread import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402

COUNTED = (patch_embed, fused_attention_packed, fused_mlp_block, fused_attention)


def test_examples_phase_rehearsed_on_the_cpu(tmp_path, capsys):
    by = smoke.phase_examples(COUNTED, device="cpu", variant="micro", val_size=16, batch=8,
                              demo_cfg=serve_demo.demo_config(out_dir=str(tmp_path)))
    assert set(by) == {fn.__name__ for fn in COUNTED}
    line = [l for l in capsys.readouterr().out.splitlines() if '"phase": "examples"' in l][-1]
    assert '"ok": true' in line
    assert os.path.exists(tmp_path / "global" / "ViT_global_epoch_2.npz")


def test_condense_phase_rehearsed_on_the_cpu():
    out = smoke.phase_condense(device="cpu", model="ConvNetD2", im=16, n_real=8, ipc=2, n_rep=32)
    assert out["ok"] and out["representation"]["guard_restored"]
    assert len(out["match_losses"]) == 10 and out["representation"]["features"] == 2048
    assert out["vs_cpu"]["syn_grad_rel"] == 0.0  # two CPU runs from the same inputs
    assert out["vs_cpu"]["syn_grad_rel_float64"] == 0.0
