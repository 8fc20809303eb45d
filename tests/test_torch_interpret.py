"""The port's interpretability (``models/interpret.py``) and the device half of
``driver.report.render_saliency`` against ``shapley_vit_tpu.models.interpret``
at float32 on the CPU.

A micro ViT whose weights come from the JAX package's initializers, with a
non-zero LoRA overlay, carried over as numpy. Tolerances: the collecting
forward's logits and tokens within 2e-5 (the house parity bar), its
attention probabilities within 1e-6 (each row a float32 softmax); the
rollout and Grad-CAM maps within 1e-4 (maps normalized to [0, 1] by their
own range, which magnifies float32 rounding by 1/range).
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from shapley_vit_tpu.models import interpret as jint
from shapley_vit_tpu.models import vit as jvit
from shapley_vit_tpu_torch.driver import report
from shapley_vit_tpu_torch.models import interpret as tint
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from shapley_vit_tpu_torch.utils import tb_events
from shapley_vit_tpu_torch.utils.logging import TensorBoardWriter


@pytest.fixture(scope="module")
def micro():
    spec_j = jvit.make_spec("micro", num_classes=4)
    spec_t = tvit.make_spec("micro", num_classes=4)
    base = jax.device_get(jvit.init_vit(jax.random.key(0), spec_j))
    lora = jax.device_get(jvit.init_lora(jax.random.key(1), spec_j, classifier_from=base))
    rng = np.random.default_rng(2)
    lora = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
                        lora)
    images = rng.uniform(size=(3, 16, 16, 3)).astype(np.float32)
    return dict(spec_j=spec_j, spec_t=spec_t, base=base, lora=lora, images=images,
                tbase=tree_from_numpy(base), tlora=tree_from_numpy(lora))


@pytest.mark.parametrize("overlay", [True, False])
def test_forward_collect_matches_jax(micro, overlay):
    m = micro
    lora, tlora = (m["lora"], m["tlora"]) if overlay else (None, None)
    logits, probs, tokens = jint._forward_collect(m["base"], lora, m["images"], m["spec_j"])
    got = tint._forward_collect(m["tbase"], tlora, torch.tensor(m["images"]), m["spec_t"])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(logits), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(probs), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(tokens), atol=2e-5, rtol=0)
    L, B, H, N, _ = got[1].shape
    assert (L, B, H, N) == (m["spec_t"].depth, 3, m["spec_t"].heads, m["spec_t"].seq_len)
    np.testing.assert_allclose(got[1].sum(-1).numpy(), 1.0, atol=1e-5)
    # at the default exact-f32 GELU with no quantization, vit_forward's logits
    ref = tvit.vit_forward(m["tbase"], tlora, torch.tensor(m["images"]), m["spec_t"])
    np.testing.assert_allclose(got[0].numpy(), ref.numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("head_fuse", ["mean", "max"])
def test_attention_rollout_matches_jax(micro, head_fuse):
    m = micro
    want = np.asarray(jint.attention_rollout(m["base"], m["lora"], m["images"], m["spec_j"],
                                             head_fuse=head_fuse))
    got = tint.attention_rollout(m["tbase"], m["tlora"], torch.tensor(m["images"]), m["spec_t"],
                                 head_fuse=head_fuse).numpy()
    assert got.shape == (3, 4, 4) and got.min() >= 0 and got.max() <= 1 + 1e-6
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_attention_rollout_refuses_an_unknown_fusion(micro):
    m = micro
    with pytest.raises(ValueError, match="head_fuse"):
        tint.attention_rollout(m["tbase"], None, torch.tensor(m["images"]), m["spec_t"],
                               head_fuse="median")


@pytest.mark.parametrize("class_idx", [None, np.array([1, 2, 0])])
def test_grad_cam_matches_jax(micro, class_idx):
    m = micro
    want = np.asarray(jint.grad_cam(m["base"], m["lora"], m["images"], m["spec_j"],
                                    class_idx=class_idx))
    got = tint.grad_cam(m["tbase"], m["tlora"], torch.tensor(m["images"]), m["spec_t"],
                        class_idx=None if class_idx is None else torch.tensor(class_idx)).numpy()
    assert got.shape == (3, 4, 4) and got.min() >= 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_grad_cam_runs_inside_inference_mode(micro):
    """The drivers evaluate under ``torch.inference_mode``; Grad-CAM called
    there, on weights made there, gives the same map."""
    m = micro
    want = tint.grad_cam(m["tbase"], m["tlora"], torch.tensor(m["images"]), m["spec_t"])
    with torch.inference_mode():
        base = tree_from_numpy(m["base"])
        got = tint.grad_cam(base, tree_from_numpy(m["lora"]), torch.tensor(m["images"]),
                            m["spec_t"])
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("method", ["grad_cam", "attention_rollout"])
def test_render_saliency_writes_the_png_and_four_image_events(micro, tmp_path, method):
    m = micro
    images = np.random.default_rng(4).uniform(size=(5, 16, 16, 3)).astype(np.float32)
    tb = TensorBoardWriter(str(tmp_path / "tb"))
    assert tb.active
    path = report.render_saliency(str(tmp_path / "sal"), m["tbase"], m["tlora"], images,
                                  m["spec_t"], round_idx=3, method=method, tb=tb)
    tb.close()
    assert path == str(tmp_path / "sal" / "saliency_r3.png") and os.path.getsize(path) > 0
    (events,) = glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    got = tb_events.read_image_events(events)
    assert [e[0] for e in got] == [f"saliency/{method}/img_{i}" for i in range(4)]
    fn = jint.grad_cam if method == "grad_cam" else jint.attention_rollout
    want_maps = np.asarray(fn(m["base"], m["lora"], images[:4], m["spec_j"]))
    for (tag, h, w, c, png, step), img, sal in zip(got, images, want_maps):
        assert (h, w, c, step) == (16, 16, 3, 3)
        pix = tb_events.decode_png(png)
        assert pix.shape == (16, 16, 3)
        # the blend of the image and the red/blue heat map of the JAX map
        s = np.kron(sal, np.ones((4, 4)))
        span = s.max() - s.min()
        s = (s - s.min()) / span if span > 0 else np.zeros_like(s)
        heat = np.stack([s, np.zeros_like(s), 1 - s], axis=-1)
        want = np.clip(0.6 * img + 0.4 * heat, 0, 1) * 255
        assert np.abs(pix.astype(np.float64) - want).max() <= 1.0
