"""The LayerNorm wrapper (``ops/layer_norm``) and its route in the ViT forward,
on the CPU.

A CPU tensor runs ``layer_norm_plain``, which must be the torch-op LN the
forward had before the kernel, bit for bit, also where it normalises the
rows of an expanded tensor once. The eval spec (``mlp_impl="pallas"``)
sends the LN before attention and the final LN through the wrapper, the
training spec through the torch ops; the final LN normalises the CLS rows
alone, which must change no logit and no gradient. The kernel itself is held
against ``layer_norm_plain`` on the card (``test_torch_kernels.py``).
"""

import pytest
import torch

from shapley_vit_tpu_torch.driver.client import TRAIN_SPEC
from shapley_vit_tpu_torch.fl import training as ttr
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.ops import layer_norm as tln
from shapley_vit_tpu_torch.ops.tree_math import tree_leaves, tree_map
from torch_one_thread import one_torch_thread  # noqa: F401

EPS = 1e-12


def _old_layer_norm(x, scale, bias, eps):
    """``models.vit._layer_norm`` as it was before the kernel."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _ln_inputs(D, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((3, 5, 7, D), generator=gen) * 2 + 0.5).to(dtype)
    scale = 1 + 0.1 * torch.randn((D,), generator=gen)
    bias = 0.1 * torch.randn((D,), generator=gen)
    return x, scale, bias


@pytest.mark.parametrize("layout", ["contiguous", "expanded", "cls_rows"])
@pytest.mark.parametrize("D", [32, 36, 768])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_layer_norm_is_the_old_arithmetic(dtype, D, layout):
    x, scale, bias = _ln_inputs(D, dtype)
    if layout == "expanded":  # the embedding over the coalitions: stride 0
        x = x[0].unsqueeze(0).expand(4, *x.shape[1:])
    elif layout == "cls_rows":  # the final LN's rows: a strided view
        x = x[:, :, 0]
    got = tln.layer_norm(x, scale, bias, EPS)
    want = _old_layer_norm(x, scale, bias, EPS)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want)
    assert tln.layer_norm.launches == 0  # a CPU tensor launches nothing


def test_layer_norm_refuses_a_gradient():
    x, scale, bias = _ln_inputs(32, torch.float32)
    with pytest.raises(RuntimeError, match="layer_norm is forward only"):
        tln.layer_norm(x.requires_grad_(), scale, bias, EPS)
    with torch.no_grad():
        tln.layer_norm(x, scale, bias, EPS)


def _model(dtype="float32", seed=0, **over):
    spec = tvit.make_spec("micro", dtype=dtype, **over)
    gen = torch.Generator().manual_seed(seed)
    base = tvit.init_vit(gen, spec)
    # LN scales and biases away from 1 and 0, so that a wrong one shows
    for ln in (base["blocks"]["ln1"], base["final_ln"]):
        ln["scale"] = ln["scale"] + 0.1 * torch.randn(ln["scale"].shape, generator=gen)
        ln["bias"] = ln["bias"] + 0.1 * torch.randn(ln["bias"].shape, generator=gen)
    lora = tvit.init_lora(gen, spec, classifier_from=base)
    lora = tree_map(lambda a: a + 0.05 * torch.randn(a.shape, generator=gen), lora)
    images = torch.randn((3, spec.image, spec.image, spec.channels), generator=gen)
    return spec, base, lora, images


def _stacked(lora, C=3):
    return tree_map(lambda a: torch.stack([a * (1 + 0.5 * c) for c in range(C)]), lora)


def _old_forward(base, images, spec, C, lora_blocks=None, q_kernel=None, v_kernel=None,
                 head=None):
    """``models.vit._forward`` as it was: the torch-op LN before attention
    (over the C-fold expanded embedding in the first block) and the final LN
    over every token."""
    x0 = tvit._embed(base, images, spec)
    x = x0.unsqueeze(0).expand(C, *x0.shape)
    for layer in range(spec.depth):
        blk = tree_map(lambda a: a[layer], base["blocks"])
        lora_l = tree_map(lambda a: a[:, layer], lora_blocks) if lora_blocks is not None else None
        x = tvit._block(x, blk, lora_l, spec,
                        q_kernel[:, layer] if q_kernel is not None else None,
                        v_kernel[:, layer] if v_kernel is not None else None)
    x = _old_layer_norm(x, base["final_ln"]["scale"], base["final_ln"]["bias"],
                        spec.layernorm_eps)
    head = head if head is not None else base["classifier"]
    return tvit._dense(x[:, :, 0], head["kernel"], head["bias"]).float()


def _eval(mode, spec, base, lora):
    """The eval forward of three coalitions by ``mode``: the new forward
    and the old one, as ``(new, old)`` callables of the images."""
    stacked = _stacked(lora)
    if mode == "merged":
        merged = tvit.merge_coalition_weights(base, stacked, spec)
        return (lambda im: tvit.vit_forward_merged(base, merged, im, spec),
                lambda im: _old_forward(base, im, spec, 3, q_kernel=merged["q_kernel"],
                                        v_kernel=merged["v_kernel"], head=merged["classifier"]))
    return (lambda im: tvit.vit_forward_coalitions(base, stacked, im, spec),
            lambda im: _old_forward(base, im, spec, 3, lora_blocks=stacked["lora"],
                                    head=stacked["classifier"]))


@pytest.mark.parametrize("dtype,mode", [("bfloat16", "merged"), ("bfloat16", "overlay"),
                                        ("float32", "merged"), ("float32", "overlay")])
def test_eval_logits_equal_the_all_rows_version(dtype, mode, monkeypatch):
    spec, base, lora, images = _model(dtype)
    new, old = _eval(mode, spec, base, lora)
    with torch.no_grad():
        got = new(images)
        with monkeypatch.context() as m:  # the old forward's LN before attention: torch ops
            m.setattr(tvit, "layer_norm", _old_layer_norm)
            want = old(images)
    assert got.shape == (3, images.shape[0], spec.num_classes)
    assert torch.equal(got, want)


def _count_calls(monkeypatch):
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return tln.layer_norm(*args)

    monkeypatch.setattr(tvit, "layer_norm", counted)
    return calls


@pytest.mark.parametrize("mode", ["merged", "overlay"])
def test_eval_forward_takes_the_wrapper_depth_plus_one_times(mode, monkeypatch):
    spec, base, lora, images = _model("bfloat16")
    calls = _count_calls(monkeypatch)
    new, _ = _eval(mode, spec, base, lora)
    with torch.no_grad():
        new(images)
    B, N, D = images.shape[0], spec.seq_len, spec.hidden
    assert len(calls) == spec.depth + 1
    # the first block's input is the embedding expanded over the coalitions;
    # the final LN takes the CLS rows alone
    assert calls[:spec.depth] == [(3, B, N, D)] * spec.depth
    assert calls[-1] == (3, B, D)


@pytest.mark.parametrize("remat", [False, True])
def test_training_spec_takes_the_torch_ops_and_keeps_its_gradient(remat, monkeypatch):
    spec, base, lora, images = _model(**TRAIN_SPEC, remat=remat)
    labels = torch.tensor([0, 3, 1])
    calls = _count_calls(monkeypatch)
    grads = []
    for forward in ("new", "old"):
        tl = ttr.trainable(lora)
        if forward == "new":
            logits = tvit.vit_forward(base, tl, images, spec)
        else:
            stacked = tree_map(lambda a: a[None], tl)
            logits = _old_forward(base, images, spec, 1, lora_blocks=stacked["lora"],
                                  head=stacked["classifier"])[0]
        ttr.cross_entropy(logits, labels).backward()
        grads.append([t.grad for t in tree_leaves(tl)])
    assert calls == []
    assert all(float(g.abs().max()) > 0 for g in grads[0])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
