"""The model seam: a configuration's family is found by its ``"reference"``
name, and what the harness draws, counts and groups comes from that family.
A toy family, put in ``sys.modules`` as ``bench_port.families.toy`` (no file
is written), wraps the ViT family with a kernel family of its own
(``toy_block``) and counts of its own."""

import os
import sys
import types

import pytest
import torch

from bench_port.families import vit
from bench_port.lib import inputs, trace
from bench_port.references import vit as vit_reference
from conftest import BENCH, run_tiny, tiny_context

# the toy's operations of an evaluation call, per image and coalition
TOY_FLOPS = 3.0


def _toy_module():
    toy = types.ModuleType("bench_port.families.toy")
    for name in ("spec", "forward", "dims", "base", "train_step_flops", "WRAPPERS", "TINY"):
        setattr(toy, name, getattr(vit, name))
    toy.KERNEL_FAMILIES = ("patch_embed", "attention", "toy_block")

    def kernel_calls(cfg, sequences, itemsize):
        calls = vit.kernel_calls(cfg, sequences, itemsize)
        flops, nbytes = calls.pop("mlp_block")
        return {"toy_block": (2 * flops, nbytes), **calls}

    def coalition_eval_flops(cfg, images, coalitions):
        return TOY_FLOPS * images * coalitions

    toy.kernel_calls = kernel_calls
    toy.coalition_eval_flops = coalition_eval_flops
    return toy


@pytest.fixture
def toy(monkeypatch):
    for sub in ("families", "references"):
        assert not os.path.exists(os.path.join(BENCH, sub, "toy.py"))
    module = _toy_module()
    monkeypatch.setitem(sys.modules, "bench_port.families.toy", module)
    monkeypatch.setitem(sys.modules, "bench_port.references.toy", vit_reference)
    return module


def test_whole_cell_runs_through_the_toy_family(toy, one_thread):
    ctx = tiny_context("vitb16-n3", trace=True, overrides={"rounds": 2})
    ctx.config["reference"] = "toy"
    assert ctx.family() is toy
    out, line = run_tiny(ctx)
    assert line["correct"], line["checks"]
    work = out.facts["traced_work"]
    assert list(work) == ["toy_block", "attention"]
    assert work["toy_block"]["calls"] == work["attention"]["calls"] > 0
    assert set(out.trace.by_group) == {"patch_embed", "attention", "toy_block", "matrix_products",
                                       "other"}
    n_val = ctx.config["validation_images"]
    assert out.facts["window_flops"] == TOY_FLOPS * out.facts["evaluations"] * n_val
    vit_count = sum(vit.coalition_eval_flops(ctx.config, n_val, 1) for _ in range(out.facts["evaluations"]))
    assert out.facts["window_flops"] != pytest.approx(vit_count)


def test_classifier_width_comes_from_head_in():
    conf = dict(vit.TINY, num_channels=3, num_labels=4, lora_r=4)
    d = dict(vit.dims(conf))
    D, K = d["D"], d["K"]
    d["head_in"] = 2 * D  # a head on CLS and the patch rows' mean, as DINOv2's
    gen = inputs.generator(2**31 + 25, "cpu")
    base = {"classifier": {"kernel": torch.zeros(2 * D, K), "bias": torch.zeros(K)}}
    init = inputs.init_overlay(d, base, gen, "cpu")
    assert tuple(init["classifier"]["kernel"].shape) == (2 * D, K)
    for delta in inputs.client_deltas(d, 3, gen, "cpu", {"A": 0.02, "B": 0.1, "classifier": 0.05}):
        assert delta["classifier"]["kernel"].shape == (2 * D, K)
        assert delta["lora"]["q"]["A"].shape == (d["L"], D, d["r"])
    narrow = {"classifier": {"kernel": torch.zeros(D, K), "bias": torch.zeros(K)}}
    with pytest.raises(ValueError, match="classifier"):
        inputs.init_overlay(d, narrow, gen, "cpu")


def test_trace_grouping_comes_from_the_family(toy):
    name = "void svt_toy_block_kernel<128, 64>(__nv_bfloat16 const*, float*, int)"
    assert trace.group_of(name, toy.KERNEL_FAMILIES) == "toy_block"
    assert trace.group_of(name, vit.KERNEL_FAMILIES) == "other"
    assert trace.group_of("mlp_block_wgmma_kernel", vit.KERNEL_FAMILIES) == "mlp_block"
    assert trace.group_of("sm90_xmma_gemm_bf16", toy.KERNEL_FAMILIES) == "matrix_products"
