"""Golden pins of what the harness draws and counts for each configuration
that the benchmark ran when the model families were split out of the
harness's shared files (``vit-b16``, ``vit-l16``; a family added later pins
its own in a file of its own).

Every pinned value was computed on the commit before that split, with the
harness's own functions of then (``inputs.vit_base``, ``inputs.init_overlay``,
``inputs.images``, ``inputs.client_deltas``, ``counts.*``, and the traced
work that ``traffic/shapley_round.py`` counted), so a pin that moves means
the split changed a draw, its order, or a count. The digests are of float32
draws on the CPU from one seed, at the family's ``TINY`` sizes, in the
order ``traffic/shapley_round.py`` draws them: base, overlay, images, one
delta set of the ``rounds-n3`` mix; the counts are at the published widths.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from bench_port.lib import cell, inputs
from conftest import ROOT, run_tiny, tiny_context

SEED = 2**31 + 2501

PINS = {
    "vit-b16": {
        "digests": {
            "base": "75bd11a62386cd01fad85a386681ab11393107b646a073c2a089c803e3678ccd",
            "overlay": "0326a91c9b1ed725abd3932283babcba3ef5889d528e2fb0b32f9fdef3319419",
            "deltas": "a3ffe571860ba240f7106c63302053952bb9ba5b8bc958c1d6e4306ac1f9a71d",
            "images": "339196abe022e24f711ae3966c5f7de7d600ffcfbd929de0e62984bf29d4a678",
        },
        "counts": {
            "coalition_eval_flops_128_7": 31295439372288.0,
            "encoder_flops_per_image": 34894909440.0,
            "patch_flops_1": 231211008.0,
            "head_flops_per_image": 6144.0,
            "train_step_flops_64": 4568474222592.0,
        },
        # (sequences, itemsize): each kernel family's (operations, bytes)
        "kernel_calls": {
            (896, 2): {"mlp_block": (1665776222208.0, 551692800),
                       "attention": (106822238208.0, 1084489728.0)},
            (3, 4): {"mlp_block": (5577375744.0, 22526976),
                     "attention": (357663744.0, 7262208.0)},
        },
    },
    "vit-l16": {
        # at the tiny sizes the two ViT configurations draw alike
        "digests": {
            "base": "75bd11a62386cd01fad85a386681ab11393107b646a073c2a089c803e3678ccd",
            "overlay": "0326a91c9b1ed725abd3932283babcba3ef5889d528e2fb0b32f9fdef3319419",
            "deltas": "a3ffe571860ba240f7106c63302053952bb9ba5b8bc958c1d6e4306ac1f9a71d",
            "images": "339196abe022e24f711ae3966c5f7de7d600ffcfbd929de0e62984bf29d4a678",
        },
        "counts": {
            "coalition_eval_flops_128_7": 110067457196032.0,
            "encoder_flops_per_image": 122799095808.0,
            "patch_flops_1": 308281344.0,
            "head_flops_per_image": 8192.0,
            "train_step_flops_64": 16015929245696.0,
        },
        "kernel_calls": {
            (896, 2): {"mlp_block": (2961379950592.0, 739784704),
                       "attention": (142429650944.0, 1445986304.0)},
            (3, 4): {"mlp_block": (9915334656.0, 38424576),
                     "attention": (476884992.0, 9682944.0)},
        },
    },
}

# a tiny traced run of two window rounds (seed 2**31 + 2502): the window's
# operations and the traced rounds' kernel work
RUN_PINS = {
    "vitb16-n3": (428949504.0, {
        "mlp_block": {"calls": 12, "flops": 187170816.0, "bytes": 3026688.0,
                      "bound_s": 9.034889552238806e-07},
        "attention": {"calls": 12, "flops": 49717248.0, "bytes": 5849088.0,
                      "bound_s": 1.745996417910448e-06}}),
    "vitb16-n5-mesh4": (1883455488.0, {
        "mlp_block": {"calls": 48, "flops": 828899328.0, "bytes": 13360128.0,
                      "bound_s": 3.988097910447761e-06},
        "attention": {"calls": 48, "flops": 220176384.0, "bytes": 25903104.0,
                      "bound_s": 7.73226985074627e-06}}),
}


def digest(tree) -> str:
    """SHA-256 over a tree's leaves in sorted key order: each leaf's path,
    dtype, shape and bytes."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}.{k}" if path else k)
            return
        if isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
            return
        a = (node.detach().cpu().contiguous().numpy() if isinstance(node, torch.Tensor)
             else np.ascontiguousarray(node))
        h.update(f"{path}|{a.dtype}|{a.shape}|".encode())
        h.update(a.tobytes())

    walk(tree, "")
    return h.hexdigest()


def _config(name):
    entry = cell.by_name(cell.load_benchmark(ROOT)["configs"], name, "config")
    conf = cell.load_json(os.path.join(ROOT, entry["file"]))
    return conf, cell.family_module(conf["reference"])


@pytest.mark.parametrize("name", sorted(PINS))
def test_tiny_draws_pinned(name):
    full, fam = _config(name)
    conf = dict(full, **fam.TINY)
    mix = cell.load_json(os.path.join(ROOT, "bench_port", "mixes", "rounds-n3.json"))
    d = fam.dims(conf)
    gen = inputs.generator(SEED, "cpu")
    base = fam.base(conf, gen, "cpu")
    init = inputs.init_overlay(d, base, gen, "cpu")
    images, labels = inputs.images(d, int(conf["validation_images"]), gen, "cpu", conf["num_labels"])
    deltas = inputs.client_deltas(d, int(mix["clients"]), gen, "cpu", mix["delta_scale"])
    got = {"base": digest(base), "overlay": digest(init), "deltas": digest(deltas),
           "images": digest({"images": images, "labels": labels})}
    assert got == PINS[name]["digests"]


@pytest.mark.parametrize("name", sorted(PINS))
def test_published_width_counts_pinned(name):
    conf, fam = _config(name)
    got = {"coalition_eval_flops_128_7": fam.coalition_eval_flops(conf, 128, 7),
           "encoder_flops_per_image": fam.encoder_flops_per_image(conf),
           "patch_flops_1": fam.patch_flops(conf, 1),
           "head_flops_per_image": fam.head_flops_per_image(conf),
           "train_step_flops_64": fam.train_step_flops(conf, 64)}
    assert got == PINS[name]["counts"]


@pytest.mark.parametrize("name", sorted(PINS))
def test_kernel_calls_pinned(name):
    conf, fam = _config(name)
    for (sequences, itemsize), want in PINS[name]["kernel_calls"].items():
        got = fam.kernel_calls(conf, sequences, itemsize)
        assert list(got) == list(want)
        assert {k: tuple(v) for k, v in got.items()} == want


@pytest.mark.parametrize("workload", sorted(RUN_PINS))
def test_tiny_run_counts_pinned(workload, one_thread):
    ctx = tiny_context(workload, seed=2**31 + 2502, trace=True, overrides={"rounds": 2})
    out, _ = run_tiny(ctx)
    window_flops, work = RUN_PINS[workload]
    assert out.facts["window_flops"] == window_flops
    assert out.facts["traced_work"] == work
    assert list(out.trace.by_group) == ["patch_embed", "attention", "mlp_block", "matrix_products",
                                        "other"]
