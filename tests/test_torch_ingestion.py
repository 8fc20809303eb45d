"""The port's checkpoint ingestion and validation resize against the JAX package.

The same ``.npz`` and ``.pth.tar`` drops give bit-identical float32 deltas,
the same sizes and the same selection through either package's
``ingest_clients``; drops written by either package read in the other; the
antialiased resize matches ``jax.image.resize(..., "bilinear")`` at 1e-5.
"""

import os

import jax
import numpy as np
import pytest
import torch

from shapley_vit_tpu.fl import ingestion as jing
from shapley_vit_tpu.models import vit as jvit
from shapley_vit_tpu_torch.driver.start import resize_images
from shapley_vit_tpu_torch.fl import ingestion as ting
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from shapley_vit_tpu_torch.ops import tree_math as ttm


@pytest.fixture
def fleet(tmp_path):
    spec_j, spec_t = jvit.make_spec("micro"), tvit.make_spec("micro")
    base = jvit.init_vit(jax.random.key(0), spec_j)
    init = jax.device_get(jvit.init_lora(jax.random.key(1), spec_j, classifier_from=base))
    rng = np.random.default_rng(0)
    drops = [jax.tree.map(lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32), init)
             for _ in range(4)]
    return spec_j, spec_t, init, drops, tmp_path


def _assert_same_ingest(got, want):
    (gd, gs, gz), (wd, ws, wz) = got, want
    assert gs == ws and gz == wz
    for a, b in zip(gd, wd):
        assert (a is None) == (b is None)
        if a is None:
            continue
        for x, y in zip(ttm.tree_leaves(a), jax.tree.leaves(b)):
            assert x.dtype == np.float32
            np.testing.assert_array_equal(x, np.asarray(y))  # bit-identical


def test_jax_written_drops_ingest_identically(fleet):
    spec_j, spec_t, init, drops, tmp = fleet
    paths = []
    for i, (drop, n, ext) in enumerate(zip(drops[:3], (120, 300, None), (".npz", ".pth.tar", ".npz"))):
        p = str(tmp / f"client_{i + 1}_model" / f"ViT_epoch_9{ext}")
        jing.save_lora_checkpoint(p, drop, spec_j, num_local_data_train=n)
        paths.append(p)
    paths.append(None)  # a straggler
    want = jing.ingest_clients(paths, init, spec_j)
    got = ting.ingest_clients(paths, tree_from_numpy(init), spec_t)
    _assert_same_ingest(got, want)
    assert got[1] == [True, True, True, False] and got[2] == [120, 300, None, None]
    assert ting.resolve_data_sizes(got[2], got[1]) == jing.resolve_data_sizes(want[2], want[1])


def test_port_written_drops_read_back_in_both_packages(fleet):
    spec_j, spec_t, init, drops, tmp = fleet
    paths = []
    for i, ext in enumerate((".npz", ".pth.tar")):
        p = str(tmp / f"c{i}" / f"ViT_epoch_9{ext}")
        ting.save_lora_checkpoint(p, tree_from_numpy(drops[i]), spec_t, num_local_data_train=7 + i)
        paths.append(p)
    want = jing.ingest_clients(paths, init, spec_j)
    got = ting.ingest_clients(paths, tree_from_numpy(init), spec_t)
    _assert_same_ingest(got, want)
    assert got[2] == [7, 8]


def test_legacy_torch_files_refused_unless_opted_in(fleet, monkeypatch):
    spec_j, spec_t, init, drops, tmp = fleet
    from shapley_vit_tpu_torch.models.convert import tree_to_peft_lora

    sd = {k: torch.from_numpy(v) for k, v in tree_to_peft_lora(drops[0], spec_t).items()}
    p = str(tmp / "legacy.pth.tar")
    torch.save({"state_dict": sd}, p, _use_new_zipfile_serialization=False)
    with pytest.raises(ting.NativeFormatError):
        ting.load_client_lora(p, spec_t)
    monkeypatch.setenv("SVT_TORCH_LEGACY_CKPT", "1")
    lora = ting.load_client_lora(p, spec_t)
    np.testing.assert_array_equal(lora["lora"]["q"]["A"], drops[0]["lora"]["q"]["A"])


def test_wait_policies_and_candidates(tmp_path):
    cands = ting.checkpoint_path_candidates(str(tmp_path), 2)
    assert cands == jing.checkpoint_path_candidates(str(tmp_path), 2)
    os.makedirs(os.path.dirname(cands[1][1]))
    open(cands[1][1], "wb").close()
    r = ting.wait_for_checkpoints(cands, timeout=0, policy="skip")
    assert r.arrived == [False, True] and r.paths == [None, cands[1][1]]
    with pytest.raises(TimeoutError):
        ting.wait_for_checkpoints(cands, timeout=0, policy="fail")
    with pytest.raises(ValueError):
        ting.wait_for_checkpoints(cands, policy="later")


@pytest.mark.parametrize("src,dst", [(256, 224), (256, 16), (16, 24)])
def test_resize_matches_jax_image_resize(src, dst):
    images = np.random.default_rng(1).random((3, src, src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(images, (3, dst, dst, 3), "bilinear"))
    got = resize_images(images, dst, block=2)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
