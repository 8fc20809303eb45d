"""The port's data readers against ``shapley_vit_tpu.data`` on files the
tests write: ``formats`` (MNIST/EMNIST idx with and without gzip,
CIFAR-10/100 pickles, SVHN ``.mat``), ``medical`` (ISIC, DR Kaggle,
ImageFolder), the full ``registry`` (every synthetic image set, the
on-disk folders, COMPAS/Adult with their per-group validation splits,
CIFAR-10's 50/50 val/test split, ``train=False``) and ``pipeline``.

Arrays are identical to the JAX package's (labels, names, groups too);
the resize is held within 1e-5 of ``jax.image.resize`` (the two
resamplers sum the same kernel taps in another order).
"""

import csv
import os
import pickle

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from shapley_vit_tpu.data import formats as jformats
from shapley_vit_tpu.data import medical as jmedical
from shapley_vit_tpu.data import pipeline as jpipe
from shapley_vit_tpu.data import registry as jreg
from shapley_vit_tpu.data.arrays import ArrayDataset as JDataset
from shapley_vit_tpu_torch.data import formats as tformats
from shapley_vit_tpu_torch.data import medical as tmedical
from shapley_vit_tpu_torch.data import pipeline as tpipe
from shapley_vit_tpu_torch.data import registry as treg
from shapley_vit_tpu_torch.data.arrays import ArrayDataset
from test_formats import _fabricate_cifar10, _fabricate_mnist, _write_idx
from torch_one_thread import one_torch_thread  # noqa: F401


def _same_dataset(got, want):
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.images.dtype == want.images.dtype
    assert list(got.names or []) == list(want.names or [])
    assert list(got.classes or []) == list(want.classes or [])
    if getattr(want, "group", None) is not None:
        np.testing.assert_array_equal(got.group, want.group)


def _same_splits(got, want):
    (gs, gi), (ws, wi) = got, want
    assert sorted(gs) == sorted(ws)
    for k in ws:
        _same_dataset(gs[k], ws[k])
    assert sorted(gi) == sorted(wi)
    for k in wi:
        if k == "group_valid":
            for g, w in zip(gi[k], wi[k]):
                _same_dataset(g, w)
        else:
            assert gi[k] == wi[k], k


def _fabricate_emnist(root, n=10):
    raw = os.path.join(root, "EMNIST", "raw")
    os.makedirs(raw)
    rng = np.random.default_rng(2)
    for part in ("train", "test"):
        _write_idx(os.path.join(raw, f"emnist-balanced-{part}-images-idx3-ubyte"),
                   rng.integers(0, 256, size=(n, 28, 28), dtype=np.uint8), gz=True)
        _write_idx(os.path.join(raw, f"emnist-balanced-{part}-labels-idx1-ubyte"),
                   rng.integers(0, 47, size=n, dtype=np.uint8), gz=True)


def _fabricate_cifar100(root):
    d = os.path.join(root, "cifar-100-python")
    os.makedirs(d)
    rng = np.random.default_rng(3)
    for part, n in (("train", 12), ("test", 5)):
        with open(os.path.join(d, part), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, size=(n, 3072), dtype=np.uint8),
                         b"fine_labels": rng.integers(0, 100, size=n).tolist()}, f)


def _fabricate_svhn(root):
    from scipy.io import savemat

    rng = np.random.default_rng(4)
    for part, n in (("train", 7), ("test", 3)):
        savemat(os.path.join(root, f"{part}_32x32.mat"),
                {"X": rng.integers(0, 256, size=(32, 32, 3, n), dtype=np.uint8),
                 "y": rng.integers(1, 11, size=(n, 1))})


def _image_folder(root, classes, per_class, size=20, seed=5):
    rng = np.random.default_rng(seed)
    for c in classes:
        os.makedirs(os.path.join(root, c))
        for i in range(per_class):
            Image.fromarray((rng.random((size, size, 3)) * 255).astype(np.uint8)).save(
                os.path.join(root, c, f"{c}_{i}.png"))


@pytest.mark.parametrize("name", ["mnist", "mnist_gz", "emnist", "cifar10", "cifar100", "svhn"])
def test_native_formats_and_registry_match_jax(tmp_path, name):
    root = str(tmp_path)
    {"mnist": lambda: _fabricate_mnist(root), "mnist_gz": lambda: _fabricate_mnist(root, gz=True),
     "emnist": lambda: _fabricate_emnist(root), "cifar10": lambda: _fabricate_cifar10(root),
     "cifar100": lambda: _fabricate_cifar100(root), "svhn": lambda: _fabricate_svhn(root)}[name]()
    dataset = name.split("_")[0]
    got, want = tformats.try_native_formats(dataset, root), jformats.try_native_formats(dataset, root)
    assert got is not None and want is not None
    for g, w in zip(got, want):
        _same_dataset(g, w)
    _same_splits(treg.get_dataset(dataset, data_dir=root, synthetic_ok=False),
                 jreg.get_dataset(dataset, data_dir=root, synthetic_ok=False))


def test_readers_refuse_what_jax_refuses(tmp_path):
    assert tformats.try_native_formats("mnist", str(tmp_path)) is None
    assert tformats.try_native_formats("oct", str(tmp_path)) is None
    bad = tmp_path / "bad-idx"
    bad.write_bytes(b"\x01\x02\x08\x01" + b"\x00" * 8)
    with pytest.raises(ValueError, match="not an idx file"):
        tformats.read_idx(str(bad))
    with pytest.raises(FileNotFoundError):
        tformats.load_svhn_mat(str(tmp_path))
    assert treg._try_torchvision("mnist", str(tmp_path)) is None
    assert treg._try_torchvision("mnist", str(tmp_path)) == jreg._try_torchvision("mnist", str(tmp_path))


def test_medical_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    isic = tmp_path / "isic"
    (isic / "ISIC_2019_Training_Input").mkdir(parents=True)
    rows = []
    for i in range(6):
        name = f"ISIC_{i:07d}"
        Image.fromarray((rng.random((40, 40, 3)) * 255).astype(np.uint8)).save(
            isic / "ISIC_2019_Training_Input" / f"{name}.jpg")
        onehot = {c: 0.0 for c in tmedical.ISIC_CLASSES}
        onehot[tmedical.ISIC_CLASSES[i % 3]] = 1.0
        rows.append({"image": name, **onehot})
    with open(isic / "ISIC_2019_Training_GroundTruth.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["image"] + tmedical.ISIC_CLASSES)
        w.writeheader()
        w.writerows(rows)
    _same_dataset(tmedical.load_isic(str(isic), 32), jmedical.load_isic(str(isic), 32))
    _same_dataset(tmedical.load_isic(str(isic), 24, max_samples=4),
                  jmedical.load_isic(str(isic), 24, max_samples=4))

    dr = tmp_path / "dr"
    (dr / "train").mkdir(parents=True)
    with open(dr / "trainLabels.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["image", "level"])
        w.writeheader()
        for i in range(5):
            Image.fromarray((rng.random((30, 30, 3)) * 255).astype(np.uint8)).save(
                dr / "train" / f"img_{i}.jpeg")
            w.writerow({"image": f"img_{i}", "level": i % 5})
    _same_dataset(tmedical.load_dr_kaggle(str(dr), 24), jmedical.load_dr_kaggle(str(dr), 24))

    folder = tmp_path / "folder"
    _image_folder(str(folder), ["b", "a"], 3)
    _same_dataset(tmedical.load_imagefolder(str(folder), 16),
                  jmedical.load_imagefolder(str(folder), 16))
    for fn in (tmedical.load_isic, tmedical.load_dr_kaggle):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / "missing"))


def test_registry_disk_folders_match_jax(tmp_path):
    for split in ("train", "valid", "test"):
        _image_folder(str(tmp_path / "cinic" / "CINIC-10" / split), ["cat", "dog"], 2, size=32)
    for split in ("train", "test"):
        _image_folder(str(tmp_path / "covid" / split), ["covid", "normal", "pneumonia"], 2)
    for name, root in (("cinic10", tmp_path / "cinic"), ("covid-19", tmp_path / "covid")):
        _same_splits(treg.get_dataset(name, data_dir=str(root), synthetic_ok=False),
                     jreg.get_dataset(name, data_dir=str(root), synthetic_ok=False))


@pytest.mark.parametrize("name", sorted(jreg._IMAGE_SPECS) + ["x-ray", "compas", "adult"])
def test_registry_synthetic_sets_match_jax(name):
    scale = 0.002 if name in ("covid-19", "isic2019", "dr-kaggle", "oct", "x-ray") else 0.005
    _same_splits(treg.get_dataset(name, synthetic_scale=scale, seed=3),
                 jreg.get_dataset(name, synthetic_scale=scale, seed=3))


def test_registry_tabular_csv_train_false_and_unknown(tmp_path):
    rng = np.random.default_rng(7)
    rows = np.concatenate([rng.normal(size=(60, 5)), (rng.random((60, 1)) < 0.5),
                           (rng.random((60, 1)) < 0.5)], axis=1)
    np.savetxt(tmp_path / "adult.csv", rows, delimiter=",", header="a,b,c,d,e,group,label")
    _same_splits(treg.get_dataset("adult", data_dir=str(tmp_path)),
                 jreg.get_dataset("adult", data_dir=str(tmp_path)))
    (tmp_path / "compas.csv").write_text("a,group,label\n1.0,x,1\n")
    with pytest.raises(ValueError, match="non-numeric"):
        treg.get_dataset("compas", data_dir=str(tmp_path))
    # CIFAR-10's validation and test halves of the test split, seed 42
    splits, _ = treg.get_dataset("cifar10", synthetic_scale=0.01, seed=1, train=False)
    assert "train" not in splits and len(splits["val"]) + len(splits["test"]) == 100
    want, _ = jreg.get_dataset("cifar10", synthetic_scale=0.01, seed=1)
    _same_dataset(splits["val"], want["val"])
    _same_dataset(splits["test"], want["test"])
    with pytest.raises(ValueError, match="unknown dataset"):
        treg.get_dataset("imagenet")
    with pytest.raises(FileNotFoundError):
        treg.get_dataset("mnist", data_dir=str(tmp_path), synthetic_ok=False)


@pytest.mark.parametrize("shape,size", [((3, 32, 32, 3), 16), ((2, 28, 28, 1), 20),
                                        ((2, 16, 16, 3), 24), ((2, 40, 40, 3), 40)])
def test_pipeline_matches_jax(shape, size):
    rng = np.random.default_rng(8)
    x = rng.random(shape).astype(np.float32)
    want = np.asarray(jpipe.resize_batch(x, size))
    got = tpipe.resize_batch(torch.tensor(x), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    mean, std = (0.5,) * shape[-1], (0.25,) * shape[-1]
    want = np.asarray(jpipe.preprocess(x, size=size, mean=mean, std=std))
    got = tpipe.preprocess(x, size=size, mean=mean, std=std, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 / 0.25, rtol=0)
    ds_t = ArrayDataset(images=x, labels=np.arange(shape[0]))
    ds_j = JDataset(images=x, labels=np.arange(shape[0]))
    tb = tpipe.make_eval_batches(ds_t, 2, size=size, mean=mean, std=std, device="cpu")
    jb = jpipe.make_eval_batches(ds_j, 2, size=size, mean=mean, std=std)
    assert len(tb) == len(jb)
    for (ti, tl), (ji, jl) in zip(tb, jb):
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5 / 0.25, rtol=0)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    norm = tpipe.normalize_batch(torch.tensor(x), torch.tensor(mean), torch.tensor(std)).numpy()
    np.testing.assert_allclose(norm, np.asarray(jpipe.normalize_batch(
        x, jax.numpy.asarray(mean), jax.numpy.asarray(std))), atol=1e-6, rtol=0)
