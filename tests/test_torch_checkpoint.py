"""The port's round fingerprints and tree checkpoints against the JAX
package's ``fl/checkpoint.py`` and ``fl/ingestion.py``: for the same numpy
values and files, ``overlay_digest`` and ``fingerprint_files`` give the JAX
package's strings (so a utility table's stamp means the same thing in both
packages); ``save_pytree``/``load_pytree`` round-trip a tree; the metadata
reader and the reference's path layout match JAX's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapley_vit_tpu.fl import checkpoint as jckpt
from shapley_vit_tpu.fl import ingestion as jing
from shapley_vit_tpu.models import vit as jvit
from shapley_vit_tpu_torch.fl import checkpoint as tckpt
from shapley_vit_tpu_torch.fl import ingestion as ting
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy, tree_to_numpy


def _overlay(seed=0):
    spec = jvit.make_spec("micro")
    lora = jax.device_get(jvit.init_lora(jax.random.key(seed), spec))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32), lora)


@pytest.mark.parametrize("max_leaves,sample_bytes", [(4, 2048), (2, 64), (50, 16)])
def test_overlay_digest_matches_jax(max_leaves, sample_bytes):
    host = _overlay()
    want = jckpt.overlay_digest(jax.tree.map(jnp.asarray, host), max_leaves, sample_bytes)
    assert jckpt.overlay_digest(host, max_leaves, sample_bytes) == want
    assert tckpt.overlay_digest(host, max_leaves, sample_bytes) == want           # numpy leaves
    assert tckpt.overlay_digest(tree_from_numpy(host), max_leaves, sample_bytes) == want
    # bfloat16 leaves: the same bytes and sums as JAX's bfloat16 arrays
    want16 = jckpt.overlay_digest(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), host),
                                  max_leaves, sample_bytes)
    got16 = tckpt.overlay_digest(tree_from_numpy(host, dtype=torch.bfloat16), max_leaves,
                                 sample_bytes)
    assert got16 == want16 != want
    assert tckpt.overlay_digest(_overlay(1), max_leaves, sample_bytes) != want
    assert tckpt.overlay_digest({}) == jckpt.overlay_digest({}) == "empty"


def test_fingerprint_files_matches_jax(tmp_path):
    paths = []
    for i in range(3):
        p = tmp_path / f"c{i}.bin"
        p.write_bytes(os.urandom(3000 + 1000 * i))
        paths.append(str(p))
    paths.append(str(tmp_path / "absent.bin"))
    extra = ("digest", [1.0, 2.0], [True, False], ["0.5"])
    want = jckpt.fingerprint_files(paths + [None], extra=extra)
    assert tckpt.fingerprint_files(paths + [None], extra=extra) == want
    assert tckpt.fingerprint_files(paths[::-1] + [None], extra=extra) != want  # permuted clients
    assert tckpt.fingerprint_files([], extra=extra) == jckpt.fingerprint_files([], extra=extra)


def test_save_and_load_pytree(tmp_path):
    tree = tree_from_numpy(_overlay())
    path = str(tmp_path / "sub" / "overlay.pt")
    tckpt.save_pytree(path, tree)
    assert not os.path.exists(path + ".tmp")
    back = tckpt.load_pytree(path)
    for a, b in zip(jax.tree.leaves(tree_to_numpy(tree)), jax.tree.leaves(tree_to_numpy(back))):
        np.testing.assert_array_equal(a, b)
    like = tree_from_numpy(_overlay(), dtype=torch.float64)
    back = tckpt.load_pytree(path, like=like)
    assert back["lora"]["q"]["A"].dtype == torch.float64
    np.testing.assert_allclose(back["lora"]["q"]["A"].numpy(), tree["lora"]["q"]["A"].numpy())
    assert tckpt.overlay_digest(tckpt.load_pytree(path)) == tckpt.overlay_digest(tree)


def test_checkpoint_metadata_and_default_paths(tmp_path):
    assert ting.default_checkpoint_paths("/r", 3, "m.npz") == jing.default_checkpoint_paths(
        "/r", 3, "m.npz")
    spec = tvit.make_spec("micro")
    lora = _overlay()
    for name in ("a.npz", "b.pth.tar"):
        p = str(tmp_path / name)
        ting.save_lora_checkpoint(p, lora, spec, num_local_data_train=123)
        assert ting.load_checkpoint_metadata(p) == {"num_local_data_train": 123}
        assert jing.load_checkpoint_metadata(p) == {"num_local_data_train": 123}
    p = str(tmp_path / "c.npz")
    ting.save_lora_checkpoint(p, lora, spec)
    assert ting.load_checkpoint_metadata(p) == {}
