"""The port's client driver and demo against the JAX package's, at float32
on the CPU.

Both sides train from the same weights: the port's ``build_model`` is
patched to return the JAX package's (carried over as numpy), and both
compute in float32. The client's Adam checkpoints agree within 2e-4 (the
Adam tolerance of ``test_torch_training.py``); the demo's Shapley values
within 1e-4 (the house parity bar).
"""

import importlib
import os

import jax
import numpy as np
import pytest
import torch

from shapley_vit_tpu.config import Config as JConfig
from shapley_vit_tpu.driver import client as jclient
from shapley_vit_tpu.driver import run_demo as jdemo
from shapley_vit_tpu.fl import ingestion as jing
from shapley_vit_tpu_torch.config import Config as TConfig
from shapley_vit_tpu_torch.driver import client as tclient
from shapley_vit_tpu_torch.driver import run_demo as tdemo
from shapley_vit_tpu_torch.driver import start as tstart
from shapley_vit_tpu_torch.fl import ingestion as ting
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from shapley_vit_tpu_torch.utils.profiling import StepTimer
from torch_one_thread import one_torch_thread  # noqa: F401

jstart = importlib.import_module("shapley_vit_tpu.driver.start")


def _cfg(cls, tmp, name):
    cfg = cls()
    cfg.model.model_type = "ViT-micro"
    cfg.model.compute_dtype = "float32"
    cfg.data.synthetic_scale = 0.02
    cfg.obs.exp_dir = str(tmp / name / "exp")
    cfg.paths.validation_dataset = str(tmp / "none")
    cfg.paths.local_model_path = str(tmp / name / "local")
    cfg.paths.global_model_path = str(tmp / "global")
    return cfg


def _float32_jax_weights(monkeypatch):
    """Both packages build their models in float32 from the JAX weights."""
    j_build, t_build = jstart.build_model, tstart.build_model

    def jax_build(cfg, key=None):
        cfg.model.compute_dtype = "float32"
        return j_build(cfg, key)

    def port_build(cfg, generator=None, device="cuda"):
        cfg.model.compute_dtype = "float32"
        spec = t_build(cfg, generator, device=device)[0]
        _, base, lora = j_build(cfg)
        return (spec, tree_from_numpy(jax.device_get(base), device),
                tree_from_numpy(jax.device_get(lora), device))

    monkeypatch.setattr(jstart, "build_model", jax_build)
    monkeypatch.setattr(tstart, "build_model", port_build)


@pytest.fixture
def float32_jax_weights(monkeypatch):
    _float32_jax_weights(monkeypatch)


@pytest.fixture(scope="module")
def demo_runs(tmp_path_factory):
    """Both packages' ``run_demo`` from the same float32 weights, once for
    the tests that read them: (out root, JAX's result, the port's)."""
    tmp = tmp_path_factory.mktemp("demo")
    with pytest.MonkeyPatch.context() as mp:
        _float32_jax_weights(mp)
        want = jdemo.run_demo(out_dir=str(tmp / "jax"))
        got = tdemo.run_demo(out_dir=str(tmp / "torch"), device="cpu")
    return tmp, want, got


def test_run_client_matches_jax(tmp_path, float32_jax_weights):
    """Two epochs of Adam: the first adopts a global export (fresh optimizer
    state), the second continues; drops in both formats."""
    jcfg, tcfg = _cfg(JConfig, tmp_path, "jax"), _cfg(TConfig, tmp_path, "torch")
    spec_j, _, lora = jstart.build_model(jcfg)
    rng = np.random.default_rng(0)
    glob_lora = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
                             jax.device_get(lora))
    jing.save_lora_checkpoint(str(tmp_path / "global" / "ViT_global_epoch_3.npz"), glob_lora, spec_j)

    want = jclient.run_client(jcfg, client_id=1, epochs=2, steps_per_epoch=2)
    timer = StepTimer()
    got = tclient.run_client(tcfg, client_id=1, epochs=2, steps_per_epoch=2, device="cpu",
                             ckpt_format="pth.tar", timer=timer)
    assert [os.path.basename(p) for p in got] == ["ViT_epoch_0.pth.tar", "ViT_epoch_1.pth.tar"]
    assert timer.summary()["train_step"]["count"] == 4
    spec_t = tstart.build_model(tcfg, device="cpu")[0]
    for pj, pt in zip(want, got):
        lj = jing.load_client_lora(pj, spec_j)
        lt = ting.load_client_lora(pt, spec_t)
        for a, b in zip(jax.tree.leaves(lj), jax.tree.leaves(lt)):
            np.testing.assert_allclose(b, a, atol=2e-4, rtol=0)
        assert ting._load_raw(pt)[1] == {"num_local_data_train": jing.load_checkpoint_metadata(pj)[
            "num_local_data_train"]}
    moved = np.abs(lt["lora"]["q"]["B"] - glob_lora["lora"]["q"]["B"]).max()
    assert moved > 1e-3  # trained from the global export


def test_run_client_refuses_bad_input(tmp_path):
    cfg = _cfg(TConfig, tmp_path, "torch")
    cfg.paths.global_model_path = ""
    with pytest.raises(ValueError, match="ckpt_format"):
        tclient.run_client(cfg, ckpt_format="bogus", device="cpu")
    with pytest.raises(ValueError, match="steps_per_epoch"):
        tclient.run_client(cfg, steps_per_epoch=0, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tclient.run_client(cfg, device="cpu",
                           data=(np.zeros((0, 32, 32, 3), np.float32), np.zeros(0, np.int32)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tclient.run_client(cfg)


def test_run_client_dp_and_label_flip(tmp_path):
    """The poisoning fixture and DP-SGD drive the local optimizer; the DP
    client adopts the global export with a fresh noise stream."""
    cfg = _cfg(TConfig, tmp_path, "torch")
    spec, _, lora = tstart.build_model(cfg, device="cpu")
    ting.save_lora_checkpoint(str(tmp_path / "global" / "ViT_global.npz"), lora, spec)
    cfg.train.label_flip_prob = 0.5
    flip = tclient.run_client(cfg, client_id=0, steps_per_epoch=1, device="cpu")
    cfg.train.use_dp = True
    cfg.train.lr = 0.05
    dp = tclient.run_client(cfg, client_id=1, steps_per_epoch=1, device="cpu")
    for p in flip + dp:
        got = ting.load_client_lora(p, spec)
        assert all(np.isfinite(a).all() for a in jax.tree.leaves(got))
        assert np.abs(got["lora"]["q"]["B"]).max() > 0


def test_run_client_remat_recomputes_and_matches(tmp_path, monkeypatch):
    """``cfg.train.remat`` (``--remat``) reaches the model: each step runs
    every block's attention twice, and the drops equal those of a run
    without it."""
    from shapley_vit_tpu_torch.models import vit as tvit

    assert TConfig.from_args(["--remat"]).train.remat and not TConfig.from_args([]).train.remat
    calls = []
    orig = tvit.fused_attention

    def counting(q, k, v):
        calls.append(1)
        return orig(q, k, v)

    monkeypatch.setattr(tvit, "fused_attention", counting)
    drops = []
    for remat in (False, True):
        cfg = _cfg(TConfig, tmp_path, f"remat_{remat}")
        cfg.paths.global_model_path = ""
        cfg.train.remat = remat
        calls.clear()
        p = tclient.run_client(cfg, client_id=0, steps_per_epoch=2, device="cpu")[0]
        spec = tstart.build_model(cfg, device="cpu")[0]
        assert len(calls) == 2 * spec.depth * (2 if remat else 1)
        drops.append(jax.tree.leaves(ting.load_client_lora(p, spec)))
    for a, b in zip(*drops):
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


def test_latest_global_export(tmp_path):
    assert tclient.latest_global_export(None) is None
    assert tclient.latest_global_export(str(tmp_path / "missing")) is None
    (tmp_path / "ViT_global.npz").write_bytes(b"")
    assert tclient.latest_global_export(str(tmp_path)).endswith("ViT_global.npz")
    for e in (2, 10, 9):
        (tmp_path / f"ViT_global_epoch_{e}.npz").write_bytes(b"")
    assert tclient.latest_global_export(str(tmp_path)).endswith("ViT_global_epoch_10.npz")


def test_run_demo_matches_jax(demo_runs):
    _, (rounds_j, sum_j, _), (rounds_t, sum_t, _) = demo_runs

    def flat(rounds):
        return np.array([[r[c] for c in range(3)] for dim in rounds for r in dim])

    assert np.abs(flat(rounds_j)[1::2]).max() > 1e-3  # the round's SVs are not all zero
    np.testing.assert_allclose(flat(rounds_t), flat(rounds_j), atol=1e-4, rtol=0)
    for d in range(2):
        np.testing.assert_allclose([sum_t[d][c] for c in range(3)],
                                   [sum_j[d][c] for c in range(3)], atol=1e-4, rtol=0)


def test_run_demo_exports_the_global_overlay(demo_runs):
    """The demo sets GLOBAL_MODEL_PATH to ``<out_dir>/global``, as JAX's
    does: ``start()`` writes the post-round FedAvg overlay there."""
    tmp, _, _ = demo_runs
    want = np.load(tmp / "jax" / "global" / "ViT_global.npz")
    got = np.load(tmp / "torch" / "global" / "ViT_global.npz")
    assert sorted(got.files) == sorted(want.files) and want.files
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], atol=2e-4, rtol=0, err_msg=k)
