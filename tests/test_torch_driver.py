"""The port's whole Shapley round against the JAX package's, on the CPU.

Same ``Config`` on both sides (micro ViT, float32, synthetic OCT at a small
``synthetic_scale``), same client drops, same weights (carried over as
numpy), same seed: the comp-contrib Shapley values agree within 1e-4, and so
do exact Shapley values computed from each round's persisted utility table.
"""

import os

import jax
import numpy as np
import pytest
import torch

from shapley_vit_tpu.config import Config as JConfig
from shapley_vit_tpu.driver import start as jstart
from shapley_vit_tpu.fl import checkpoint as jckpt
from shapley_vit_tpu.fl import ingestion as jing
from shapley_vit_tpu.shapley import Game as JGame
from shapley_vit_tpu.shapley import shapley_exact as j_exact
from shapley_vit_tpu_torch.config import Config as TConfig
from shapley_vit_tpu_torch.driver import start as tstart
from shapley_vit_tpu_torch.fl import checkpoint as tckpt
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from shapley_vit_tpu_torch.shapley import Game as TGame
from shapley_vit_tpu_torch.shapley import shapley_exact as t_exact

SIZES = (120, 300, 580)


def _cfg(cls, out_dir):
    cfg = cls()
    cfg.model.vit_variant = "micro"
    cfg.model.compute_dtype = "float32"
    cfg.data.synthetic_scale = 0.1   # 40 validation images
    cfg.data.eval_batch_size = 16
    cfg.obs.exp_dir = str(out_dir)
    cfg.dist.mesh = "off"
    return cfg


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """One JAX round and one port round on the same inputs."""
    tmp = tmp_path_factory.mktemp("round")
    jcfg = _cfg(JConfig, tmp / "jax")
    spec_j, base, lora = jstart.build_model(jcfg)
    base, lora = jax.device_get(base), jax.device_get(lora)
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate(SIZES):
        drop = jax.tree.map(lambda a: a + 0.5 * rng.normal(size=a.shape).astype(np.float32), lora)
        p = str(tmp / f"client_{i + 1}_model" / ("ViT_epoch_9.pth.tar" if i == 1 else "ViT_epoch_9.npz"))
        jing.save_lora_checkpoint(p, drop, spec_j, num_local_data_train=n)
        paths.append(p)
    valid_j = jstart.load_validation_dataset(jcfg, target_size=spec_j.image)
    sv_j = jstart.get_initial_shapley_value(jcfg, valid_j, spec_j, base, lora, checkpoint_paths=paths)

    tcfg = _cfg(TConfig, tmp / "torch")
    spec_t = tstart.build_model(tcfg, device="cpu")[0]
    tb, tl = tree_from_numpy(base), tree_from_numpy(lora)
    valid_t = tstart.load_validation_dataset(tcfg, target_size=spec_t.image)
    sv_t = tstart.get_initial_shapley_value(tcfg, valid_t, spec_t, tb, tl, checkpoint_paths=paths,
                                            device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, sv_j=sv_j, sv_t=sv_t, paths=paths, spec_t=spec_t,
                tb=tb, tl=tl, valid_t=valid_t, valid_j=valid_j)


def _svs(result, n=3):
    all_rounds, _ = result
    return np.array([[all_rounds[d][r][c] for c in range(n)] for r in (0, 1) for d in (0, 1)])


def test_comp_contrib_round_matches_jax(rounds):
    np.testing.assert_allclose(rounds["valid_t"].images, rounds["valid_j"].images, atol=1e-5)
    got, want = _svs(rounds["sv_t"]), _svs(rounds["sv_j"])
    assert np.abs(want[2:]).max() > 1e-3  # the round's SVs are not all zero
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_exact_shapley_from_the_round_tables_matches_jax(rounds):
    def table(mod, cfg):
        t, fp = mod.load_utility_table(os.path.join(cfg.output_dir, "utility_table.npz"))
        assert fp is not None and len(t) == 7
        return t

    tj, tt = table(jckpt, rounds["jcfg"]), table(tckpt, rounds["tcfg"])
    assert set(tj) == set(tt)
    for k in tj:
        np.testing.assert_allclose(tt[k], tj[k], atol=1e-4, rtol=0)

    def never(W):
        raise AssertionError("every coalition is in the table")

    gj = JGame(never, SIZES, [True] * 3, [0.0, 0.0], utility_dim=2, n_all=3)
    gt = TGame(never, SIZES, [True] * 3, [0.0, 0.0], utility_dim=2, n_all=3)
    gj.utility.update(tj)
    gt.utility.update(tt)
    ej, et = j_exact(gj), t_exact(gt)
    for d in range(2):
        np.testing.assert_allclose([et[d][c] for c in range(3)], [ej[d][c] for c in range(3)],
                                   atol=1e-4, rtol=0)
        # efficiency: the exact values sum to the grand coalition's utility
        assert abs(sum(et[d].values()) - tt[frozenset(range(3))][d]) < 1e-6


def test_round_resumes_from_its_utility_table(rounds, tmp_path):
    """A rerun on the same inputs reads every utility back from the table:
    utilities doubled in the file (same fingerprint) double the SVs, which a
    re-evaluation would not."""
    cfg = _cfg(TConfig, tmp_path)
    table, fp = tckpt.load_utility_table(
        os.path.join(rounds["tcfg"].output_dir, "utility_table.npz"))
    tckpt.save_utility_table(os.path.join(cfg.ensure_output_dir(), "utility_table.npz"),
                             {k: [2 * u for u in v] for k, v in table.items()}, fingerprint=fp)
    again = tstart.get_initial_shapley_value(
        cfg, rounds["valid_t"], rounds["spec_t"], rounds["tb"], rounds["tl"],
        checkpoint_paths=rounds["paths"], device="cpu")
    np.testing.assert_allclose(_svs(again)[2:], 2 * _svs(rounds["sv_t"])[2:], atol=1e-7, rtol=1e-6)


def test_start_runs_on_the_cpu_only_when_asked(tmp_path, rounds):
    cfg = _cfg(TConfig, tmp_path)
    result = tstart.start(cfg, checkpoint_paths=rounds["paths"], device="cpu")
    assert np.isfinite(_svs(result)).all()
    assert os.path.exists(os.path.join(cfg.output_dir, "utility_table.npz"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tstart.start(cfg, checkpoint_paths=rounds["paths"])
    int8 = _cfg(TConfig, tmp_path)
    int8.model.quant = "int8"  # ported: no longer refused
    assert tstart.build_model(int8, device="cpu")[0].quant == "int8"
    bad = _cfg(TConfig, tmp_path)
    bad.model.quant = "int4"
    with pytest.raises(ValueError):
        tstart.build_model(bad, device="cpu")
    # Grad-CAM of the round's global model (ported: no longer refused)
    cam = _cfg(TConfig, tmp_path)
    cam.obs.use_grad_cam = True
    cam.obs.sal_image_dir = str(tmp_path / "sal")
    again = tstart.start(cam, checkpoint_paths=rounds["paths"], device="cpu")
    np.testing.assert_array_equal(_svs(again), _svs(result))
    assert os.path.getsize(os.path.join(cam.obs.sal_image_dir, cam.obs.exp_id,
                                        "saliency_r1.png")) > 0
