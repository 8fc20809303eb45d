"""The port's examples (``shapley_vit_tpu_torch/examples``) against the JAX
package's, float32 on the CPU, and the wrappers' thread safety that the
service demo leans on.

* The quickstart's round (``run_quickstart``) from the JAX quickstart's
  weights, deltas and validation set, against the same steps through the
  JAX modules on micro: exact and comp-contrib SVs within 1e-4 and the same
  evaluation counts.
* ``serve_demo.run_demo`` against ``examples/serve_demo.run_demo`` on micro
  at 16 px, 2 epochs of 2 local steps, both built from the JAX weights
  (``test_torch_client``'s patch): every record's SVs within 1e-4, the
  exported globals and the trajectory PNG on disk; the numpy raster the
  demo draws where matplotlib does not import; a client thread that raises
  fails the demo.
* ``ops._build.load`` builds and loads a library once when two threads ask
  for it first at once, and ``ops._build.count`` loses no launch.
"""

import collections
import importlib.util
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from shapley_vit_tpu.config import Config as JConfig
from shapley_vit_tpu.fl import evaluation as jev
from shapley_vit_tpu.models import vit as jvit
from shapley_vit_tpu.ops import tree_math as jtm
from shapley_vit_tpu.shapley import Game as JGame
from shapley_vit_tpu.shapley import shapley_comp_contrib as j_cc
from shapley_vit_tpu.shapley import shapley_exact as j_exact
from shapley_vit_tpu_torch.examples import quickstart as tquick
from shapley_vit_tpu_torch.examples import serve_demo as tdemo
from shapley_vit_tpu_torch.fl import ingestion as ting
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from shapley_vit_tpu_torch.ops import _build
from test_torch_client import _float32_jax_weights
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sv_array(sv):
    return np.array([[sv[d][c] for c in sorted(sv[d])] for d in range(len(sv))])


def test_quickstart_matches_the_jax_steps():
    # the JAX quickstart's steps (examples/quickstart.py:33-90) on micro
    spec = jvit.make_spec("micro", num_classes=4)
    base = jvit.init_vit(jax.random.key(0), spec)
    lora0 = jvit.init_lora(jax.random.key(1), spec, classifier_from=base)
    leaves, treedef = jax.tree.flatten(lora0)
    deltas = [treedef.unflatten([
        0.05 * jax.random.normal(k, leaf.shape)
        for k, leaf in zip(jax.random.split(jax.random.key(10 + i), len(leaves)), leaves)])
        for i in range(3)]
    rng = np.random.default_rng(0)
    images = rng.normal(size=(64, spec.image, spec.image, 3)).astype(np.float32)
    labels = rng.integers(0, 4, size=64)
    data = [(images[i:i + 32], labels[i:i + 32]) for i in range(0, 64, 32)]
    evaluator = jev.make_coalition_evaluator(lambda b, lo, x: jvit.vit_forward(b, lo, x, spec))
    stacked = jtm.tree_stack(deltas)
    mat = jax.jit(jtm.materialize_coalitions)
    prev = jev.evaluate_model(lambda p, x: jvit.vit_forward(p[0], p[1], x, spec),
                              (base, lora0), data)
    game = JGame(eval_coalitions_fn=lambda W: evaluator(base, mat(lora0, stacked, W), data,
                                                        dataset_size=64),
                 num_local_data=[120, 300, 580], client_selection_vector=[True] * 3,
                 previous_utility=list(prev))
    sv = j_exact(game)
    exact_evals = game.num_evaluations
    sv_cc = j_cc(game, m=150, rng=np.random.default_rng(0))

    tspec = tvit.make_spec("micro", num_classes=4)
    host = jax.device_get
    got = tquick.run_quickstart(
        tspec, tree_from_numpy(host(base)), tree_from_numpy(host(lora0)),
        [tree_from_numpy(host(d)) for d in deltas], torch.tensor(images), torch.tensor(labels),
        batch=32, log=lambda s: None)
    np.testing.assert_allclose(got["initial_utility"], prev, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_sv_array(got["exact"]), _sv_array(sv), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_sv_array(got["comp_contrib"]), _sv_array(sv_cc), atol=1e-4, rtol=0)
    assert got["exact_evaluations"] == exact_evals == 7
    assert got["evaluations"] == game.num_evaluations == 7
    assert np.abs(_sv_array(sv)).max() > 1e-3  # the deltas move the utilities
    # efficiency: the exact SVs sum to v(N) - v(empty)
    np.testing.assert_allclose(_sv_array(got["exact"]).sum(1), got["grand_coalition"], atol=1e-6)


def test_quickstart_cli_on_the_cpu(capsys):
    out = tquick.main(["--device", "cpu", "--val-size", "16", "--batch", "8"])
    assert out["exact_evaluations"] == 7 and out["evaluations"] == 7
    assert "exact SV (accuracy dim)" in capsys.readouterr().out


@pytest.fixture(scope="module")
def demo_runs(tmp_path_factory):
    """Both packages' service demo on micro from the same float32 weights."""
    tmp = tmp_path_factory.mktemp("serve_demo")
    jdemo = _jax_example("serve_demo")
    jcfg = JConfig()
    jcfg.model.vit_variant = "micro"
    jcfg.data.image_size = 16
    jcfg.data.eval_batch_size = 32
    jcfg.obs.exp_dir = str(tmp / "jax" / "exp")
    jcfg.paths.validation_dataset = ""
    jcfg.paths.local_model_path = str(tmp / "jax" / "local")
    jcfg.paths.global_model_path = str(tmp / "jax" / "global")
    jcfg.data.synthetic_scale = 0.02
    tcfg = tdemo.demo_config(out_dir=str(tmp / "torch"))
    with pytest.MonkeyPatch.context() as mp:
        _float32_jax_weights(mp)
        want = jdemo.run_demo(jcfg, epochs=2, local_steps=2)
        got = tdemo.run_demo(tcfg, epochs=2, local_steps=2, device="cpu")
    return tmp, want, got, tcfg


def test_serve_demo_matches_jax(demo_runs):
    _, (jrecords, _), (trecords, out), tcfg = demo_runs
    assert [r["epoch"] for r in trecords] == [r["epoch"] for r in jrecords] == [0, 1]
    for jr, tr_ in zip(jrecords, trecords):
        np.testing.assert_allclose(_sv_array(tr_["shapley"]), _sv_array(jr["shapley"]),
                                   atol=1e-4, rtol=0)
    assert np.abs(_sv_array(jrecords[1]["shapley"])).max() > 1e-3
    for e in (0, 1):
        assert os.path.exists(os.path.join(tcfg.paths.global_model_path,
                                           f"ViT_global_epoch_{e}.npz"))
    for c in range(3):
        meta = ting.load_checkpoint_metadata(os.path.join(
            tcfg.paths.local_model_path, f"client_{c + 1}_model", "ViT_epoch_1.npz"))
        assert int(meta["num_local_data_train"]) > 0
    with open(os.path.join(out, "sv_trajectory.png"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_serve_demo_raster_without_matplotlib(demo_runs, tmp_path, monkeypatch):
    from shapley_vit_tpu_torch.utils.tb_events import decode_png

    svs = [r["shapley"] for r in demo_runs[2][0]]
    monkeypatch.setattr(tdemo, "_has_matplotlib", lambda: False)
    path = str(tmp_path / "traj.png")
    tdemo.plot_trajectory(svs, path)
    with open(path, "rb") as f:
        img = decode_png(f.read())
    assert img.shape == (240, 320, 3) and len(np.unique(img.reshape(-1, 3), axis=0)) >= 4
    assert not tdemo.demo_config().obs.render_plots


def test_serve_demo_fails_when_a_client_raises(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ting, "save_lora_checkpoint", broken)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="client thread failed") as err:
        tdemo.run_demo(tdemo.demo_config(out_dir=str(tmp_path)), epochs=2, local_steps=1,
                       device="cpu")
    assert isinstance(err.value.__cause__, OSError)
    assert time.perf_counter() - t0 < 120  # the drain stopped the service, not its timeout


def test_library_loads_once_under_concurrent_first_use(monkeypatch):
    builds, loads = [], []

    def slow_build(names, extra_flags=()):
        builds.append(list(names))
        time.sleep(0.2)
        return 0.2

    class FakeLib:
        def __init__(self, path):
            loads.append(path)
            self.svt_entry = type("F", (), {})()

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_build, "_loaded", {})
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.load("mlp_block", {"svt_entry": []})))
               for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert builds == [["mlp_block"]] and len(loads) == 1
    assert len(got) == 16 and all(g is got[0] for g in got)


def test_launch_counts_are_exact_across_threads():
    def wrapper():
        pass

    wrapper.launches, wrapper.launches_by, wrapper.route = 0, collections.Counter(), None

    def launch_many():
        for _ in range(5000):
            _build.count(wrapper, "wgmma", "wgmma bfloat16")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        threads = [threading.Thread(target=launch_many) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert wrapper.launches == 80000 and wrapper.launches_by["wgmma bfloat16"] == 80000
    assert wrapper.route == "wgmma"
