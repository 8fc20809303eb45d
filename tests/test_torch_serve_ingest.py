"""The port's service ingest, as the JAX package's ``tests/test_serve.py``
holds its own: the prefetcher's pipelined ingest gives the serial path's
Shapley values bit for bit, a re-upload between prefetch and consume falls
back to the serial path, and the merged and overlay evaluators agree at
float32. Micro ViT on the CPU."""

import os
import shutil

import pytest

from shapley_vit_tpu_torch.driver import serve as tserve
from test_torch_serve_common import port_model, service_cfg, write_epoch
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture
def cfg(tmp_path):
    return service_cfg(tmp_path)


def test_pipelined_ingest_equals_serial(cfg):
    spec, _, init = port_model(cfg)
    for e in range(3):
        write_epoch(cfg, spec, init, e)
    pipe = tserve.serve(cfg, max_rounds=3, timeout=10.0, policy="fail", pipeline_ingest=True,
                        device="cpu", prewarm=False)
    # wipe the service state so the second run starts at epoch 0 again
    shutil.rmtree(cfg.obs.exp_dir)
    serial = tserve.serve(cfg, max_rounds=3, timeout=10.0, policy="fail",
                          pipeline_ingest=False, device="cpu", prewarm=False)
    assert len(pipe) == len(serial) == 3
    # round 0 has no earlier span to overlap; rounds 1-2 were pre-staged
    assert [r["pipelined_ingest"] for r in pipe] == [False, True, True]
    assert not any(r["pipelined_ingest"] for r in serial)
    for rp, rs in zip(pipe, serial):
        assert rp["shapley"] == rs["shapley"], rp["epoch"]
        assert rp["utility"] == rs["utility"]


def test_pipelined_ingest_falls_back_on_reupload(cfg, monkeypatch):
    spec, _, init = port_model(cfg)
    for e in range(2):
        write_epoch(cfg, spec, init, e)
    orig_take = tserve._IngestPrefetcher.take

    def tampering_take(self, epoch, paths):
        r = orig_take(self, epoch, paths)
        if r is not None:
            # a re-upload after the prefetch parsed: client 1's file changes
            write_epoch(cfg, spec, init, epoch, clients=1, scale=0.11)
        return r

    monkeypatch.setattr(tserve._IngestPrefetcher, "take", tampering_take)
    records = tserve.serve(cfg, max_rounds=2, timeout=10.0, policy="fail",
                           pipeline_ingest=True, device="cpu", prewarm=False)
    assert len(records) == 2
    assert not records[1]["pipelined_ingest"]  # never the stale prefetch


def test_pipeline_ingest_env_switch(cfg, monkeypatch):
    spec, _, init = port_model(cfg)
    for e in range(2):
        write_epoch(cfg, spec, init, e)
    monkeypatch.setenv("SVT_PIPELINE_INGEST", "0")
    records = tserve.serve(cfg, max_rounds=2, timeout=10.0, policy="fail", device="cpu",
                           prewarm=False)
    assert [r["pipelined_ingest"] for r in records] == [False, False]


def test_merged_matches_overlay_eval_mode(cfg):
    cfg.model.compute_dtype = "float32"
    spec, _, init = port_model(cfg)
    write_epoch(cfg, spec, init, 0)
    assert cfg.model.eval_mode == "merged"  # the default
    merged = tserve.serve(cfg, max_rounds=1, timeout=30.0, policy="fail", device="cpu",
                          prewarm=False)
    shutil.rmtree(cfg.obs.exp_dir)
    cfg.model.eval_mode = "overlay"
    overlay = tserve.serve(cfg, max_rounds=1, timeout=30.0, policy="fail", device="cpu",
                           prewarm=False)
    assert merged[0]["utility"] == pytest.approx(overlay[0]["utility"], abs=1e-5)
    for d in range(2):
        for c in range(3):
            assert merged[0]["shapley"][d][c] == pytest.approx(overlay[0]["shapley"][d][c],
                                                               abs=1e-5)
    assert os.path.exists(os.path.join(cfg.paths.global_model_path, "ViT_global_epoch_0.npz"))
