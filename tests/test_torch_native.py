"""The port's native runtime (``fl/native.py`` on its own copy of
``csrc/svt_runtime.cpp``): the JAX package's ``tests/test_native.py`` cases
against the port's modules. The library is built with ``g++`` on first use
into the port's build directory; the cases skip without a toolchain, as the
JAX package's do."""

import os
import threading
import time

import numpy as np
import pytest

from shapley_vit_tpu_torch.fl import ingestion, native
from torch_one_thread import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(
    not native.build_native(), reason="native toolchain unavailable"
)


def test_version_string():
    lib = native.load_native()
    assert b"svt_runtime" in lib.svt_version()


def test_wait_for_files_immediate(tmp_path):
    p = str(tmp_path / "x.npz")
    open(p, "w").write("d")
    arrived, count = native.wait_for_files([p], timeout=1.0)
    assert arrived == [True] and count == 1


def test_wait_for_files_detects_atomic_rename(tmp_path):
    p1 = str(tmp_path / "a.npz")
    p2 = str(tmp_path / "later" / "b.npz")  # parent dir doesn't exist yet
    open(p1, "w").write("d")

    def deliver():
        time.sleep(0.25)
        os.makedirs(os.path.dirname(p2), exist_ok=True)
        tmp = p2 + ".tmp"
        open(tmp, "w").write("y")
        os.replace(tmp, p2)  # the atomic protocol

    t = threading.Thread(target=deliver)
    t.start()
    t0 = time.time()
    arrived, count = native.wait_for_files([p1, p2], timeout=5.0)
    latency = time.time() - t0
    t.join()
    assert count == 2 and all(arrived)
    assert latency < 2.0  # event-driven, not a 1s-per-cycle poll


def test_wait_for_files_timeout(tmp_path):
    arrived, count = native.wait_for_files(
        [str(tmp_path / "never.npz")], timeout=0.2
    )
    assert arrived == [False] and count == 0


def test_wait_for_file_groups_any_candidate(tmp_path):
    """A client satisfies its group with WHICHEVER format arrives — the
    event-driven path covers mixed .pth.tar/.npz fleets."""
    groups = [
        [str(tmp_path / "c1" / "m.pth.tar"), str(tmp_path / "c1" / "m.npz")],
        [str(tmp_path / "c2" / "m.pth.tar"), str(tmp_path / "c2" / "m.npz")],
    ]

    def deliver():
        time.sleep(0.25)
        for path in (groups[0][1], groups[1][0]):  # one .npz, one .pth.tar
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            open(tmp, "w").write("y")
            os.replace(tmp, path)

    t = threading.Thread(target=deliver)
    t.start()
    t0 = time.time()
    found, count = native.wait_for_file_groups(groups, timeout=5.0)
    latency = time.time() - t0
    t.join()
    assert count == 2
    assert found[0].endswith(".npz") and found[1].endswith(".pth.tar")
    assert latency < 2.0  # event-driven, not a 1s-per-cycle poll


def test_wait_for_file_groups_timeout(tmp_path):
    found, count = native.wait_for_file_groups(
        [[str(tmp_path / "never.pth.tar"), str(tmp_path / "never.npz")]],
        timeout=0.2,
    )
    assert found == [None] and count == 0


def test_preload_files_contents_and_errors(tmp_path, rng):
    paths = []
    blobs = []
    for i in range(8):
        blob = rng.bytes(1000 + i * 37)
        p = str(tmp_path / f"f{i}.bin")
        open(p, "wb").write(blob)
        paths.append(p)
        blobs.append(blob)
    paths.append("/nonexistent/file")
    out = native.preload_files(paths, threads=4)
    for got, want in zip(out[:-1], blobs):
        assert got == want
    assert out[-1] is None


def test_ingestion_uses_native_backend(tmp_path):
    """wait_for_checkpoints routes through the inotify watcher when built."""
    p = str(tmp_path / "ck.npz")
    ingestion.atomic_save_npz(p, {"x": np.zeros(1)})
    r = ingestion.wait_for_checkpoints([p], timeout=1.0, policy="fail")
    assert r.arrived == [True]
    # skip policy with native backend
    r = ingestion.wait_for_checkpoints(
        [p, str(tmp_path / "missing.npz")], timeout=0.2, policy="skip"
    )
    assert r.arrived == [True, False] and r.paths[1] is None


def test_ingestion_grouped_candidates_native(tmp_path):
    """Grouped candidate paths resolve through the native group watcher
    (first listed candidate wins when both formats exist)."""
    root = str(tmp_path)
    cands = ingestion.checkpoint_path_candidates(root, 2, filename="m.npz")
    # client 1 delivers .npz (first candidate), client 2 the .pth.tar sibling
    os.makedirs(os.path.dirname(cands[0][0]), exist_ok=True)
    ingestion.atomic_save_npz(cands[0][0], {"x": np.zeros(1)})
    os.makedirs(os.path.dirname(cands[1][1]), exist_ok=True)
    open(cands[1][1], "w").write("torch-bytes")
    r = ingestion.wait_for_checkpoints(cands, timeout=2.0, policy="fail")
    assert r.paths[0].endswith(".npz") and r.paths[1].endswith(".pth.tar")
    # straggler skip still works through the native group path
    cands3 = ingestion.checkpoint_path_candidates(root, 3, filename="m.npz")
    r = ingestion.wait_for_checkpoints(cands3, timeout=0.3, policy="skip")
    assert r.arrived == [True, True, False] and r.paths[2] is None


def test_port_builds_and_loads_its_own_library():
    """The port's library lives in its own build directory, named by the
    digest of its own source; the JAX package's ``csrc/libsvt_runtime.so``
    is never loaded."""
    native.load_native()
    path = native._LIB_PATH
    assert path is not None and "shapley_vit_tpu_torch" in path
    assert os.path.basename(path).startswith("libsvt_runtime-")
    assert os.path.dirname(path).endswith(os.path.join("shapley_vit_tpu_torch", "build"))


def test_wait_polls_when_the_native_watcher_is_off(tmp_path):
    p = str(tmp_path / "ck.npz")
    ingestion.atomic_save_npz(p, {"x": np.zeros(1)})
    sleeps = []
    r = ingestion.wait_for_checkpoints(
        [p, str(tmp_path / "missing.npz")], timeout=0.0, policy="skip",
        use_native=False, _sleep=sleeps.append,
    )
    assert r.arrived == [True, False] and sleeps == []


def test_should_stop_ends_the_wait_early(tmp_path):
    """A drain (``should_stop``) escapes an indefinite wait on both backends
    and never raises, even under policy='fail'."""
    missing = [str(tmp_path / "never.npz")]
    for use_native in (True, False):
        t0 = time.time()
        r = ingestion.wait_for_checkpoints(missing, timeout=None, policy="fail",
                                           poll_interval=0.05, use_native=use_native,
                                           should_stop=lambda: time.time() - t0 > 0.2)
        assert r.arrived == [False] and time.time() - t0 < 5.0
