"""The kernel build's library names: each hashes its source and every shared
header, so an edit to either loads a fresh build and never a stale library.

Runs on the CPU (no ``nvcc`` needed): the digest is computed from the files
alone. Each test points ``_build.CSRC`` at its own copy of ``csrc/``.
"""

import shutil

import pytest

from shapley_vit_tpu_torch.ops import _build
from torch_one_thread import one_torch_thread  # noqa: F401

HEADERS = ("common.cuh", "hopper.cuh")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_the_shared_headers_are_in_csrc():
    assert sorted(p.name for p in _build.CSRC.glob("*.cuh")) == sorted(HEADERS)


def test_digest_is_stable(csrc):
    assert {k: _build._digest(k) for k in _build.KERNELS} == {
        k: _build._digest(k) for k in _build.KERNELS
    }


@pytest.mark.parametrize("kernel", _build.KERNELS)
@pytest.mark.parametrize("header", HEADERS)
def test_digest_follows_every_header(csrc, kernel, header):
    before = _build._digest(kernel)
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    assert _build._digest(kernel) != before
    assert _build.library_path(kernel).name != f"lib{kernel}-{before}.so"


@pytest.mark.parametrize("kernel", _build.KERNELS)
def test_digest_follows_a_new_header(csrc, kernel):
    before = _build._digest(kernel)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._digest(kernel) != before


@pytest.mark.parametrize("kernel", _build.KERNELS)
def test_digest_follows_its_own_source_only(csrc, kernel):
    digests = {k: _build._digest(k) for k in _build.KERNELS}
    with open(csrc / f"{kernel}.cu", "a") as f:
        f.write("\n// edited\n")
    for k in _build.KERNELS:
        assert (_build._digest(k) != digests[k]) == (k == kernel)
