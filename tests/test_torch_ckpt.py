"""Torch-free torch-zip checkpoint reader/writer (fl/torch_ckpt.py).

Contract under test (reference: clients torch.save ViT_epoch_9.pth.tar,
server torch.loads it — start.py:146-151 / server2.py:68-81):
  * real torch.save output parses byte-exactly through the native reader
    (views, storage offsets, 0-d tensors, bf16/f16/int/bool dtypes);
  * the native writer's output loads through real torch.load AND through
    the native reader;
  * a checkpoint whose pickle strays off the tensor allow-list is REJECTED
    (a server ingesting untrusted client uploads must never execute
    arbitrary unpicklers — torch.load(weights_only=False) would);
  * legacy (pre-1.6, non-zip) torch files raise NativeFormatError and
    ingestion falls back to torch with weights_only=True;
  * the .pth.tar ingest/save path never imports torch (round-4 soak rule).
"""

import io
import os
import pickle
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from shapley_vit_tpu.fl import torch_ckpt as tc
from torch_one_thread import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# torch.save -> native read
# ---------------------------------------------------------------------------

def test_reads_real_torch_checkpoint(tmp_path):
    torch = pytest.importorskip("torch")
    t = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    obj = {
        "state_dict": {
            "w": t,
            "wT": t.t(),  # non-contiguous strides
            "slice": t[1:, 2:],  # nonzero storage offset
            "h": torch.randn(2, 3).half(),
            "i64": torch.arange(7),
            "i32": torch.arange(5, dtype=torch.int32),
            "u8": torch.arange(9, dtype=torch.uint8),
            "b": torch.tensor([True, False, True]),
            "scalar": torch.tensor(3.5),
        },
        "num_local_data_train": 123,
        "note": "hello",
    }
    p = str(tmp_path / "ref.pth.tar")
    torch.save(obj, p)
    back = tc.read_checkpoint(p)
    assert back["num_local_data_train"] == 123
    assert back["note"] == "hello"
    for k, v in obj["state_dict"].items():
        got = back["state_dict"][k]
        assert got.shape == tuple(v.shape), k
        np.testing.assert_array_equal(got, v.numpy(), err_msg=k)
    # reads from raw bytes too (the bulk-preload path)
    with open(p, "rb") as f:
        again = tc.read_checkpoint(f.read())
    np.testing.assert_array_equal(again["state_dict"]["w"], t.numpy())


def test_reads_torch_bfloat16(tmp_path):
    torch = pytest.importorskip("torch")
    import ml_dtypes

    v = torch.randn(3, 5).to(torch.bfloat16)
    p = str(tmp_path / "bf.pth.tar")
    torch.save({"x": v}, p)
    got = tc.read_checkpoint(p)["x"]
    assert got.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(
        got.astype(np.float32), v.float().numpy()
    )


# ---------------------------------------------------------------------------
# native write -> torch.load / native read
# ---------------------------------------------------------------------------

def _sample_obj():
    import ml_dtypes

    return {
        "state_dict": {
            "a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "bf": np.full((2, 2), 1.5, dtype=ml_dtypes.bfloat16),
            "i64": np.arange(5),
            "s0": np.array(2.25, np.float32),
            "F": np.asfortranarray(np.arange(12.0, dtype=np.float32).reshape(3, 4)),
        },
        "num_local_data_train": 9,
        "f": 2.5,
        "flag": True,
        "none": None,
        "lst": [1, 2, "x"],
        "tup": (1, 2),
        "big": 2**40,
        "neg": -5,
    }


def test_native_write_loads_in_torch(tmp_path):
    torch = pytest.importorskip("torch")
    out = _sample_obj()
    p = str(tmp_path / "native.pth.tar")
    tc.write_checkpoint(p, out)
    # weights_only=True: the file must be loadable WITHOUT the full pickle
    # machinery — proof the writer emits only the tensor vocabulary
    lb = torch.load(p, map_location="cpu", weights_only=True)
    assert lb["num_local_data_train"] == 9
    assert lb["f"] == 2.5 and lb["flag"] is True and lb["none"] is None
    assert lb["lst"] == [1, 2, "x"] and lb["tup"] == (1, 2)
    assert lb["big"] == 2**40 and lb["neg"] == -5
    sd = lb["state_dict"]
    np.testing.assert_array_equal(sd["a"].numpy(), out["state_dict"]["a"])
    np.testing.assert_array_equal(sd["F"].numpy(), out["state_dict"]["F"])
    np.testing.assert_array_equal(sd["i64"].numpy(), out["state_dict"]["i64"])
    assert sd["bf"].dtype == torch.bfloat16
    assert float(sd["bf"].float().mean()) == 1.5
    assert sd["s0"].shape == () and float(sd["s0"]) == 2.25


def test_native_roundtrip_without_torch(tmp_path):
    out = _sample_obj()
    p = str(tmp_path / "native.pth.tar")
    tc.write_checkpoint(p, out)
    back = tc.read_checkpoint(p)
    assert back["num_local_data_train"] == 9
    assert back["tup"] == (1, 2)
    for k, v in out["state_dict"].items():
        got = back["state_dict"][k]
        assert got.shape == v.shape and got.dtype == v.dtype, k
        np.testing.assert_array_equal(
            got.astype(np.float64), np.asarray(v, dtype=np.float64), err_msg=k
        )
    assert not os.path.exists(p + ".tmp")  # atomic rename


def test_writer_rejects_unsupported_types(tmp_path):
    with pytest.raises(TypeError, match="cannot serialize"):
        tc.write_checkpoint(str(tmp_path / "x.pth.tar"), {"bad": object()})


# ---------------------------------------------------------------------------
# security: restricted unpickling
# ---------------------------------------------------------------------------

def test_malicious_pickle_rejected(tmp_path):
    """GLOBAL os.system in data.pkl — torch.load(weights_only=False) would
    execute it; the native reader must refuse before any side effect."""
    marker = str(tmp_path / "pwned")
    payload = (
        b"\x80\x02cos\nsystem\n"
        + b"X" + len(f"touch {marker}".encode()).to_bytes(4, "little")
        + f"touch {marker}".encode()
        + b"\x85R."
    )
    p = str(tmp_path / "evil.pth.tar")
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("evil/data.pkl", payload)
        zf.writestr("evil/version", b"3\n")
    with pytest.raises(tc.UnsafeCheckpointError, match="os.'system'"):
        tc.read_checkpoint(p)
    assert not os.path.exists(marker)


def test_malicious_persistent_id_rejected(tmp_path):
    class Pers(pickle.Pickler):
        def persistent_id(self, obj):
            return "not-a-storage" if obj == "PID" else None

    buf = io.BytesIO()
    Pers(buf, protocol=2).dump({"x": "PID"})
    p = str(tmp_path / "pid.pth.tar")
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("pid/data.pkl", buf.getvalue())
        zf.writestr("pid/version", b"3\n")
    with pytest.raises(tc.UnsafeCheckpointError, match="persistent id"):
        tc.read_checkpoint(p)


def test_truncated_storage_rejected(tmp_path):
    torch = pytest.importorskip("torch")
    p = str(tmp_path / "trunc.pth.tar")
    torch.save({"x": torch.zeros(8)}, p)
    z = zipfile.ZipFile(p)
    names = z.namelist()
    out = str(tmp_path / "cut.pth.tar")
    with zipfile.ZipFile(out, "w") as zf:
        for n in names:
            data = z.read(n)
            if n.endswith("data/0"):
                data = data[:5]  # 8 f32 elements need 32 bytes
            zf.writestr(n, data)
    with pytest.raises(tc.NativeFormatError, match="bytes"):
        tc.read_checkpoint(out)


# ---------------------------------------------------------------------------
# legacy format fallback + ingestion wiring
# ---------------------------------------------------------------------------

def test_legacy_format_raises_native_error(tmp_path):
    p = str(tmp_path / "legacy.pth.tar")
    with open(p, "wb") as f:
        f.write(b"\x80\x02}q\x00.")  # a bare pickle, not a zip
    with pytest.raises(tc.NativeFormatError):
        tc.read_checkpoint(p)


def test_ingestion_refuses_legacy_by_default(tmp_path, monkeypatch):
    """A client must not be able to OPT INTO torch's unpickler by writing a
    non-zip file: the legacy fallback is gated on SVT_TORCH_LEGACY_CKPT."""
    torch = pytest.importorskip("torch")
    from shapley_vit_tpu.fl import ingestion

    sd = {"lin.weight": torch.arange(4, dtype=torch.float32).reshape(2, 2)}
    p = str(tmp_path / "legacy.pth.tar")
    torch.save(
        {"state_dict": sd, "num_local_data_train": 11},
        p,
        _use_new_zipfile_serialization=False,
    )
    monkeypatch.delenv("SVT_TORCH_LEGACY_CKPT", raising=False)
    with pytest.raises(tc.NativeFormatError, match="SVT_TORCH_LEGACY_CKPT"):
        ingestion._load_raw(p)

    monkeypatch.setenv("SVT_TORCH_LEGACY_CKPT", "1")
    got, meta = ingestion._load_raw(p)
    np.testing.assert_array_equal(got["lin.weight"], sd["lin.weight"].numpy())
    assert meta["num_local_data_train"] == 11


# ---------------------------------------------------------------------------
# hostile tensor geometry (review findings): as_strided has no bounds checks
# ---------------------------------------------------------------------------

def _geometry_payload(offset, size, stride, numel=4):
    """data.pkl calling _rebuild_tensor_v2(storage(numel f32), offset,
    size, stride, False, OrderedDict()) — hand-assembled opcodes."""
    def u(s):
        b = s.encode()
        return b"X" + len(b).to_bytes(4, "little") + b

    def i(v):
        return b"J" + v.to_bytes(4, "little", signed=True)

    def tup(vals):
        return b"(" + b"".join(i(v) for v in vals) + b"t"

    return (
        b"\x80\x02"
        + b"ctorch._utils\n_rebuild_tensor_v2\n"
        + b"("
        + b"(" + u("storage") + b"ctorch\nFloatStorage\n"
        + u("0") + u("cpu") + i(numel) + b"tQ"
        + i(offset) + tup(size) + tup(stride)
        + b"\x89" + b"ccollections\nOrderedDict\n)R"
        + b"tR."
    )


@pytest.mark.parametrize(
    "offset,size,stride",
    [
        (0, (1000000,), (4096,)),  # the segfault repro: walks ~16 GB
        (0, (8,), (1,)),           # one past the 4-element storage
        (3, (2,), (1,)),           # offset pushes past the end
        (-1, (2,), (1,)),          # negative offset
        (0, (2,), (-1,)),          # negative stride
        (0, (2, 2), (1,)),         # rank mismatch
    ],
)
def test_hostile_tensor_geometry_rejected(tmp_path, offset, size, stride):
    p = str(tmp_path / "geom.pth.tar")
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("g/data.pkl", _geometry_payload(offset, size, stride))
        zf.writestr("g/data/0", np.zeros(4, np.float32).tobytes())
        zf.writestr("g/version", b"3\n")
    with pytest.raises(tc.UnsafeCheckpointError):
        tc.read_checkpoint(p)


def test_valid_offset_view_still_reads(tmp_path):
    """The bounds check must not reject legitimate geometry: last element
    exactly at the end of storage."""
    p = str(tmp_path / "ok.pth.tar")
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("g/data.pkl", _geometry_payload(1, (3,), (1,)))
        zf.writestr("g/data/0", np.arange(4, dtype=np.float32).tobytes())
        zf.writestr("g/version", b"3\n")
    np.testing.assert_array_equal(
        tc.read_checkpoint(p), np.array([1.0, 2.0, 3.0], np.float32)
    )


def test_negative_numel_rejected(tmp_path):
    p = str(tmp_path / "neg.pth.tar")
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("g/data.pkl", _geometry_payload(0, (2,), (1,), numel=-1))
        zf.writestr("g/data/0", np.zeros(4, np.float32).tobytes())
        zf.writestr("g/version", b"3\n")
    with pytest.raises(tc.UnsafeCheckpointError, match="numel"):
        tc.read_checkpoint(p)


def test_randomized_roundtrip_fuzz(tmp_path):
    """Seeded structure fuzz: random nested containers of random-dtype
    arrays round-trip native->native and native->torch bit-exactly."""
    torch = pytest.importorskip("torch")
    import ml_dtypes

    rng = np.random.default_rng(0)
    dtypes = [
        np.float32, np.float64, np.float16, np.int64, np.int32, np.int16,
        np.int8, np.uint8, np.bool_, ml_dtypes.bfloat16,
    ]

    def rand_array():
        shape = tuple(int(d) for d in rng.integers(0, 5, size=rng.integers(0, 4)))
        dt = dtypes[rng.integers(len(dtypes))]
        a = rng.normal(size=shape) * 10
        if np.dtype(dt) == np.bool_:
            return a > 0
        return a.astype(dt)

    def rand_obj(depth):
        kind = rng.integers(6 if depth < 3 else 4)
        if kind == 0:
            return rand_array()
        if kind == 1:
            return float(rng.normal())
        if kind == 2:
            return int(rng.integers(-(2**40), 2**40))
        if kind == 3:
            return ["s", None, bool(rng.integers(2))]
        if kind == 4:
            return {f"k{i}": rand_obj(depth + 1) for i in range(rng.integers(1, 4))}
        return tuple(rand_obj(depth + 1) for _ in range(rng.integers(1, 3)))

    def assert_same(a, b, path="root"):
        if isinstance(a, np.ndarray):
            b = b.numpy() if hasattr(b, "numpy") and not isinstance(b, np.ndarray) else b
            assert tuple(np.shape(b)) == a.shape, path
            np.testing.assert_array_equal(
                np.asarray(a, np.float64), np.asarray(b, np.float64), err_msg=path
            )
        elif isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                assert_same(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                assert_same(x, y, f"{path}[{i}]")
        else:
            assert a == b, path

    for trial in range(20):
        obj = {f"t{i}": rand_obj(0) for i in range(3)}
        p = str(tmp_path / f"fuzz_{trial}.pth.tar")
        tc.write_checkpoint(p, obj)
        assert_same(obj, tc.read_checkpoint(p), f"native[{trial}]")
        lb = torch.load(p, map_location="cpu", weights_only=True)
        # torch reads bf16 as torch tensors; compare through numpy()/float
        def to_np(x):
            if hasattr(x, "numpy"):
                return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
            return x
        assert_same(
            obj, __import__("jax").tree.map(
                to_np, lb, is_leaf=lambda v: hasattr(v, "numpy")
            ),
            f"torch[{trial}]",
        )


def test_writer_handles_numpy_bool_and_big_endian(tmp_path):
    torch = pytest.importorskip("torch")
    obj = {
        "flag": np.bool_(True),
        "be": np.arange(3, dtype=">f4"),
        "bools": np.array([True, False]),
    }
    p = str(tmp_path / "nb.pth.tar")
    tc.write_checkpoint(p, obj)
    lb = torch.load(p, map_location="cpu", weights_only=True)
    assert lb["flag"] is True
    np.testing.assert_array_equal(lb["be"].numpy(), [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(lb["bools"].numpy(), [True, False])


def test_ingest_path_never_imports_torch(tmp_path):
    """Write AND read a .pth.tar LoRA checkpoint through ingestion in a
    fresh interpreter; 'torch' must never appear in sys.modules (the
    round-4 soak rule: no torch in the serve process)."""
    script = f"""
import sys, numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from shapley_vit_tpu.fl import ingestion
from shapley_vit_tpu.models import vit as jvit
spec = jvit.make_spec("micro", num_classes=4)
lora = jvit.init_lora(jax.random.key(0), spec)
path = {str(tmp_path / 'client_1_model' / 'ViT_epoch_9.pth.tar')!r}
ingestion.save_lora_checkpoint(path, lora, spec, num_local_data_train=7)
back = ingestion.load_client_lora(path, spec)
sizes = ingestion.load_checkpoint_metadata(path)
assert sizes.get("num_local_data_train") == 7, sizes
la, lb = jax.tree.leaves(lora), jax.tree.leaves(back)
assert all(np.allclose(a, b, atol=1e-7) for a, b in zip(la, lb))
assert "torch" not in sys.modules, "torch leaked into the ingest path"
print("TORCH_FREE_OK")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True,
        text=True,
        timeout=300,
        env=env,
        cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr
    assert "TORCH_FREE_OK" in r.stdout
