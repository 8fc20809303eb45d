"""The port's native TensorBoard event writer (``utils/tb_events.py``, a
copy of the JAX package's): the JAX package's ``tests/test_tb_events.py``
cases against the port's modules. The format is pinned three independent
ways: the generic wire-format decoder (fast), the crc32c fallback vs
google_crc32c (fast), and TensorFlow's own ``summary_iterator`` (slow tier,
skipped without tensorflow, as the JAX package's are). The port's
``TensorBoardWriter`` imports neither tensorflow nor torch.
"""

import os
import struct

import numpy as np
import pytest

from shapley_vit_tpu_torch.utils import tb_events
from torch_one_thread import one_torch_thread  # noqa: F401


def test_round_trip_scalars(tmp_path):
    w = tb_events.ScalarEventWriter(str(tmp_path))
    expect = []
    for step in range(3):
        for tag, v in (("shapley/accuracy/client_1", 0.25 * step),
                       ("round/wall_s", 1.5 + step),
                       ("neg/loss", -3.25)):
            w.add_scalar(tag, v, step)
            expect.append((tag, v, step))
    w.close()
    got = tb_events.read_scalar_events(w.path)
    assert got == [(t, pytest.approx(v), s) for t, v, s in expect]


def test_file_starts_with_version_event(tmp_path):
    w = tb_events.ScalarEventWriter(str(tmp_path))
    w.close()
    with open(w.path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack_from("<Q", data, 0)
    body = data[12:12 + n]
    fields = tb_events._decode_fields(body)
    assert fields[(3, 2)] == b"brain.Event:2"


def test_crc32c_fallback_matches_native():
    """The table-driven fallback must agree with google_crc32c (when the
    import is absent the fallback IS the format)."""
    google_crc32c = pytest.importorskip("google_crc32c")
    table = []
    poly = 0x82F63B78
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)

    def fallback(data):
        c = 0xFFFFFFFF
        for b in data:
            c = table[(c ^ b) & 0xFF] ^ (c >> 8)
        return c ^ 0xFFFFFFFF

    for payload in (b"", b"a", b"hello world", bytes(range(256)) * 3):
        assert fallback(payload) == int(google_crc32c.value(payload))


def test_crc_corruption_detected(tmp_path):
    w = tb_events.ScalarEventWriter(str(tmp_path))
    w.add_scalar("t", 1.0, 0)
    w.close()
    with open(w.path, "rb") as f:
        data = bytearray(f.read())
    data[-6] ^= 0xFF  # flip a payload byte of the last record
    with open(w.path, "wb") as f:
        f.write(data)
    with pytest.raises(AssertionError):
        tb_events.read_scalar_events(w.path)


def test_writer_no_heavy_imports(tmp_path):
    """The whole point: logging a round must not pull torch/tensorflow."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "from shapley_vit_tpu_torch.utils.logging import TensorBoardWriter\n"
        f"w = TensorBoardWriter({str(tmp_path)!r})\n"
        "w.log_round(0, [{0: 0.5}], utility=[0.1], wall_s=1.0)\n"
        "w.close()\n"
        "banned = [m for m in ('torch', 'tensorflow', 'tensorboard')"
        " if m in sys.modules]\n"
        "assert not banned, banned\n"
        "print('CLEAN')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=root
    )
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout


@pytest.mark.slow
def test_tensorflow_reads_our_files(tmp_path):
    """Ground truth: TF's summary_iterator parses the file bit-for-bit."""
    tf = pytest.importorskip("tensorflow")
    w = tb_events.ScalarEventWriter(str(tmp_path))
    for step in range(4):
        w.add_scalar("sv/client_1", 0.1 * step, step)
    w.close()
    got = []
    for ev in tf.compat.v1.train.summary_iterator(w.path):
        for v in ev.summary.value:
            got.append((v.tag, round(float(v.simple_value), 6), int(ev.step)))
    assert got == [("sv/client_1", round(0.1 * s, 6), s) for s in range(4)]


def test_writer_threaded_appends(tmp_path):
    """The serve loop and the artifact worker may both log; records must
    interleave whole (the framing makes torn writes unreadable)."""
    import threading

    w = tb_events.ScalarEventWriter(str(tmp_path))

    def log(tid):
        for i in range(200):
            w.add_scalar(f"t{tid}", float(i), i)

    threads = [threading.Thread(target=log, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    w.close()
    got = tb_events.read_scalar_events(w.path)
    assert len(got) == 800
    for tid in range(4):
        vals = [(v, s) for tag, v, s in got if tag == f"t{tid}"]
        assert vals == [(float(i), i) for i in range(200)]


def test_negative_step_encodes_and_round_trips(tmp_path):
    """Protobuf varints encode negative int64s as 10-byte two's complement;
    the old shift loop never terminated for n<0 (Python keeps -1 at -1
    under >>), hanging add_scalar in the caller's thread (round-4 review).
    """
    enc = tb_events._varint(-1)
    assert enc == b"\xff" * 9 + b"\x01"  # canonical proto encoding of -1
    w = tb_events.ScalarEventWriter(str(tmp_path))
    w.add_scalar("relative/epoch", 0.5, step=-3)
    w.close()
    assert tb_events.read_scalar_events(w.path) == [
        ("relative/epoch", 0.5, -3)
    ]


def test_round_trip_histogram(tmp_path):
    rng = np.random.default_rng(0)
    vals = rng.normal(2.0, 0.5, size=1000)
    w = tb_events.ScalarEventWriter(str(tmp_path))
    w.add_histogram("sv/dist", vals, step=3, bins=12)
    w.close()
    [(tag, h, step)] = tb_events.read_histogram_events(w.path)
    assert tag == "sv/dist" and step == 3
    assert h["num"] == 1000
    np.testing.assert_allclose(h["min"], vals.min())
    np.testing.assert_allclose(h["max"], vals.max())
    np.testing.assert_allclose(h["sum"], vals.sum())
    np.testing.assert_allclose(h["sum_squares"], (vals * vals).sum())
    assert len(h["bucket"]) == len(h["bucket_limit"]) == 12
    assert sum(h["bucket"]) == 1000
    # scalars in the same file are unaffected
    assert tb_events.read_scalar_events(w.path) == []


def test_round_trip_image_and_png(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(7, 9, 3), dtype=np.uint8)
    gray = rng.random((5, 4)).astype(np.float32)  # float [0,1] grayscale
    w = tb_events.ScalarEventWriter(str(tmp_path))
    w.add_image("viz/rgb", img, step=1)
    w.add_image("viz/gray", gray, step=2)
    w.close()
    events = tb_events.read_image_events(w.path)
    assert [(e[0], e[1], e[2], e[3], e[5]) for e in events] == [
        ("viz/rgb", 7, 9, 3, 1), ("viz/gray", 5, 4, 1, 2)
    ]
    # our own PNG decoder: exact pixel round-trip
    np.testing.assert_array_equal(tb_events.decode_png(events[0][4]), img)
    want_gray = (np.clip(gray, 0, 1) * 255 + 0.5).astype(np.uint8)[:, :, None]
    np.testing.assert_array_equal(tb_events.decode_png(events[1][4]), want_gray)
    # independent decoder: PIL parses the PNG bytes identically
    try:
        import io

        from PIL import Image
    except ImportError:
        return
    pil = np.asarray(Image.open(io.BytesIO(events[0][4])))
    np.testing.assert_array_equal(pil, img)


@pytest.mark.slow
def test_tensorflow_reads_histogram_and_image(tmp_path):
    """Ground truth: TF parses our HistogramProto and Summary.Image."""
    tf = pytest.importorskip("tensorflow")
    rng = np.random.default_rng(2)
    vals = rng.normal(size=256)
    img = rng.integers(0, 256, size=(6, 8, 3), dtype=np.uint8)
    w = tb_events.ScalarEventWriter(str(tmp_path))
    w.add_histogram("h/dist", vals, step=5, bins=10)
    w.add_image("i/pic", img, step=6)
    w.close()
    seen = {}
    for ev in tf.compat.v1.train.summary_iterator(w.path):
        for v in ev.summary.value:
            seen[v.tag] = (v, int(ev.step))
    h, hstep = seen["h/dist"]
    assert hstep == 5
    assert h.histo.num == 256
    np.testing.assert_allclose(h.histo.min, vals.min())
    np.testing.assert_allclose(h.histo.sum, vals.sum())
    assert list(h.histo.bucket_limit) == list(
        np.histogram(vals, bins=10)[1][1:]
    )
    i, istep = seen["i/pic"]
    assert istep == 6
    assert (i.image.height, i.image.width, i.image.colorspace) == (6, 8, 3)
    decoded = tf.io.decode_png(i.image.encoded_image_string).numpy()
    np.testing.assert_array_equal(decoded, img)


def test_log_round_emits_sv_histogram(tmp_path):
    from shapley_vit_tpu_torch.utils.logging import TensorBoardWriter

    tb = TensorBoardWriter(str(tmp_path))
    sv = [{0: 0.1, 1: 0.2, 2: 0.3}, {0: -0.1, 1: 0.0, 2: 0.1}]
    tb.log_round(4, sv, utility=[0.5, 1.2])
    tb.close()
    import glob

    [path] = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    histos = tb_events.read_histogram_events(path)
    assert [(t, s) for t, _, s in histos] == [
        ("shapley/accuracy/distribution", 4), ("shapley/loss/distribution", 4)
    ]
    assert histos[0][1]["num"] == 3
