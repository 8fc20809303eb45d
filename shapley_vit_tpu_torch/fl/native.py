"""ctypes bindings for the native runtime (``csrc/svt_runtime.cpp``).

The port of ``shapley_vit_tpu/fl/native.py``. The C++ library provides the
inotify checkpoint watcher (replacing the reference's 1s polling loop,
start.py:212-219) and a multithreaded file preloader for bulk ingestion.
The port keeps its own copy of the source and builds it with ``g++`` at
first use into ``shapley_vit_tpu_torch/build/`` (``ops/_build.build_host``,
named by a digest of the source); it never loads the JAX package's
``csrc/libsvt_runtime.so``. Every entry point degrades to pure Python when
the library cannot be built (no ``g++``): the failure is logged once and
the watcher polls.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

_lib = None
_LIB_PATH: Optional[str] = None  # the loaded library's path
_build_failed = False


def build_native(force: bool = False) -> bool:
    """Build the port's ``libsvt_runtime-<digest>.so`` with ``g++`` (a no-op
    when it exists). Returns True on success; ``force`` retries after a
    failed build."""
    global _build_failed
    from shapley_vit_tpu_torch.ops import _build

    if _build_failed and not force:
        return False
    try:
        _build.build_host("svt_runtime")
    except Exception as e:
        from shapley_vit_tpu_torch.utils.logging import get_logger

        get_logger().info(f"native watcher unavailable, polling instead: {e}")
        _build_failed = True
        return False
    _build_failed = False
    return True


def load_native(auto_build: bool = True):
    """Load (building if needed) the native library; None if unavailable.

    A failed build is CACHED for the process: native_available() is called
    once per serve round (ingestion.wait_for_checkpoints), and on a host
    without a toolchain re-spawning a doomed ``g++`` subprocess every
    round would tax the loop for the life of the service. ``build_native
    (force=True)`` retries explicitly."""
    global _lib, _LIB_PATH
    if _lib is not None:
        return _lib
    from shapley_vit_tpu_torch.ops import _build

    path = _build.host_library_path("svt_runtime")
    if not path.exists():
        if not auto_build or not build_native():
            return None
    lib = ctypes.CDLL(str(path))
    lib.svt_wait_for_files.restype = ctypes.c_int
    lib.svt_wait_for_files.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.svt_wait_for_file_groups.restype = ctypes.c_int
    lib.svt_wait_for_file_groups.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.svt_preload_files.restype = ctypes.c_int
    lib.svt_preload_files.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
    ]
    lib.svt_file_size.restype = ctypes.c_int64
    lib.svt_file_size.argtypes = [ctypes.c_char_p]
    lib.svt_version.restype = ctypes.c_char_p
    _lib = lib
    _LIB_PATH = str(path)
    return _lib


def native_available() -> bool:
    return load_native() is not None


def wait_for_files(
    paths: Sequence[str], timeout: Optional[float] = None
) -> Tuple[List[bool], int]:
    """inotify-blocking wait until every path exists.

    Returns (arrived flags, count present). ``timeout=None`` waits forever
    (the reference's behavior contract, start.py:212-219).
    Raises RuntimeError if the native library is unavailable.
    """
    lib = load_native()
    if lib is None:
        raise RuntimeError("the native runtime could not be built (no g++)")
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    arrived = (ctypes.c_int * n)()
    timeout_ms = -1 if timeout is None else int(timeout * 1000)
    count = lib.svt_wait_for_files(c_paths, n, timeout_ms, arrived)
    if count < 0:
        raise OSError("svt_wait_for_files failed")
    return [bool(a) for a in arrived], count


def wait_for_file_groups(
    groups: Sequence[Sequence[str]], timeout: Optional[float] = None
) -> Tuple[List[Optional[str]], int]:
    """inotify-blocking wait until every GROUP has at least one of its
    candidate paths present (mixed ``.pth.tar``/``.npz`` client fleets —
    ingestion.checkpoint_path_candidates).

    Returns (per-group resolved path or None, count of satisfied groups).
    Within a group the FIRST listed candidate wins when several exist.
    Raises RuntimeError if the native library is unavailable.
    """
    lib = load_native()
    if lib is None:
        raise RuntimeError("the native runtime could not be built (no g++)")
    flat: List[str] = []
    gids: List[int] = []
    for g, cands in enumerate(groups):
        for p in cands:
            flat.append(p)
            gids.append(g)
    n = len(flat)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in flat])
    c_gids = (ctypes.c_int * n)(*gids)
    arrived = (ctypes.c_int * n)()
    timeout_ms = -1 if timeout is None else int(timeout * 1000)
    done = lib.svt_wait_for_file_groups(
        c_paths, c_gids, n, len(groups), timeout_ms, arrived
    )
    if done < 0:
        raise OSError("svt_wait_for_file_groups failed")
    found: List[Optional[str]] = [None] * len(groups)
    for i in range(n):
        if arrived[i] and found[gids[i]] is None:
            found[gids[i]] = flat[i]
    return found, done


def preload_files(paths: Sequence[str], threads: int = 0) -> List[Optional[bytes]]:
    """Read many files concurrently via the native thread pool. Returns file
    contents (None for unreadable entries — including files whose size
    CHANGED between the sizing stat and the native open/fstat, and partial
    mid-read failures: the C side returns complete bytes or a per-file
    error, never truncated content the caller could mistake for a valid
    checkpoint)."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("the native runtime could not be built (no g++)")
    n = len(paths)
    sizes_in = [lib.svt_file_size(p.encode()) for p in paths]
    bufs = [
        (ctypes.c_uint8 * max(int(s), 1))() if s >= 0 else (ctypes.c_uint8 * 1)()
        for s in sizes_in
    ]
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_bufs = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[ctypes.cast(b, ctypes.POINTER(ctypes.c_uint8)) for b in bufs]
    )
    caps = (ctypes.c_int64 * n)(*[max(int(s), 0) for s in sizes_in])
    out_sizes = (ctypes.c_int64 * n)()
    lib.svt_preload_files(c_paths, n, c_bufs, caps, out_sizes, threads)
    results: List[Optional[bytes]] = []
    for i in range(n):
        if out_sizes[i] < 0:
            results.append(None)
        else:
            # string_at is one memcpy; slicing a ctypes array would build a
            # Python int per byte (measured 5x slower than serial reads)
            results.append(ctypes.string_at(bufs[i], int(out_sizes[i])))
    return results
