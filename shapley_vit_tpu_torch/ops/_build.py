"""Build and load the hand-written Hopper kernels.

Each source ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/lib<name>-<digest>.so csrc/<name>.cu

The build runs at the first CUDA call of a kernel (or all at once through
:func:`build`), never at import: a machine without ``nvcc`` imports this
package and runs the plain versions on the CPU. ``<digest>`` hashes the
source, every shared header (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
Libraries go to ``shapley_vit_tpu_torch/build/``, which git ignores.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
KERNELS = ("patch_embed", "attention", "mlp_block")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# storage dtype -> suffix of the C entry points
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of shapley_vit_tpu_torch cannot be built on this machine"
        )
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names: Iterable[str] = KERNELS, extra_flags: Sequence[str] = ()) -> float:
    """Compile every named kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns the seconds it took; raises with
    the compiler's output when a build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs: List[tuple] = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        if log.strip():
            print(f"nvcc {name}.cu:\n{log}", flush=True)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def load(name: str, functions: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if needed), with
    ``argtypes`` declared for each function in ``functions`` and an int
    return (the ``cudaError_t`` of the launch)."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in functions.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def refuse_grad(what: str, *tensors: torch.Tensor, instead: str = "") -> None:
    """Raise when autograd would need a gradient through a forward-only
    kernel. Its output has no ``grad_fn``, so the graph would be cut there
    and everything upstream would get no gradient; ``instead`` names the
    differentiable path, where there is one. Checked on both devices, so the
    CPU and the card refuse the same calls."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is forward only and has no gradient, but an input requires grad"
            + (f"; train through {instead}" if instead else "")
        )


def check_tensors(what: str, *tensors: torch.Tensor, contiguous: bool = True) -> None:
    """The kernels take float32 or bfloat16 tensors of one dtype on one CUDA
    device, contiguous unless ``contiguous=False`` (the caller passes the
    strides)."""
    first = tensors[0]
    if first.dtype not in SUFFIX:
        raise TypeError(f"{what}: dtype {first.dtype} not supported (float32, bfloat16)")
    for t in tensors:
        if not t.is_cuda or t.device != first.device:
            raise ValueError(f"{what}: all tensors must be on {first.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{what}: mixed dtypes {t.dtype} and {first.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
