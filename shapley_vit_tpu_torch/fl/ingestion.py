"""Client checkpoint ingestion: the FL "network" is a shared filesystem.

The port of ``shapley_vit_tpu/fl/ingestion.py`` (reference start.py:134-222):

* writers use ATOMIC RENAME — write ``<file>.tmp`` then ``os.replace`` — so
  a file that exists is complete;
* :func:`wait_for_checkpoints` takes a ``timeout``, a straggler ``policy``
  (``"wait"``, ``"skip"``, ``"fail"``) and a ``should_stop`` callback (the
  service's drain), and blocks on the native inotify watcher
  (``fl/native.py``) or, where that cannot be built, polls the filesystem;
* checkpoints load as torch ``.pth.tar`` (reference clients,
  ``ckpt['state_dict']`` with peft naming) or native ``.npz`` (peft-style
  keys, the svt-client format), both converted to LoRA trees via
  ``models.convert``. ``.pth.tar`` goes through
  ``torch.load(weights_only=True)``, which unpickles tensors and plain
  containers only. Legacy non-zip torch files are refused unless
  ``SVT_TORCH_LEGACY_CKPT=1``, as on the JAX side.

Deltas are computed and kept on the host (numpy); the driver stacks them and
uploads the stacked tree once.
"""

from __future__ import annotations

import os
import time
import zipfile
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from shapley_vit_tpu_torch.models import convert
from shapley_vit_tpu_torch.models.vit import ViTSpec
from shapley_vit_tpu_torch.ops.tree_math import tree_map

Tree = Any


class NativeFormatError(ValueError):
    """A ``.pth.tar`` that is not a torch zip archive (legacy pre-1.6
    serialization), refused on the ingest path."""


# ---------------------------------------------------------------------------
# writing (the client side / test fixture side)
# ---------------------------------------------------------------------------

def atomic_save_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write-then-rename so readers never observe a partial file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


# Metadata keys ride inside the checkpoint so the ingestion contract can
# carry per-client FedAvg weights (reference ``num_local_data_train``,
# client2.py:7-42). npz: prefixed flat keys; pth.tar: top-level dict keys
# beside 'state_dict'.
_META_PREFIX = "__meta__."
_META_KEYS = ("num_local_data_train",)


def save_lora_checkpoint(
    path: str,
    lora_tree: Tree,
    spec: ViTSpec,
    num_local_data_train: Optional[int] = None,
) -> None:
    """Save a LoRA overlay (numpy or tensor leaves) in peft naming: ``.npz``
    natively, anything else as a torch zip checkpoint ``{'state_dict': ...}``,
    both atomically. ``num_local_data_train`` is stored as metadata and
    recovered by :func:`ingest_clients`."""
    sd = convert.tree_to_peft_lora(lora_tree, spec)
    meta: Dict[str, Any] = {}
    if num_local_data_train is not None:
        meta["num_local_data_train"] = int(num_local_data_train)
    if path.endswith(".npz"):
        arrays = dict(sd)
        for k, v in meta.items():
            arrays[_META_PREFIX + k] = np.asarray(v)
        atomic_save_npz(path, arrays)
        return
    ckpt: Dict[str, Any] = {"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}
    ckpt.update(meta)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def _load_raw(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """One file read -> (numpy state dict, metadata dict); the format is
    dispatched on the path suffix."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd, meta = {}, {}
            for k in z.files:
                if k.startswith(_META_PREFIX):
                    meta[k[len(_META_PREFIX):]] = z[k].item()
                else:
                    sd[k] = z[k]
            return sd, meta
    if not zipfile.is_zipfile(path) and os.environ.get("SVT_TORCH_LEGACY_CKPT", "") != "1":
        raise NativeFormatError(
            f"{path}: not a torch-zip checkpoint; legacy pre-1.6 torch files are "
            "refused on the ingest path unless SVT_TORCH_LEGACY_CKPT=1 is set"
        )
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    meta: Dict[str, Any] = {}
    if isinstance(ckpt, dict):
        meta = {k: ckpt[k] for k in _META_KEYS if k in ckpt}
        for key in ("state_dict", "model_state_dict"):
            if key in ckpt:
                ckpt = ckpt[key]
                break
    meta = {k: v.item() if hasattr(v, "item") else v for k, v in meta.items()}
    return convert.torch_state_dict_to_numpy(ckpt), meta


def load_checkpoint_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A client checkpoint as a numpy state dict."""
    return _load_raw(path)[0]


def load_checkpoint_metadata(path: str) -> Dict[str, Any]:
    """Metadata dict (e.g. ``num_local_data_train``) from a checkpoint."""
    return _load_raw(path)[1]


def load_client_lora(path: str, spec: ViTSpec) -> Tree:
    """Checkpoint -> LoRA overlay tree (lora A/B + classifier), numpy."""
    return convert.peft_lora_to_tree(load_checkpoint_state_dict(path), spec)


def client_delta(client_lora: Tree, init_lora: Tree) -> Tree:
    """Weight delta vs. the initial global overlay (reference
    ``get_difference_between_network_weights``, utils.py:735-749), computed
    on the host in numpy: IEEE float32 subtraction, bit-identical to the JAX
    package's. Pass a host ``init_lora`` (``convert.tree_to_numpy`` once)."""
    return tree_map(
        lambda a, b: np.subtract(np.asarray(a), np.asarray(b)), client_lora, init_lora
    )


# ---------------------------------------------------------------------------
# watching
# ---------------------------------------------------------------------------

@dataclass
class WatchResult:
    paths: List[Optional[str]]          # per-client checkpoint path or None
    arrived: List[bool]                 # the client selection vector
    waited_seconds: float


def default_checkpoint_paths(
    root: str, num_clients: int, filename: str = "ViT_epoch_9.pth.tar"
) -> List[str]:
    """The reference's layout: ``<root>/client_{i}_model/<filename>`` with
    1-based client directories (start.py:134-136)."""
    return [
        os.path.join(root, f"client_{i + 1}_model", filename)
        for i in range(num_clients)
    ]


def checkpoint_path_candidates(
    root: str, num_clients: int, filename: str = "ViT_epoch_9.pth.tar"
) -> List[List[str]]:
    """Per-client CANDIDATE checkpoint paths ``<root>/client_{i+1}_model/``:
    the configured filename plus its sibling in the other supported format
    (``.pth.tar`` <-> ``.npz``); the first candidate that appears wins."""
    alts = [filename]
    if filename.endswith(".pth.tar"):
        alts.append(filename[: -len(".pth.tar")] + ".npz")
    elif filename.endswith(".npz"):
        alts.append(filename[: -len(".npz")] + ".pth.tar")
    return [
        [os.path.join(root, f"client_{i + 1}_model", a) for a in alts]
        for i in range(num_clients)
    ]


def resolve_data_sizes(
    sizes: Sequence[Optional[int]],
    selection: Sequence[bool],
    log_fn: Optional[Callable[[str], None]] = None,
) -> List[float]:
    """Per-client metadata sizes -> FedAvg weights: used only when EVERY
    arrived client carries ``num_local_data_train``; on partial metadata the
    whole round falls back to equal weights, with a log line."""
    arrived = [s for s, sel in zip(sizes, selection) if sel]
    if arrived and all(s is not None and s > 0 for s in arrived):
        return [float(s) if s else 1.0 for s in sizes]
    if any(s for s in arrived) and log_fn is not None:
        log_fn(
            "partial num_local_data_train metadata across clients: "
            "falling back to equal FedAvg weights for this round"
        )
    return [1.0] * len(sizes)


def wait_for_checkpoints(
    paths: Sequence,
    timeout: Optional[float] = None,
    poll_interval: float = 1.0,
    policy: str = "wait",
    log_fn: Optional[Callable[[str], None]] = None,
    _sleep=time.sleep,
    use_native: bool = True,
    should_stop: Optional[Callable[[], bool]] = None,
) -> WatchResult:
    """Wait until every client's checkpoint exists (atomic-rename protocol:
    existence == completeness). ``policy`` on timeout: 'wait' ignores the
    timeout (the reference blocks forever), 'skip' returns with the subset
    that arrived, 'fail' raises TimeoutError.

    ``should_stop`` (when given) is polled about once per ``poll_interval``;
    when it turns true the wait returns EARLY with whatever arrived, never
    raising, even under ``policy='fail'`` (the caller asked to stop and
    tells a drain from a straggler itself): how a draining service escapes
    an otherwise indefinite idle wait.

    Each entry of ``paths`` is one path or a sequence of candidate paths for
    that client (:func:`checkpoint_path_candidates`); the returned
    ``WatchResult.paths`` hold the concrete path that arrived (first listed
    candidate wins).

    Backend: the native inotify watcher (``fl/native.py``) when it can be
    built (event-driven, grouped candidates through
    ``svt_wait_for_file_groups``), else polling."""
    if policy not in ("wait", "skip", "fail"):
        raise ValueError(f"unknown straggler policy {policy!r}")
    start = time.time()
    groups = [[p] if isinstance(p, str) else list(p) for p in paths]

    if use_native:
        try:
            from shapley_vit_tpu_torch.fl import native

            if native.native_available():
                eff_timeout = None if policy == "wait" else timeout
                stopped = False
                if should_stop is None:
                    # one event-driven block for the whole wait
                    found, count = native.wait_for_file_groups(groups, timeout=eff_timeout)
                else:
                    # slice the block so should_stop is polled about once
                    # per poll_interval; arrivals still return at once
                    # (inotify), only the stop latency is the slice width
                    deadline = None if eff_timeout is None else start + eff_timeout
                    # `stopped` latches the observation: a should_stop that
                    # flips back (a DRAIN file deleted between polls) must
                    # not fall through to the policy='fail' raise
                    while True:
                        if should_stop():
                            found = [next((p for p in g if os.path.exists(p)), None)
                                     for g in groups]
                            return WatchResult(found, [f is not None for f in found],
                                               time.time() - start)
                        sl = poll_interval
                        if deadline is not None:
                            sl = min(sl, max(0.0, deadline - time.time()))
                        found, count = native.wait_for_file_groups(groups, timeout=sl)
                        if count == len(groups):
                            break
                        if should_stop():
                            stopped = True
                            break
                        if deadline is not None and time.time() >= deadline:
                            break
                elapsed = time.time() - start
                arrived = [f is not None for f in found]
                if count == len(groups):
                    return WatchResult(found, arrived, elapsed)
                if should_stop is not None and stopped:
                    return WatchResult(found, arrived, elapsed)
                if policy == "fail":
                    missing = [g[0] for g, a in zip(groups, arrived) if not a]
                    raise TimeoutError(f"clients never delivered: {missing}")
                return WatchResult(found, arrived, elapsed)
        except (OSError, RuntimeError, AttributeError):
            pass  # fall through to polling
    while True:
        found = [next((p for p in g if os.path.exists(p)), None) for g in groups]
        arrived = [f is not None for f in found]
        if all(arrived):
            return WatchResult(found, arrived, time.time() - start)
        if should_stop is not None and should_stop():
            return WatchResult(found, arrived, time.time() - start)
        elapsed = time.time() - start
        if timeout is not None and elapsed >= timeout and policy != "wait":
            if policy == "fail":
                missing = [g[0] for g, a in zip(groups, arrived) if not a]
                raise TimeoutError(f"clients never delivered: {missing}")
            return WatchResult(found, arrived, elapsed)
        if log_fn is not None:
            missing = sum(1 for a in arrived if not a)
            log_fn(f"waiting for {missing} client checkpoint(s)...")
        _sleep(poll_interval)


def ingest_clients(
    paths: Sequence[Optional[str]],
    init_lora: Tree,
    spec: ViTSpec,
    on_error: str = "raise",
    log_fn: Optional[Callable[[str], None]] = None,
) -> Tuple[List[Optional[Tree]], List[bool], List[Optional[int]]]:
    """Load every arrived client checkpoint -> (deltas, selection, sizes):
    host numpy deltas against ``init_lora``, the selection vector, and each
    client's ``num_local_data_train`` (None if absent or not arrived).
    ``on_error``: 'raise' propagates unreadable checkpoints; 'skip' treats
    the client as not arrived and logs it."""
    if on_error not in ("raise", "skip"):
        raise ValueError(f"unknown on_error policy {on_error!r}")
    deltas: List[Optional[Tree]] = []
    selection: List[bool] = []
    sizes: List[Optional[int]] = []
    init_host = convert.tree_to_numpy(init_lora)  # one transfer per round
    for p in paths:
        if p is None:
            deltas.append(None)
            selection.append(False)
            sizes.append(None)
            continue
        try:
            sd, meta = _load_raw(p)
            lora = convert.peft_lora_to_tree(sd, spec)
        except Exception as e:
            if on_error == "raise":
                raise
            if log_fn is not None:
                log_fn(f"skipping unreadable client checkpoint {p}: {e}")
            deltas.append(None)
            selection.append(False)
            sizes.append(None)
            continue
        deltas.append(client_delta(lora, init_host))
        selection.append(True)
        n = meta.get("num_local_data_train")
        sizes.append(int(n) if n is not None else None)
    return deltas, selection, sizes
