"""Checkpoint / resume subsystem.

The port of ``shapley_vit_tpu/fl/checkpoint.py``:

  * ``save_pytree``/``load_pytree``: atomic save and restore of a tree of
    tensors (one ``torch.save`` file written to a temporary name and renamed;
    the JAX package uses an orbax directory, so the two formats differ);
  * the resumable utility table (the reference's utility memo,
    game2.py:32-34, is RAM-only): a Shapley round's memo persists as an npz
    plus an append-only block log, stamped with a fingerprint of the round's
    inputs, so a killed round restarts without re-evaluating finished
    coalitions. The file format is the JAX package's, so either package
    reads the other's tables;
  * the round fingerprints (``fingerprint_inputs``, ``overlay_digest``,
    ``fingerprint_files``), which give the JAX package's strings for the
    same values, so a table's stamp means the same thing in both packages.
"""

from __future__ import annotations

import os
from typing import Dict, FrozenSet, List, Optional

import numpy as np
import torch

from shapley_vit_tpu_torch.ops.tree_math import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# tree checkpoints
# ---------------------------------------------------------------------------


def save_pytree(path: str, tree) -> None:
    """Atomic save of a tree of tensors (dicts, lists, tuples; overwrites an
    existing checkpoint): written to ``path + '.tmp'``, then renamed."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(tree_map(lambda x: x.detach().cpu() if isinstance(x, torch.Tensor)
                        else torch.as_tensor(np.asarray(x)), tree), tmp)
    os.replace(tmp, path)


def load_pytree(path: str, like=None):
    """Restore a tree saved by :func:`save_pytree` (tensors and plain
    containers only: ``torch.load(weights_only=True)``); ``like`` gives
    each leaf's target dtype and device."""
    tree = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if like is not None:
        tree = tree_map(lambda x, t: x.to(device=t.device, dtype=t.dtype), tree, like)
    return tree


# ---------------------------------------------------------------------------
# resumable utility table
# ---------------------------------------------------------------------------

_FINGERPRINT_KEY = "__fingerprint__"


def _key_to_str(key: FrozenSet[int]) -> str:
    return ",".join(map(str, sorted(key)))


def _str_to_key(s: str) -> FrozenSet[int]:
    return frozenset(int(t) for t in s.split(",") if t != "")


def fingerprint_inputs(*trees, extra=None) -> str:
    """Deterministic digest of a round's inputs (client deltas, weights,
    previous-utility baseline, ...). A persisted utility table is only valid
    for the exact inputs it was computed from — resuming against changed
    deltas or FedAvg weights would silently mix stale and fresh utilities.
    Leaves (tensors or arrays) are visited in ``jax.tree.leaves`` order and
    hashed exactly as the JAX package hashes them, so the same inputs give
    the same digest in both packages."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for tree in trees:
        for leaf in tree_leaves(tree):
            a = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
                 else np.asarray(leaf))
            h.update(str(a.shape).encode())
            h.update(str(a.dtype).encode())
            b = a.tobytes()
            if len(b) > 8192:
                # big leaves (stacked client deltas): strided byte sample
                # across the WHOLE buffer + per-leading-index f64 sums, so
                # permuted client rows change the digest
                step = max(1, len(b) // 8192)
                h.update(b[::step])
                flat = a.reshape(a.shape[0], -1) if a.ndim > 1 else a.reshape(1, -1)
                h.update(np.sum(flat, axis=1, dtype=np.float64).tobytes())
            else:
                h.update(b)
    if extra is not None:
        h.update(repr(extra).encode())
    return h.hexdigest()


def _dtype_name(leaf) -> str:
    """The leaf's dtype as numpy and the JAX package print it."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(leaf.dtype)


def _strided_samples_impl(leaves, sample_bytes: int):
    """A strided sample of about ``sample_bytes`` of each leaf, flattened."""
    out = []
    for leaf in leaves:
        flat = leaf.reshape(-1)
        itemsize = leaf.element_size() if isinstance(leaf, torch.Tensor) else leaf.dtype.itemsize
        n_elem = max(1, sample_bytes // max(1, itemsize))
        step = max(1, flat.shape[0] // n_elem)
        out.append(flat[::step])
    return tuple(out)


def _host_sample(a):
    """A sample as (its bytes, its float64 values) on the host."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:  # numpy has no bfloat16: same bytes
            return a.view(torch.int16).numpy().tobytes(), a.double().numpy()
        a = a.numpy()
    a = np.asarray(a)
    return a.tobytes(), a.astype(np.float64)


def overlay_digest(overlay, max_leaves: int = 4, sample_bytes: int = 2048) -> str:
    """Cheap, restart-stable identifier of a global overlay tree: a strided
    byte sample and float64 sum of a few leaves spread across the tree (a
    few KB from the device). Round fingerprints need the deltas' dependence
    on the current global overlay, which ``previous_utility`` alone covers
    only coarsely. The sums run on the host, so numpy and device overlays of
    the same values digest identically, and as the JAX package digests
    them."""
    import hashlib

    leaves = tree_leaves(overlay)
    if not leaves:
        return "empty"
    if len(leaves) > max_leaves:
        # deterministic spread across the traversal order
        idx = np.linspace(0, len(leaves) - 1, max_leaves).astype(int)
        leaves = [leaves[i] for i in idx]
    samples = _strided_samples_impl(leaves, sample_bytes)
    h = hashlib.blake2b(digest_size=16)
    for leaf, a in zip(leaves, samples):
        raw, values = _host_sample(a)
        h.update(str(tuple(leaf.shape)).encode())
        h.update(_dtype_name(leaf).encode())
        h.update(raw)
        h.update(values.sum().tobytes())
    return h.hexdigest()


def fingerprint_files(paths, extra=None) -> str:
    """Digest of a round's inputs from the client checkpoint files
    themselves (no device traffic; the service uses it instead of
    :func:`fingerprint_inputs` over the stacked deltas). Covers each
    client's file bytes keyed by position (a re-uploaded or permuted
    checkpoint changes the digest), absent stragglers, and through ``extra``
    the FedAvg weights, selection vector, overlay digest and the
    ``previous_utility`` baseline."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for i, p in enumerate(paths):
        h.update(f"[{i}]".encode())
        if p is None or not os.path.exists(p):
            h.update(b"<absent>")
            continue
        with open(p, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
    if extra is not None:
        h.update(repr(extra).encode())
    return h.hexdigest()


def save_utility_table(
    path: str,
    utility: Dict[FrozenSet[int], List[float]],
    fingerprint: Optional[str] = None,
) -> None:
    """Persist a Game's memo table with the atomic-rename protocol,
    optionally stamped with the round-input fingerprint."""
    from shapley_vit_tpu_torch.fl.ingestion import atomic_save_npz

    if not utility:
        return
    arrays = {_key_to_str(k): np.asarray(v) for k, v in utility.items()}
    if fingerprint is not None:
        arrays[_FINGERPRINT_KEY] = np.asarray(fingerprint)
    atomic_save_npz(path, arrays)


# Append-only block log riding beside the table: save_utility_table
# rewrites the WHOLE accumulated table, which made per-block persistence
# O(blocks × table) — profiled at n=64/m=3200 it was 89% of the host wall
# (518 block saves re-serializing up to 6k entries each: 1.6M npy writes).
# checkpointed_game instead APPENDS each block's new entries as one framed
# record (magic | length | crc32 | npz-bytes) and consolidates into the
# npz only when the log has grown to the table's size — amortized O(1)
# per entry, same at-most-one-block crash-loss contract. A torn tail
# record (crash mid-append) fails the length/CRC check and reads as
# absent, like every other corrupt-file path here.
_LOG_SUFFIX = ".log"
_LOG_MAGIC = b"SVTL"


def append_utility_log(
    path: str,
    entries: Dict[FrozenSet[int], List[float]],
    fingerprint: Optional[str] = None,
) -> None:
    """Append one block's entries to ``path + '.log'`` (O(block), not
    O(table)). Each record carries its own fingerprint stamp so replay can
    reject records from different round inputs."""
    if not entries:
        return
    import io
    import zlib

    buf = io.BytesIO()
    arrays = {_key_to_str(k): np.asarray(v) for k, v in entries.items()}
    if fingerprint is not None:
        arrays[_FINGERPRINT_KEY] = np.asarray(fingerprint)
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    rec = (
        _LOG_MAGIC
        + len(payload).to_bytes(8, "little")
        + zlib.crc32(payload).to_bytes(4, "little")
        + payload
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + _LOG_SUFFIX, "ab") as f:
        f.write(rec)


def _read_utility_log(path: str):
    """Replay ``path + '.log'`` -> list of (entries, fingerprint) records,
    stopping silently at the first torn/corrupt record (crash tail)."""
    import io
    import zlib

    log = path + _LOG_SUFFIX
    if not os.path.exists(log):
        return []
    records = []
    try:
        with open(log, "rb") as f:
            data = f.read()
    except OSError:
        return []
    pos = 0
    while pos + 16 <= len(data):
        if data[pos : pos + 4] != _LOG_MAGIC:
            break
        length = int.from_bytes(data[pos + 4 : pos + 12], "little")
        crc = int.from_bytes(data[pos + 12 : pos + 16], "little")
        payload = data[pos + 16 : pos + 16 + length]
        if len(payload) < length or zlib.crc32(payload) != crc:
            break  # torn tail — everything before it is intact
        try:
            entries: Dict[FrozenSet[int], List[float]] = {}
            fp = None
            with np.load(io.BytesIO(payload)) as z:
                for name in z.files:
                    if name == _FINGERPRINT_KEY:
                        fp = str(z[name])
                    else:
                        entries[_str_to_key(name)] = [float(v) for v in z[name]]
            records.append((entries, fp))
        except Exception:
            break
        pos += 16 + length
    return records


def clear_utility_log(path: str) -> None:
    try:
        os.remove(path + _LOG_SUFFIX)
    except OSError:
        pass


def utility_table_exists(path: str) -> bool:
    """True when durable table state exists — the consolidated npz OR the
    append log (a mid-round crash may leave only the latter)."""
    return os.path.exists(path) or os.path.exists(path + _LOG_SUFFIX)


def load_utility_table(path: str, fingerprint: Optional[str] = None):
    """Load a persisted table -> (dict, stored_fingerprint_or_None);
    (empty dict, None) if the file doesn't exist OR doesn't parse. A
    corrupt table (transient shared-disk fault — the same in-scope failure
    client checkpoints get ``on_error='skip'`` for) must read as "no
    table" and cost one re-evaluation, not kill a restarted service at
    ingest time.

    Entries from the append log (``path + '.log'``, written by
    ``checkpointed_game`` between consolidations) are merged in. With
    ``fingerprint`` given, content stamped with a DIFFERENT digest is
    dropped piecewise (unstamped content is accepted, matching
    ``resume_game``'s lenient contract); without it, log records must
    match the npz's own stamp to merge."""
    out: Dict[FrozenSet[int], List[float]] = {}
    fp = None
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                for name in z.files:
                    if name == _FINGERPRINT_KEY:
                        fp = str(z[name])
                        continue
                    out[_str_to_key(name)] = [float(v) for v in z[name]]
        except Exception as e:  # BadZipFile / ValueError / OSError / key parse
            from shapley_vit_tpu_torch.utils.logging import get_logger

            get_logger().warning(
                f"utility table {path} is unreadable ({e!r}); "
                "treating as absent — coalitions will re-evaluate"
            )
            out, fp = {}, None
    if fingerprint is not None and fp is not None and fp != fingerprint:
        out, fp = {}, None  # stale consolidated table: reject wholesale
    accept_fp = fingerprint if fingerprint is not None else fp
    for entries, rfp in _read_utility_log(path):
        if rfp is not None and accept_fp is not None and rfp != accept_fp:
            continue  # record from different round inputs
        if rfp is not None and accept_fp is None and fingerprint is None:
            # unstamped npz (or none) + stamped records: adopt the stamp
            accept_fp = rfp
        out.update(entries)
        if fp is None:
            fp = rfp
    return out, fp


def resume_game(game, path: str, fingerprint: Optional[str] = None) -> int:
    """Seed a Game's memo from a persisted table; returns #coalitions
    restored. Restored utilities are already previous-utility deltas, so
    they're injected directly into the memo (no re-evaluation).

    With ``fingerprint``, a table STAMPED with a different round-input digest
    is rejected (returns 0): it was computed from different deltas/weights/
    baseline and silently mixing it with fresh evaluations would corrupt the
    round's Shapley values. Unstamped tables (hand-staged, or written by
    older code) are accepted as-is."""
    table, stored = load_utility_table(path, fingerprint=fingerprint)
    if fingerprint is not None and stored is not None and stored != fingerprint:
        return 0  # unreachable via the filtered load; kept as a guard
    restored = 0
    for key, vals in table.items():
        if key not in game.utility:
            game.utility[key] = list(vals)
            restored += 1
    # count what was actually INJECTED, not len(table): entries the game
    # already memoized are skipped, and the drivers log this number
    return restored


def checkpointed_game(
    game,
    path: str,
    every: int = 1,
    fingerprint: Optional[str] = None,
    block: int = 8,
    save: bool = True,
):
    """Wrap a Game so its memo persists incrementally — mid-round crash
    recovery for long Monte-Carlo estimations.

    The estimators submit a whole round's coalitions in ONE ``precompute``
    call (that's the batched-TPU design), so saving only after it returns
    would persist nothing if the service dies mid-round — i.e. during the
    part that takes all the wall-clock. The wrapper therefore splits the
    not-yet-cached work into ``block``-sized batches, saving after each:
    a kill loses at most ``block`` coalition evals. Use ``block`` equal to
    the evaluator's coalition chunk so batch shapes match what the
    evaluator would compile anyway.

    ``save=False`` keeps the block-wise precompute SPLITTING but skips the
    table writes: in a multi-process service every rank must issue the
    SAME evaluator-call sequence (the batch psum is a collective — a rank
    that split differently would deadlock the mesh), while only rank 0 may
    write the shared table file.

    Persistence is APPEND-MOSTLY: each saved block appends one O(block)
    record to ``path + '.log'`` (see ``append_utility_log`` — the previous
    full-table rewrite per block was O(blocks × table), 89% of the n=64
    host wall); the consolidated npz is rewritten only when the log has
    accumulated as many entries as the table holds (amortized O(1) per
    entry). ``load_utility_table``/``resume_game`` replay the log, so the
    at-most-one-block crash-loss contract is unchanged."""
    orig_precompute = game.precompute
    counter = {"n": 0}
    state = {"first_save": True, "log_entries": 0}

    def _consolidate():
        save_utility_table(path, game.utility, fingerprint=fingerprint)
        clear_utility_log(path)
        state["log_entries"] = 0

    def _save_pending(pending_entries):
        if state["first_save"]:
            # a pre-existing log (prior crash, or a previous wrapper on the
            # same path) may hold entries the npz lacks — or stale ones
            # from different inputs. Fold everything resume_game accepted
            # (game.utility) into one fresh consolidated npz and start a
            # clean log; deleting the old log BEFORE a consolidation would
            # break the crash contract.
            state["first_save"] = False
            if os.path.exists(path + _LOG_SUFFIX):
                _consolidate()
                pending_entries.clear()
                return
        # threshold check BEFORE appending: the entries are already in
        # game.utility, so when this block tips the scale the consolidated
        # npz captures it directly — appending first would write one
        # O(block) record only for _consolidate to delete it
        if state["log_entries"] + len(pending_entries) >= max(
            64, len(game.utility) // 2
        ):
            _consolidate()
            pending_entries.clear()
            return
        append_utility_log(path, pending_entries, fingerprint=fingerprint)
        state["log_entries"] += len(pending_entries)
        pending_entries.clear()

    def flush_table():
        """Consolidate into one self-contained npz (round end: completed
        epochs keep the historical single-file artifact contract; the log
        only rides in-flight rounds). O(table), once per round."""
        if save and game.utility and (
            state["log_entries"] or os.path.exists(path + _LOG_SUFFIX)
            or not os.path.exists(path)
        ):
            state["first_save"] = False
            _consolidate()

    game.flush_table = flush_table

    def precompute(coalitions):
        todo = game.pending(coalitions)
        saved_at = counter["n"]
        pending_entries: Dict[FrozenSet[int], List[float]] = {}
        for i in range(0, len(todo), max(1, block)):
            chunk_keys = [frozenset(c) for c in todo[i : i + max(1, block)]]
            orig_precompute(todo[i : i + max(1, block)])
            counter["n"] += 1
            if save:
                for k in chunk_keys:
                    if k in game.utility:
                        pending_entries[k] = game.utility[k]
                if counter["n"] % every == 0:
                    _save_pending(pending_entries)
                    saved_at = counter["n"]
        # flush the tail: with every > 1 the modulo alone can leave up to
        # (every-1) final blocks unpersisted AFTER the call completes,
        # breaking the "a kill loses at most block evals" contract
        if save and counter["n"] != saved_at:
            _save_pending(pending_entries)

    game.precompute = precompute
    return game
