"""Continuous Shapley service.

The port of ``shapley_vit_tpu/driver/serve.py`` on one card. What changed in
the port:

* the jitted tree helpers (row gather, overlay subtract, overlay advance)
  are plain tensor ops;
* the ingest prefetcher uploads the next epoch's stacked overlays from
  pinned host memory on its own CUDA stream; the round waits on that copy's
  event before it uses the tensors, never on the whole device (on the CPU
  it is a plain thread);
* prewarm is the kernels' nvcc build plus one full-powerset evaluation at
  zero deltas (the JAX compile cache has no counterpart: the builds are
  cached by digest, ``ops/_build.py``);
* one process: the cross-rank decisions raise ``NotImplementedError`` when
  ``torch.distributed`` runs more than one rank (the mesh-sharded service
  is not ported), and this process writes every artifact;
* the round chain persists beside the restart cursor: each completed
  round saves its global overlay (``service_overlay.pt``) and the cursor
  keeps that overlay's digest and the chained ``previous_utility``, so a
  recycled process (``start_epoch="auto"``) scores its rounds as the
  uninterrupted service would. The JAX service restarts the chain from the
  initial model after a recycle, which shifts every later round's Shapley
  values by a per-client constant.

The reference's driver runs ONE round against ``ViT_epoch_9.pth.tar`` and
exits (start.py:134-222); the enclosing FL system (out of repo) retrains and
redeposits checkpoints per epoch. This loop is that missing outer service:
watch LOCAL_MODEL_PATH for each epoch's full checkpoint set (atomic-rename
protocol, C++ inotify watcher when built), run a Shapley round, persist
SV/utility artifacts, advance. Stragglers follow the configured policy; the
previous round's grand-coalition utility seeds the next round's
``previous_utility`` (the reference's round-chaining contract,
game2.py:113-114).
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from shapley_vit_tpu_torch.config import Config
from shapley_vit_tpu_torch.driver import report as report_mod
from shapley_vit_tpu_torch.driver import start as start_mod
from shapley_vit_tpu_torch.driver.report import render_round_report
from shapley_vit_tpu_torch.fl import checkpoint as ckpt
from shapley_vit_tpu_torch.fl import ingestion
from shapley_vit_tpu_torch.models import convert
from shapley_vit_tpu_torch.ops import tree_math as tm
from shapley_vit_tpu_torch.shapley import Game, run_configured_comp_contrib
from shapley_vit_tpu_torch.utils.logging import TensorBoardWriter, get_logger
from shapley_vit_tpu_torch.utils.profiling import StepTimer, process_rss_mb, trace

# re-exported from the leaf protocol module (the supervisor imports from
# there to stay torch-free; library users import from here)
from shapley_vit_tpu_torch.driver.protocol import (  # noqa: F401
    DRAIN_FILENAME,
    RECYCLE_EXIT_CODE,
    STATE_FILENAME,
    read_service_state,
)

#: The global overlay after the last completed round, beside the cursor
#: (``service_state.json`` keeps its digest and that round's utility), so a
#: recycled or restarted service continues the round chain where it stopped.
OVERLAY_FILENAME = "service_overlay.pt"

_DRAIN = threading.Event()
_SIGNALS_INSTALLED = False


def request_drain() -> None:
    """Ask the in-process service to stop gracefully: finish the round in
    flight (or the idle wait), persist the cursor, and return with
    ``stop_reason="drain"``. Thread-safe; what the SIGTERM handler calls."""
    _DRAIN.set()


def _install_drain_handlers(drain_path: str, logger) -> List:
    """SIGTERM/SIGINT → graceful drain (k8s pod eviction / systemd stop /
    Ctrl-C). The FIRST signal requests the drain and writes the shared
    ``DRAIN`` file (multi-host transport + unblocks other ranks' idle
    waits); the handler then restores the default disposition so a SECOND
    signal force-kills a wedged process. Returns (signum, old_handler)
    pairs for the caller to restore; empty when not on the main thread
    (signal.signal is main-thread-only — in-process test harnesses and
    notebook threads just skip OS-signal wiring and use request_drain()).

    Installing CONSUMES any stale drain state (event + file) so a request
    left over from a previous run cannot instantly stop this one; a signal
    landing any time after this call is never lost (serve() skips its own
    stale-state clearing once handlers are installed in-process)."""
    global _SIGNALS_INSTALLED
    _DRAIN.clear()
    try:
        os.remove(drain_path)
    except OSError:
        pass
    restore = []

    def _handler(signum, frame):
        request_drain()
        try:
            with open(drain_path, "w") as f:
                f.write(f"signal {signum} pid {os.getpid()}\n")
        except OSError:
            pass  # the in-process event alone still drains this rank
        signal.signal(signum, signal.SIG_DFL)
        logger.info(
            f"signal {signum}: draining after the in-flight round "
            f"(repeat the signal to force-kill)"
        )

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            restore.append((sig, signal.signal(sig, _handler)))
            _SIGNALS_INSTALLED = True
        except ValueError:  # not the main thread
            break
    return restore


class RoundRecords(list):
    """``serve()``'s return value: a plain list of round records plus the
    reason the loop ended. Callers that treat it as a list are unaffected;
    the CLI and the supervisor read ``stop_reason`` to pick an exit code.
    ``prewarm_s`` is the bring-up's prewarm time (None without prewarm)."""

    stop_reason: str = "max_rounds"
    prewarm_s: Optional[float] = None


def _write_service_state(out_dir: str, state: Dict) -> None:
    """Atomically persist the service's restart cursor (same tmp+rename
    protocol as every other artifact — readers never see a partial file)."""
    path = os.path.join(out_dir, STATE_FILENAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)


def _world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _max_across_ranks(value: int) -> int:
    """Cross-rank max at a fixed point in the round sequence: stop decisions
    (drain/timeout/no-checkpoints/recycle) must be identical on every rank
    of a multi-process service. The port serves from one process; the
    multi-GPU service is not ported, so more than one rank raises."""
    if _world_size() > 1:
        raise NotImplementedError(
            "the multi-process service is not ported; run serve() in one process"
        )
    return int(value)


def _any_across_ranks(flag: bool) -> bool:
    return _max_across_ranks(1 if flag else 0) > 0


class _IngestPrefetcher:
    """Overlap the next epoch's checkpoint parse and upload with the current
    round's Shapley span.

    During round e a worker thread polls for epoch e+1's candidate files;
    once every client has dropped one it digests the files (the same
    digest-before-read contract as the serial path), parses them into raw
    LoRA trees (independent of the overlay: round e+1's baseline overlay
    does not exist until round e advances it), stacks them on the host and
    uploads the ``[n, ...]`` stack. On the card the upload is a copy from
    pinned host memory on the prefetcher's own CUDA stream, finished inside
    the overlap window; :meth:`take` makes the round's stream wait on that
    copy's event. At consume the loop re-digests the files: on a match the
    round's deltas are one on-device subtract (stacked loras − overlay,
    bit-identical to the serial path's host float32 subtract); on any
    mismatch (re-upload between prefetch and wait, partial arrival,
    another resolved format, parse error) the round takes the serial path.
    Shapley values are identical on both paths.
    """

    def __init__(self, spec, log_fn, device, poll_interval: float = 0.25):
        self._spec = spec
        self._log = log_fn
        self._device = torch.device(device)
        self._poll = poll_interval
        self._lock = threading.Lock()
        self._result: Optional[Dict] = None
        self._thread = None
        self._consume = threading.Event()  # stop POLLING (a taker arrived)
        self._stop = threading.Event()     # hard stop (serve is exiting)
        self._stream = (torch.cuda.Stream(self._device) if self._device.type == "cuda"
                        else None)

    def schedule(self, epoch: int, candidates) -> None:
        """Start prefetching one epoch (cancels any previous in-flight)."""
        self.cancel()
        self._consume = threading.Event()
        self._stop = threading.Event()
        with self._lock:
            self._result = None
        self._thread = threading.Thread(
            target=self._run,
            args=(epoch, candidates, self._consume, self._stop),
            daemon=True,
            name=f"svt-ingest-prefetch-{epoch}",
        )
        self._thread.start()

    def _upload(self, host_tree):
        """The stacked host tree on the device, and the event that marks the
        end of its copy (None on the CPU)."""
        if self._stream is None:
            return convert.tree_from_numpy(host_tree, self._device), None
        with torch.cuda.stream(self._stream):
            stacked = tm.tree_map(
                lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                .to(self._device, non_blocking=True),
                host_tree,
            )
            done = torch.cuda.Event()
            done.record(self._stream)
        # the pinned buffers must outlive the copy, and the copy should end
        # inside the overlap window: wait for this event (not the device)
        done.synchronize()
        return stacked, done

    def _run(self, epoch, candidates, consume, stop) -> None:
        # resolve each client to its first existing candidate (the same
        # first-candidate-wins rule as wait_for_checkpoints)
        while not (stop.is_set() or consume.is_set()):
            paths = [
                next((p for p in cands if os.path.exists(p)), None)
                for cands in candidates
            ]
            if all(p is not None for p in paths):
                break
            stop.wait(self._poll)
        else:
            return  # nothing arrived before the taker/stop — serial path
        try:
            digest = ckpt.fingerprint_files(paths)
            loras, sizes = [], []
            for p in paths:
                if stop.is_set():
                    return
                sd, meta = ingestion._load_raw(p)
                loras.append(convert.peft_lora_to_tree(sd, self._spec))
                n_local = meta.get("num_local_data_train")
                sizes.append(int(n_local) if n_local is not None else None)
            stacked, done = self._upload(tm.tree_stack_host(loras))
        except Exception as e:  # corrupt/foreign file, OOM, ... → serial path
            self._log(f"ingest prefetch for epoch {epoch} aborted: {e}")
            return
        with self._lock:
            self._result = dict(
                epoch=epoch, paths=list(paths), digest=digest,
                stacked=stacked, done=done, sizes=sizes,
            )

    def take(self, epoch: int, paths) -> Optional[Dict]:
        """Claim the prefetched epoch, or None (→ serial path). Joins the
        worker: if it is mid-parse the join costs what the serial parse
        would have — never more. The caller's stream waits on the upload."""
        if self._thread is not None:
            self._consume.set()
            self._thread.join()
            self._thread = None
        with self._lock:
            r, self._result = self._result, None
        if r is None or r["epoch"] != epoch or r["paths"] != list(paths):
            return None
        if r["done"] is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(r["done"])
            # the tensors were allocated on the prefetch stream: tell the
            # allocator the round's stream uses them too
            tm.tree_map(lambda t: t.record_stream(stream), r["stacked"])
        return r

    def cancel(self) -> None:
        if self._thread is not None:
            self._consume.set()
            self._stop.set()
            self._thread.join()
            self._thread = None
        with self._lock:
            self._result = None


def serve(
    cfg: Optional[Config] = None,
    max_rounds: Optional[int] = None,
    epoch_filename: str = "ViT_epoch_{epoch}.pth.tar",
    start_epoch: Union[int, str] = 0,
    timeout: Optional[float] = None,
    policy: str = "wait",
    valid=None,
    max_skipped_rounds: Optional[int] = 10,
    prewarm: bool = True,
    max_rss_mb: Optional[float] = None,
    pipeline_ingest: Optional[bool] = None,
    device=None,
) -> "RoundRecords":
    """Run Shapley rounds as checkpoint sets arrive; returns round records.

    ``max_rounds=None`` serves forever (the reference's blocking contract);
    tests pass a bound. ``policy``: wait | skip | fail per fl/ingestion.
    ``max_skipped_rounds`` bounds CONSECUTIVE all-corrupt rounds, but ONLY
    for ``max_rounds``-bounded calls (skipped rounds append no record, so a
    garbage-producing writer would otherwise spin a bounded call forever).
    The unbounded production service keeps skipping and recovers when good
    checkpoints resume — silently dying after N bad epochs would be worse
    than the spin. ``None`` disables the bound everywhere.

    ``prewarm`` builds the kernels and runs the full-powerset coalition
    evaluation once at bring-up (zero deltas, one validation batch), before
    blocking on the first epoch's checkpoints, so "checkpoint arrival → SV"
    runs at steady-state latency from the first round.

    ``max_rss_mb`` is the built-in recycle at an RSS ceiling: when the
    post-round RSS crosses it, the service finishes the round, flushes
    artifacts, persists its restart cursor (``service_state.json``), and
    returns with ``stop_reason="rss_ceiling"`` — the CLI maps that to exit
    code ``RECYCLE_EXIT_CODE`` so a supervisor (``svt-torch-supervise``)
    restarts a fresh process, which costs one prewarm and resumes mid-round
    work from the fingerprinted utility table. ``start_epoch="auto"``
    resumes from the persisted cursor (missing file → epoch 0).

    ``pipeline_ingest`` overlaps the next epoch's checkpoint parse and
    upload with the current round's Shapley span (see ``_IngestPrefetcher``).
    Default: on (``SVT_PIPELINE_INGEST=0`` disables). Every round records
    ``pipelined_ingest`` — whether the fast path actually fired.

    ``device``: the card unless ``"cpu"`` is passed.

    Graceful drain: ``request_drain()`` (what the CLI's SIGTERM/SIGINT
    handler calls) or touching ``<out_dir>/DRAIN`` stops the service at the
    next round boundary — an in-flight round finishes and persists; an idle
    checkpoint wait returns early (``should_stop``) without consuming the
    epoch — with ``stop_reason="drain"`` (CLI exit 0: supervisors do NOT
    restart).
    """
    cfg = cfg or Config.from_env()
    device = start_mod.resolve_device(device)
    if _world_size() > 1:
        _max_across_ranks(0)  # raises: one process serves
    logger = get_logger()
    out_dir = cfg.ensure_output_dir()
    n = cfg.shapley.num_clients

    # graceful drain (SIGTERM/SIGINT via the CLI, the DRAIN file, or
    # request_drain()): a fresh service consumes any stale request first —
    # unless the process entry already installed signal handlers (which
    # consumed stale state itself; clearing again here would swallow a
    # signal that landed during startup)
    drain_path = os.path.join(out_dir, DRAIN_FILENAME)
    if not _SIGNALS_INSTALLED:
        _DRAIN.clear()
        try:
            os.remove(drain_path)
            logger.info(f"cleared stale {DRAIN_FILENAME} file")
        except OSError:
            pass

    def drain_requested() -> bool:
        # this rank's local view; decisions are taken via _max_across_ranks.
        # A sighted DRAIN file is LATCHED into the event so a later delete
        # of the shared file (e.g. a restarting rank's handler install
        # consuming it as stale) cannot cancel a request already observed
        if not _DRAIN.is_set() and os.path.exists(drain_path):
            _DRAIN.set()
        return _DRAIN.is_set()

    # service lineage across recycles/restarts: generation counts serve()
    # incarnations on this cursor, total_rounds accumulates across them
    # (the per-run `rounds` field resets with each process)
    prior_state = read_service_state(out_dir)
    generation = int(prior_state.get("generation", 0)) + 1 if prior_state else 1
    prior_rounds = (
        int(prior_state.get("total_rounds", prior_state.get("rounds", 0)))
        if prior_state else 0
    )

    def _cursor(next_epoch: int, **extra) -> Dict:
        # the round chain rides the cursor: the utility the next round is
        # scored against, and the digest of the overlay file it starts from
        chain = dict(previous_utility=[float(u) for u in prev_utility])
        if overlay_fp is not None:
            chain["overlay_digest"] = overlay_fp
        return dict(
            next_epoch=next_epoch, last_epoch=next_epoch - 1,
            rounds=len(records), total_rounds=prior_rounds + len(records),
            generation=generation, **chain, **extra,
        )
    resume_chain = None
    if start_epoch == "auto":
        state = prior_state
        resume_chain = state
        start_epoch = int(state["next_epoch"]) if state else 0
        if state:
            logger.info(
                f"resuming service at epoch {start_epoch} "
                f"(cursor: {STATE_FILENAME})"
            )

    keep_tables = int(cfg.shapley.keep_utility_tables)
    # prune_floor: every table epoch < prune_floor has been deleted. The
    # in-loop pruner advances it to the current retention floor and deletes
    # the range in between — amortized O(1) per epoch CONSUMED (skipped
    # epochs advance the floor by more than one; a fixed single-file delete
    # would strand the tables the skip jumped over)
    prune_floor = (start_epoch if isinstance(start_epoch, int) else 0) - keep_tables

    def prune_tables(new_floor: int) -> None:
        nonlocal prune_floor
        for e in range(prune_floor, new_floor):
            base = os.path.join(out_dir, f"utility_table_epoch_{e}.npz")
            for p in (base, base + ".log"):  # append log rides beside it
                try:
                    os.remove(p)
                except OSError:
                    pass
        prune_floor = max(prune_floor, new_floor)

    if cfg.shapley.persist_utility_table and keep_tables > 0:
        # one startup sweep clears any backlog below the initial floor
        # (epoch jumps, retention newly enabled, long-dead services); the
        # half-finished current epoch's table is kept for resume, plus the
        # K completed epochs behind the cursor
        import glob as _glob
        import re as _re

        for p in _glob.glob(
            os.path.join(out_dir, "utility_table_epoch_*.npz*")
        ):
            m = _re.search(r"utility_table_epoch_(-?\d+)\.npz(\.log)?$", p)
            if m and int(m.group(1)) < prune_floor:
                try:
                    os.remove(p)
                except OSError:
                    pass

    spec, base, init_lora = start_mod.build_model(cfg, device=device)
    if valid is None:
        valid = start_mod.load_validation_dataset(cfg, target_size=spec.image, device=device)

    # eval_mode selection (merged LoRA folding by default)
    backend, eval_coalitions, chunk = start_mod.build_eval_backend(
        cfg, spec, base, init_lora, device=device, log_fn=logger.info
    )
    data = backend.device_batches(valid, cfg.data.eval_batch_size)

    build_s = 0.0
    if prewarm and device.type == "cuda":
        # the kernels' nvcc builds (cached by digest), before the first
        # evaluation launches them: part of the prewarm
        from shapley_vit_tpu_torch.ops import _build

        t0 = time.time()
        _build.build()
        build_s = time.time() - t0
    prev_utility = list(
        backend.evaluate_single(base, init_lora, data, dataset_size=len(valid))
    )
    logger.info(f"service up: initial utility {prev_utility}")

    # deltas arrive as host numpy trees (ingestion computes them on the
    # host); the advance gathers participating rows of the device-resident
    # stack, so it never re-uploads them
    def gather_rows(stacked, idx):
        index = torch.as_tensor(idx, device=device)
        return tm.tree_map(lambda x: x[index], stacked)

    # fast-path delta: prefetched raw client stacks minus the round's
    # baseline overlay, on the device (float32 subtract, bit-identical to
    # the serial path's host numpy subtract)
    def sub_overlay(stacked, overlay):
        return tm.tree_map(lambda a, b: a - b, stacked, overlay)

    def advance(overlay, stacked_sel, ratio):
        return tm.apply_deltas(overlay, tm.aggregate_deltas(stacked_sel, ratio))

    root = cfg.paths.local_model_path or os.path.join(os.getcwd(), "local_training")

    # pipelined ingest: prefetch the next epoch's checkpoints during the
    # current round's shapley span. Default ON; the arg or
    # SVT_PIPELINE_INGEST=0 opts out (every miss falls back to the serial
    # path, so the knob exists for measurement, not safety).
    if pipeline_ingest is None:
        pipeline_ingest = os.environ.get("SVT_PIPELINE_INGEST", "1") != "0"
    prefetcher = (
        _IngestPrefetcher(spec, logger.info, device) if pipeline_ingest else None
    )

    prewarm_s = None
    if prewarm:
        # run the round's shapes once now instead of inside the first round
        # (cuBLAS and allocator warm-up). The evaluator never sees more
        # than `chunk` coalitions at once, so C is clamped — prewarm cost is
        # bounded by chunk coalition-evals over <= 2 batches.
        t0 = time.time()
        C = min(2**n - 1, chunk) if chunk else 2**n - 1
        warm_counts = [C]
        # when the powerset splits into chunk-sized blocks, the round's
        # LAST block is smaller ((2^n-1) % chunk) and would otherwise first
        # run mid-round
        rem = (2**n - 1) % chunk if chunk and 2**n - 1 > chunk else 0
        if rem and rem != C:
            warm_counts.append(rem)
        zero_stack = tm.tree_stack([tm.tree_zeros_like(init_lora)] * n)
        # a remainder batch has its own shape — warm it too
        warm_batches = data[:1] + (data[-1:] if len(data) > 1
                                   and data[-1][1].shape != data[0][1].shape else [])
        warm_n = max(1, sum(int(b[1].shape[0]) for b in warm_batches))
        for c in warm_counts:
            W0 = np.full((c, n), 1.0 / n, dtype=np.float32)
            eval_coalitions(init_lora, zero_stack, W0, warm_batches,
                            dataset_size=warm_n)
        prewarm_s = build_s + time.time() - t0
        logger.info(
            f"prewarm: kernel build {build_s:.1f}s, C={warm_counts} eval shape(s) "
            f"over {len(warm_batches)} batch shape(s), {prewarm_s:.1f}s in all"
        )

    # TensorBoard backend for the reference's --use-tensorboard flag (dead
    # in the reference, opts.py:70-72): per-round SV/SE/utility/phase
    # scalars under <exp_dir>/<exp_id>/tensorboard
    tb = (
        TensorBoardWriter(os.path.join(out_dir, "tensorboard"))
        if cfg.obs.use_tensorboard
        else None
    )
    records = RoundRecords()
    records.prewarm_s = prewarm_s
    epoch = start_epoch
    skipped = 0
    traj_rendered = 0  # length of the SV history in the last sv_rounds.png
    current_overlay = init_lora
    overlay_path = os.path.join(out_dir, OVERLAY_FILENAME)
    overlay_fp = None  # digest of the overlay file, once a round wrote it
    if resume_chain and resume_chain.get("overlay_digest") and os.path.exists(overlay_path):
        # continue the round chain of the process this one replaces: its
        # global overlay and the utility the next round is scored against
        # (otherwise a recycle would restart the chain from the initial
        # model and shift every later round's Shapley values)
        restored = ckpt.load_pytree(overlay_path, like=init_lora)
        if ckpt.overlay_digest(restored) == resume_chain["overlay_digest"]:
            current_overlay, overlay_fp = restored, resume_chain["overlay_digest"]
            prev_utility = list(resume_chain["previous_utility"])
            logger.info(f"resumed the round chain: previous utility {prev_utility}")
        else:
            logger.info(f"{OVERLAY_FILENAME} does not match the cursor; the round "
                        "chain restarts from the initial overlay")
    while max_rounds is None or len(records) < max_rounds:
        # candidate paths per client: the configured filename plus its
        # sibling format (.pth.tar <-> .npz) so reference torch clients and
        # svt-client npz writers converge on the same server untouched
        paths = ingestion.checkpoint_path_candidates(
            root, n, filename=epoch_filename.format(epoch=epoch)
        )
        logger.info(f"round {len(records)}: waiting for epoch-{epoch} checkpoints")
        watch = None
        try:
            watch = ingestion.wait_for_checkpoints(
                paths, timeout=timeout, policy=policy, log_fn=logger.info,
                should_stop=drain_requested,
            )
        except TimeoutError as e:
            timeout_err = e
        # ONE collectively-aligned stop decision per wait (every rank
        # reaches this point every round — a wait ends by arrival, its own
        # deadline, or the drain flag, all within a poll interval of each
        # other): the max of the per-rank codes decides for the FLEET, so
        # one rank raising TimeoutError while another saw files (or a drain
        # visible on one host a poll earlier) can never split the ranks
        # across a collective boundary. Drain dominates; any stop leaves
        # the cursor pointing at the unconsumed epoch.
        local = 0  # proceed
        if watch is None:
            local = 2  # this rank's wait timed out (policy='fail')
        elif not any(watch.arrived):
            local = 1  # nothing arrived (policy='skip' timeout)
        if drain_requested():
            local = 3
        code = _max_across_ranks(local)
        if code == 3:
            logger.info(
                f"drain requested; stopping before epoch {epoch} "
                f"(cursor untouched — a restarted service resumes here)"
            )
            records.stop_reason = "drain"
            break
        if code == 2 or watch is None:
            # watch can be None here only single-process (code IS 2 then);
            # multi-host ranks that still got files discard them unconsumed
            logger.info(
                "stopping service: "
                + str(timeout_err if watch is None else "a rank timed out")
            )
            records.stop_reason = "timeout"
            break
        if code == 1:
            logger.info("no checkpoints arrived; stopping")
            records.stop_reason = "no_checkpoints"
            break

        # full-round wall clock from here (post-wait): ingestion through
        # report + overlay export — the number tools/serve_profile.py reports
        t_round = time.time()
        timer = StepTimer()
        # corrupt/foreign files must not kill the service: treat them as
        # not-arrived this round (the straggler machinery already handles
        # partial participation)
        pre = (
            prefetcher.take(epoch, watch.paths)
            if prefetcher is not None
            else None
        )
        deltas: Optional[List] = None
        with timer.span("ingest"):
            files_digest = None
            use_pre = pre is not None and all(watch.arrived)
            if use_pre:
                # re-digest at consume: equality with the prefetch-time
                # digest proves the parsed bytes are the bytes on disk NOW
                # (a client re-upload between prefetch and wait falls back)
                files_digest = ckpt.fingerprint_files(watch.paths)
                use_pre = files_digest == pre["digest"]
            if use_pre:
                selection = [True] * n
                sizes = list(pre["sizes"])
            else:
                if cfg.shapley.persist_utility_table and files_digest is None:
                    # digest the files BEFORE reading them for deltas: if a
                    # client re-uploads between the digest and the read, the
                    # persisted table carries the OLD bytes' digest while its
                    # utilities came from the NEW deltas — on restart the
                    # digest mismatches and the table is REJECTED (wasted
                    # evals, never mixed utilities). Digest-after-read would
                    # invert that into silent corruption (TOCTOU).
                    files_digest = ckpt.fingerprint_files(watch.paths)
                deltas, selection, sizes = ingestion.ingest_clients(
                    watch.paths, current_overlay, spec, on_error="skip",
                    log_fn=logger.info,
                )
        if not any(selection):
            # a transient shared-disk fault can corrupt a whole epoch's
            # files; a long-running service must outlive ONE bad round, not
            # stop on it (only "nothing arrived" above stops the loop) —
            # but a writer that produces garbage EVERY epoch must not spin
            # a bounded serve() call forever
            skipped += 1
            if (
                max_rounds is not None
                and max_skipped_rounds is not None
                and skipped > max_skipped_rounds
            ):
                logger.info(
                    f"{skipped} consecutive unreadable epochs; stopping service"
                )
                records.stop_reason = "corrupt_epochs"
                break
            logger.info(f"no readable checkpoints for epoch {epoch}; skipping round")
            epoch += 1
            # a skipped epoch is consumed: a recycled/restarted process
            # must not re-wait on it
            _write_service_state(
                out_dir,
                _cursor(epoch, skipped=True, rss_mb=process_rss_mb()),
            )
            if cfg.shapley.persist_utility_table and keep_tables > 0:
                # the skip advanced the cursor past this epoch: move the
                # retention floor with it, or the tables the skip jumped
                # over would be stranded until the next restart
                prune_tables(epoch - keep_tables)
            continue
        skipped = 0
        # per-client data sizes from checkpoint metadata drive the FedAvg
        # ratios (load-bearing for SV — reference server2.py:68-81); on
        # partial metadata the round uses equal weights (see ingestion)
        num_local_data = ingestion.resolve_data_sizes(sizes, selection, logger.info)
        with timer.span("stack_deltas"):
            if use_pre:
                # the [n, ...] stack already lives on device (uploaded
                # during the previous round's shapley span); the round's
                # deltas are one broadcast subtract vs the CURRENT overlay
                stacked = sub_overlay(pre["stacked"], current_overlay)
            else:
                # stack on the host, then upload the whole [n, ...] tree
                # once. Missing clients get host zero rows (any(selection)
                # held above, so at least one real delta shapes them)
                proto = next(d for d in deltas if d is not None)
                zeros = tm.tree_map(np.zeros_like, proto)
                stacked = convert.tree_from_numpy(
                    tm.tree_stack_host(
                        [d if d is not None else zeros for d in deltas]
                    ),
                    device,
                )
        start_overlay = current_overlay

        def eval_fn(W):
            return eval_coalitions(
                start_overlay, stacked, W, data, dataset_size=len(valid)
            )

        game = Game(
            eval_coalitions_fn=eval_fn,
            num_local_data=num_local_data,
            client_selection_vector=selection,
            previous_utility=prev_utility,
            utility_dim=cfg.shapley.utility_dim,
            n_all=n,
        )
        # mid-round crash recovery: the utility memo persists after every
        # chunk-sized block of coalition evals (a kill mid-round loses at
        # most one block of device work), and a restarted service picks up a
        # killed round's finished coalitions instead of re-evaluating them
        # (beyond-reference — the reference memo is RAM-only, game2.py:32-34).
        # The table is stamped with a fingerprint of this round's inputs so
        # a stale table (re-uploaded checkpoints, changed FedAvg weights or
        # baseline) is ignored rather than silently mixed with fresh evals.
        if cfg.shapley.persist_utility_table:
            with timer.span("persist_setup"):
                # file-digest fingerprint: the file bytes were digested
                # BEFORE ingest (see above); the deltas' dependence on the
                # current global overlay is captured directly by a strided
                # few-leaf digest (a few-KB fetch) — prev_utility alone
                # leaves a narrow staleness hole
                fp = ckpt.fingerprint_files(
                    [],
                    extra=(
                        files_digest, num_local_data, selection,
                        ckpt.overlay_digest(start_overlay),
                        [f"{u:.12g}" for u in prev_utility],
                    ),
                )
                table_path = os.path.join(
                    out_dir, f"utility_table_epoch_{epoch}.npz"
                )
                if ckpt.utility_table_exists(table_path):
                    restored = ckpt.resume_game(game, table_path, fingerprint=fp)
                    if restored:
                        logger.info(
                            f"resumed {restored} coalition utilities for epoch {epoch}"
                        )
                    else:
                        # zero restores covers BOTH a fingerprint mismatch
                        # (inputs changed) and an empty/torn log left by a
                        # crash before its first record — don't send the
                        # operator chasing a staleness event that never was
                        logger.info(
                            f"no usable utility table for epoch {epoch} "
                            "(stale round inputs, or an empty/torn block "
                            "log) — evaluating from scratch"
                        )
                ckpt.checkpointed_game(
                    game, table_path, fingerprint=fp, block=chunk or 8,
                )
        # kick the NEXT epoch's prefetch now: its files typically land while
        # this round's shapley span (the dominant phase) runs, so the parse
        # + H2D overlap with compute instead of serializing before round e+1
        if prefetcher is not None and (
            max_rounds is None or len(records) + 1 < max_rounds
        ):
            prefetcher.schedule(
                epoch + 1,
                ingestion.checkpoint_path_candidates(
                    root, n, filename=epoch_filename.format(epoch=epoch + 1)
                ),
            )
        # --profile captures a torch.profiler trace of the estimator span
        # (one trace dir per epoch), same knob as the one-shot driver
        with trace(
            os.path.join(cfg.obs.profile_dir, f"epoch_{epoch}"),
            enabled=cfg.obs.profile,
        ):
            with timer.span("shapley_round"):
                sv, sv_se = run_configured_comp_contrib(
                    game, cfg.shapley,
                    rng=np.random.default_rng(cfg.shapley.seed + epoch),
                    logger=logger,
                )
        # completed round -> one self-contained npz (consolidates the
        # block append-log; no-op on non-writing ranks)
        flush_table = getattr(game, "flush_table", None)
        if flush_table is not None:
            flush_table()

        # advance the global overlay by the full-coalition FedAvg and chain
        # previous_utility to the new global's absolute utility
        participating = [i for i, s in enumerate(selection) if s]
        with timer.span("advance_global"):
            if participating:
                ratio = tm.fedavg_ratio([num_local_data[i] for i in participating])
                # select participating rows from the device-resident stack
                # (values identical to restacking the host deltas, with no
                # re-upload); full participation skips the gather
                stacked_sel = (
                    stacked
                    if len(participating) == n
                    else gather_rows(stacked, np.asarray(participating))
                )
                current_overlay = advance(current_overlay, stacked_sel, ratio)
                # the grand coalition's memoized utility IS the new global's:
                # materialize(overlay, stacked, W_full) with the FedAvg row
                # equals advance()'s overlay (same ratios, same linear
                # algebra), and the memo stores its utility as a delta vs
                # this round's baseline. Reusing it skips a full validation
                # pass (~0.19 s/round); the estimator evaluates the grand
                # coalition in virtually every round (always, for exact /
                # full-powerset rounds) — the eval below is the fallback.
                grand = frozenset(participating)
                if grand in game.utility:
                    prev_utility = [
                        game.utility[grand][i] + prev_utility[i]
                        for i in range(cfg.shapley.utility_dim)
                    ]
                else:
                    prev_utility = list(
                        backend.evaluate_single(
                            base, current_overlay, data, dataset_size=len(valid)
                        )
                    )
                if cfg.paths.global_model_path:
                    # exported on the artifact worker thread: the external
                    # FL loop reads the file, nothing in this loop does, and
                    # the atomic-rename protocol means readers never see a
                    # partial file. flush_async_plots() drains it at stop.
                    report_mod.submit_async_artifact(
                        ingestion.save_lora_checkpoint,
                        os.path.join(
                            cfg.paths.global_model_path, f"ViT_global_epoch_{epoch}.npz"
                        ),
                        current_overlay,
                        spec,
                    )
        # rendered last so the timing CSV carries every phase above; the
        # report's own (synchronous) cost is recorded as report_s in the
        # round record (PNGs render on the plot worker thread by default —
        # the loop never waits on them)
        t_report = time.time()
        artifacts = render_round_report(
            out_dir, sv, game=game, round_idx=epoch, timer=timer, se=sv_se,
            render_plots=cfg.obs.render_plots,
            plots_async=cfg.obs.render_plots_async,
        )
        if cfg.obs.use_grad_cam:
            # Grad-CAM overlays of the round's global model. Synchronous:
            # the saliency runs on this thread, the matplotlib render on the
            # artifact worker, after the plots queued there (report.py)
            artifacts.append(
                report_mod.render_saliency(
                    os.path.join(cfg.obs.sal_image_dir, cfg.obs.exp_id),
                    base, current_overlay, valid.images, spec,
                    round_idx=epoch, tb=tb,
                )
            )
        if cfg.obs.render_plots and records:
            # cumulative per-client SV trajectory across the service's
            # rounds (reference: the offline nice_plot* family), rendered on
            # the artifact worker. Refresh cadence decimates as the service
            # ages (every round for the first ~25, then every n/25-th):
            # each render walks the whole history, so decimation bounds the
            # amortized render cost per round at ~25 line draws.
            n_done = len(records) + 1
            if n_done % max(1, n_done // 25) == 0:
                traj = [r["shapley"] for r in records] + [sv]
                p = os.path.join(out_dir, "sv_rounds.png")
                traj_rendered = n_done
                if cfg.obs.render_plots_async:
                    report_mod.submit_async_artifact(
                        report_mod.plot_shapley_rounds, traj, p
                    )
                else:
                    report_mod.plot_shapley_rounds(traj, p)
                artifacts.append(p)
        records.append(
            dict(epoch=epoch, shapley=sv, shapley_se=sv_se, selection=selection,
                 utility=prev_utility, artifacts=artifacts,
                 evals=game.num_evaluations, wall_s=time.time() - t_round,
                 report_s=time.time() - t_report,
                 pipelined_ingest=bool(use_pre),
                 phases={k: v.get("total_s") for k, v in timer.summary().items()
                         if v.get("total_s") is not None})
        )
        rss_mb = process_rss_mb()
        if tb is not None:
            tb.log_round(
                epoch, sv, se=sv_se, utility=prev_utility,
                wall_s=records[-1]["wall_s"], evals=game.num_evaluations,
                phases=records[-1]["phases"],
                health={
                    "rss_mb": rss_mb,
                    "artifact_backlog": report_mod.pending_artifact_jobs(),
                    "skipped_rounds": skipped,
                    # steps up by 1 at every recycle/restart — the TB view
                    # of the service's process-lineage over a long run
                    "generation": generation,
                },
            )
        logger.info(f"round done: epoch {epoch}, new utility {prev_utility}")
        epoch += 1
        if participating:
            # the overlay first, then the cursor that names its digest
            ckpt.save_pytree(overlay_path, current_overlay)
            overlay_fp = ckpt.overlay_digest(current_overlay)
        # restart cursor: a recycled/crashed process resumes at next_epoch
        # via start_epoch="auto" (the CLI's default)
        _write_service_state(out_dir, _cursor(epoch, rss_mb=rss_mb))
        if cfg.shapley.persist_utility_table and keep_tables > 0:
            # the completed round's table will never be resumed again:
            # advance the retention floor (epoch was already incremented —
            # the just-completed epoch is epoch-1; retain it and the K-1
            # before it, delete everything older)
            prune_tables(epoch - keep_tables)
        if _any_across_ranks(drain_requested()):
            logger.info(
                f"drain requested; stopping after epoch {epoch - 1} "
                f"(cursor persisted at epoch {epoch})"
            )
            records.stop_reason = "drain"
            break
        if max_rss_mb is not None:
            peak = rss_mb
            if peak >= max_rss_mb:
                logger.info(
                    f"RSS {peak:.0f} MB >= ceiling {max_rss_mb:.0f} MB after "
                    f"epoch {epoch - 1}: stopping for recycle (resume cursor "
                    f"persisted; restart costs one prewarm)"
                )
                records.stop_reason = "rss_ceiling"
                break
    if prefetcher is not None:
        # stop a still-polling worker (drain/timeout exits leave one alive)
        prefetcher.cancel()
    if tb is not None:
        tb.close()
    if cfg.obs.render_plots and len(records) > 1 and traj_rendered != len(records):
        # the decimated refresh skipped the final round(s): leave the
        # on-disk trajectory complete at shutdown
        report_mod.submit_async_artifact(
            report_mod.plot_shapley_rounds,
            [r["shapley"] for r in records],
            os.path.join(out_dir, "sv_rounds.png"),
        )
    # every queued artifact exists before returning; failures were logged
    # per-job on the worker and must not discard a completed run's records
    failed = report_mod.flush_async_plots(raise_errors=False)
    if failed:
        logger.error(f"{failed} async artifact job(s) failed during this run")
    # stamp THIS run's exit reason onto the cursor without clobbering it
    # (on a pre-round stop — timeout / nothing arrived / drain — next_epoch
    # must keep pointing at the epoch that never processed; a zero-round
    # run synthesizes the same cursor it started from)
    state = read_service_state(out_dir) or _cursor(epoch)
    state["stop_reason"] = records.stop_reason
    # generation always reflects THIS incarnation, even when the rest of
    # the cursor was inherited from a previous run untouched; a legacy
    # (pre-lineage) cursor gets total_rounds backfilled
    state["generation"] = generation
    state.setdefault("total_rounds", prior_rounds + len(records))
    _write_service_state(out_dir, state)
    if records.stop_reason == "drain":
        # the request was honored — a later serve() in this same process
        # (embedder loops, sequential tests) starts fresh instead of
        # instantly draining on the consumed event
        _DRAIN.clear()
    return records


def main(argv=None, device="cuda"):
    """Console entry (``svt-torch-serve``, ``python -m
    shapley_vit_tpu_torch.driver.serve``): the continuous service on the
    card with the reference CLI flags + .env path contract.

    Service knobs ride env vars so the reference flag surface stays a
    strict superset of opts.py: ``SVT_MAX_RSS_MB`` (recycle ceiling — exit
    code ``RECYCLE_EXIT_CODE`` when hit, for ``svt-torch-supervise`` or
    systemd) and
    ``SVT_START_EPOCH`` (integer, or the default ``auto`` = resume from the
    persisted cursor), and ``SVT_KEEP_UTILITY_TABLES`` (per-epoch table
    retention window; 0 keeps everything). ``device``: the card unless a
    caller passes ``"cpu"``."""
    import sys

    cfg = Config.from_args(sys.argv[1:] if argv is None else argv)
    cfg.paths = Config.from_env().paths
    # OS-signal wiring belongs to the PROCESS entry, not the library call:
    # embedders of serve() keep their own signal dispositions and drain via
    # request_drain() / the DRAIN file instead
    _install_drain_handlers(
        os.path.join(cfg.ensure_output_dir(), DRAIN_FILENAME), get_logger()
    )
    ceiling = os.environ.get("SVT_MAX_RSS_MB")
    se = os.environ.get("SVT_START_EPOCH", "auto")
    keep = os.environ.get("SVT_KEEP_UTILITY_TABLES")
    if keep:  # same truthiness guard as SVT_MAX_RSS_MB ("" means unset)
        cfg.shapley.keep_utility_tables = int(keep)
    records = serve(
        cfg,
        max_rss_mb=float(ceiling) if ceiling else None,
        start_epoch="auto" if se == "auto" else int(se),
        device=device,
    )
    # drain (SIGTERM/DRAIN file) is a CLEAN stop — exit 0 so supervisors
    # (svt-torch-supervise, systemd RestartForceExitStatus=3) do not restart
    return RECYCLE_EXIT_CODE if records.stop_reason == "rss_ceiling" else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
