"""Traffic kind ``shapley_round``: Shapley rounds back to back, each scoring
a fresh set of client deltas through the program's round path.

Set-up builds what ``driver/start.get_initial_shapley_value`` builds before
its round: the evaluation backend (``driver/start.build_eval_backend``, on
the cell's cards), the validation batches uploaded once, and the initial
model's utility. Each round then does what that function's step 6 does:
uploads one set of client deltas from host arrays, wraps the backend's
``eval_coalitions`` in a fresh ``Game`` (so no utility comes from an earlier
round's memo; nothing is persisted), and runs
``run_configured_comp_contrib`` to the host's Shapley values. The delta sets
are a pool drawn from the seed, which the rounds cycle through.

The mix's parameters: ``clients`` and ``client_sizes``, ``samples_per_client``
(m = that times n), ``stratify``, ``eval_batch``,
``delta_pool``, ``delta_scale``, ``warmup_rounds``, ``trace_rounds``, and for
the check ``check_entries`` (pool entries the reference recomputes, in an
order drawn from the seed among those the rounds used; every round that
used one is compared) and ``reference_block``.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from bench_port.lib import counts, inputs, program
from bench_port.lib.cell import Context, Outcome, log
from bench_port.lib.trace import TracedWindow


@dataclass
class Round:
    index: int
    entry: int
    start: float
    end: float
    eval_s: float
    calls: List[int]
    evaluations: int
    utilities: Dict[frozenset, np.ndarray]
    sv: np.ndarray
    failed: bool = False


@dataclass
class Setup:
    cfg: object
    base: dict
    init: dict
    images: object           # device tensor [V, H, W, C] float32
    labels: object           # device tensor [V]
    pool: List[list]         # pool of n host delta trees each
    sizes: List[float]
    eval_coalitions: object
    backend: object
    data: object
    chunk: int
    prev: List[float]


# the stream that draws the pool entries the check recomputes (no round's)
CHECK_STREAM = 2**40


def round_rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2**63), int(index)])


def build(ctx: Context) -> Setup:
    import torch

    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.data.arrays import ArrayDataset
    from shapley_vit_tpu_torch.driver import start as drv

    conf, mix = ctx.config, ctx.mix
    dev = ctx.devices[0]
    n = int(mix["clients"])
    cfg = Config()
    cfg.model.compute_dtype = conf["compute_dtype"]
    cfg.model.gelu = conf["gelu"]
    cfg.model.eval_mode = conf["eval_mode"]
    cfg.model.num_classes = conf["num_labels"]
    cfg.model.lora_r = conf["lora_r"]
    cfg.model.lora_alpha = float(conf["lora_alpha"])
    cfg.shapley.num_clients = n
    cfg.shapley.samples_per_client = int(mix["samples_per_client"])
    cfg.shapley.cc_stratify = mix["stratify"]
    cfg.shapley.persist_utility_table = False
    cfg.data.eval_batch_size = int(mix["eval_batch"])
    fam = ctx.family()
    spec = fam.spec(conf)

    d = fam.dims(conf)
    gen = inputs.generator(ctx.seed, dev)
    base = fam.base(conf, gen, dev)
    init = inputs.init_overlay(d, base, gen, dev)
    images, labels = inputs.images(d, int(conf["validation_images"]), gen, dev, conf["num_labels"])
    pool = [inputs.client_deltas(d, n, gen, dev, mix["delta_scale"])
            for _ in range(int(mix["delta_pool"]))]
    sizes = [float(s) for s in mix["client_sizes"]]

    backend, eval_coalitions, chunk = drv.build_eval_backend(
        cfg, spec, base, init, device=dev, devices=list(ctx.devices))
    valid = ArrayDataset(images=images.cpu().numpy(), labels=labels.cpu().numpy())
    data = backend.device_batches(valid, cfg.data.eval_batch_size)
    acc, loss = backend.evaluate_single(base, init, data, dataset_size=len(valid))
    return Setup(cfg=cfg, base=base, init=init, images=images, labels=labels, pool=pool,
                 sizes=sizes, eval_coalitions=eval_coalitions, backend=backend, data=data,
                 chunk=chunk, prev=[acc, loss])


def one_round(ctx: Context, s: Setup, index: int) -> Round:
    """One round: upload the entry's deltas, score them with a fresh Game."""
    from torch.profiler import record_function

    from shapley_vit_tpu_torch.models.convert import tree_from_numpy
    from shapley_vit_tpu_torch.ops import tree_math as tm
    from shapley_vit_tpu_torch.shapley import Game, run_configured_comp_contrib

    n = int(ctx.mix["clients"])
    entry = index % len(s.pool)
    n_val = int(ctx.config["validation_images"])
    calls: List[int] = []
    in_eval = [0.0]
    t0 = time.perf_counter()
    with record_function("bench.round"):
        with record_function("bench.upload"):
            stacked = tree_from_numpy(tm.tree_stack_host(s.pool[entry]), ctx.devices[0])

        def eval_coalitions_fn(W):
            t = time.perf_counter()
            with record_function("bench.eval"):
                out = s.eval_coalitions(s.init, stacked, W, s.data, dataset_size=n_val)
            in_eval[0] += time.perf_counter() - t
            calls.append(int(np.shape(W)[0]))
            return out

        game = Game(eval_coalitions_fn=eval_coalitions_fn, num_local_data=s.sizes,
                    client_selection_vector=[True] * n, previous_utility=s.prev,
                    utility_dim=2, n_all=n)
        failed = False
        try:
            with record_function("bench.estimator"):
                sv, _se = run_configured_comp_contrib(game, s.cfg.shapley, rng=round_rng(ctx.seed, index),
                                                      logger=program.quiet_logger())
            sv_arr = np.array([[sv[d][c] for c in range(n)] for d in range(2)])
        except FloatingPointError as e:  # the evaluator's NaN guard
            log(f"round {index}: {e}")
            failed, sv_arr = True, np.full((2, n), np.nan)
    t1 = time.perf_counter()
    util = {k: np.asarray(v, np.float64) + np.asarray(s.prev, np.float64) for k, v in game.utility.items()}
    return Round(index=index, entry=entry, start=t0, end=t1, eval_s=in_eval[0], calls=calls,
                 evaluations=game.num_evaluations, utilities=util, sv=sv_arr, failed=failed)


def batch_rows(s: Setup) -> List[int]:
    return [int(b.rows) for b in s.data]


def traced_kernel_work(ctx: Context, s: Setup, rounds: List[Round]) -> dict:
    """The calls in ``rounds`` of each hand kernel family that the model
    family counts (``kernel_calls``), from the shapes: per evaluation call,
    chunk, cell, batch and block; and their operations, bytes and least
    times."""
    from shapley_vit_tpu_torch.parallel.mesh import COALITION_AXIS, DATA_AXIS

    conf = ctx.config
    fam = ctx.family()
    L = fam.dims(conf)["L"]
    isz = 2 if conf["compute_dtype"] == "bfloat16" else 4
    dtype = conf["compute_dtype"]
    n_c = s.backend.mesh.shape[COALITION_AXIS]
    n_d = s.backend.mesh.shape[DATA_AXIS]
    work: Dict[str, list] = {}
    for r in rounds:
        for C in r.calls:
            pieces = ([min(s.chunk, C - i) for i in range(0, C, s.chunk)]
                      if s.chunk and C > s.chunk else [C])
            for piece in pieces:
                per_cell = -(-piece // n_c)
                for rows in batch_rows(s):
                    per_dev = rows // n_d
                    cells = n_c * n_d * L
                    for key, (ff, bb) in fam.kernel_calls(conf, per_cell * per_dev, isz).items():
                        w = work.setdefault(key, [0, 0.0, 0.0, 0.0])
                        w[0] += cells
                        w[1] += cells * ff
                        w[2] += cells * bb
                        w[3] += cells * counts.bound_seconds(ff, bb, dtype)
    return {k: {"calls": v[0], "flops": v[1], "bytes": v[2], "bound_s": v[3]} for k, v in work.items()}


def run_rounds(ctx: Context, s: Setup, first: int, count: int = 0, seconds: float = 0.0):
    """Rounds from index ``first``: ``count`` of them, or as many as start
    within ``seconds``. Returns (rounds, start, end)."""
    out: List[Round] = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = first
    while (count and len(out) < count) or (not count and (not out or time.perf_counter() < deadline)):
        out.append(one_round(ctx, s, i))
        i += 1
    return out, t0, out[-1].end


def window_facts(ctx: Context, s: Setup, rounds: List[Round], t0: float, t1: float) -> dict:
    n_val = int(ctx.config["validation_images"])
    evals = sum(r.evaluations for r in rounds)
    durations = [r.end - r.start for r in rounds]
    flops = 0.0
    rows = batch_rows(s)
    fam = ctx.family()
    for r in rounds:
        for C in r.calls:
            flops += sum(fam.coalition_eval_flops(ctx.config, b, C) for b in rows)
    return {"window_s": t1 - t0, "rounds": len(rounds), "evaluations": evals,
            "images_per_s": evals * n_val / (t1 - t0),
            "round_p90_s": float(np.percentile(durations, 90)),
            "round_s": durations,
            "host_s_per_round": float(np.mean([d - r.eval_s for d, r in zip(durations, rounds)])),
            "window_flops": flops}


def run(ctx: Context) -> Outcome:
    import torch

    t_build = time.perf_counter()
    s = build(ctx)
    t_warm = time.perf_counter()
    mix = ctx.mix
    warm, _, _ = run_rounds(ctx, s, 0, count=int(mix["warmup_rounds"]))
    program.sync(ctx.devices)
    facts = {"setup_s": time.perf_counter() - ctx.t0}
    log(f"setup: {t_build - ctx.t0:.3f} s to the cell's build, {t_warm - t_build:.3f} s inputs, "
        f"backend and the initial utility, {time.perf_counter() - t_warm:.3f} s warm-up rounds")
    n_rounds = int(ctx.overrides.get("rounds", 0))
    window, t0, t1 = run_rounds(ctx, s, len(warm), count=n_rounds, seconds=ctx.seconds)
    facts.update(window_facts(ctx, s, window, t0, t1))
    traced: List[Round] = []
    summary = None
    if ctx.trace:
        fam = ctx.family()
        before = program.launch_counts(fam.WRAPPERS)
        with TracedWindow(ctx.devices, fam.KERNEL_FAMILIES) as tw:
            traced, _, _ = run_rounds(ctx, s, len(warm) + len(window), count=int(mix["trace_rounds"]))
        summary = tw.summary()
        facts["traced_rounds"] = len(traced)
        facts["traced_launches"] = program.launches_between(before, program.launch_counts(fam.WRAPPERS))
        facts["traced_work"] = traced_kernel_work(ctx, s, traced)
    memory = program.peak_memory(ctx.devices)
    rounds = warm + window + traced
    attempted, failed = len(window) + len(traced), sum(r.failed for r in window + traced)

    # the program's state goes before the reference runs
    base, init, images, labels, pool, sizes, prev = (s.base, s.init, s.images, s.labels, s.pool,
                                                     s.sizes, s.prev)
    del s
    gc.collect()
    if ctx.devices[0].type == "cuda":
        torch.cuda.empty_cache()
    read = readings(ctx, rounds, base, init, images, labels, pool, sizes, prev)
    return Outcome(facts=facts, checks=check(ctx, read), attempted=attempted, failed=failed,
                   memory_peak_bytes=memory, trace=summary, readings=read)


def readings(ctx: Context, rounds: List[Round], base, init, images, labels, pool, sizes, prev) -> dict:
    """The compared numbers: the widest gaps between the program's and the
    reference's utilities (accuracy, loss, over every coalition of every
    compared round and the initial model), between their Shapley values,
    and the count of rounds whose evaluated coalitions are not the ones the
    round's draws need.

    With ``overrides["reference_quant"]`` (calibration and the card test)
    the reference computed at that precision stands in the program's place:
    its utilities and Shapley values are compared instead of the program's."""
    ref = ctx.reference()
    n = int(ctx.mix["clients"])
    m = int(ctx.mix["samples_per_client"]) * n
    # the pool entries to recompute: the first ``check_entries`` of a seeded
    # order that some round used
    used = {r.entry for r in rounds}
    order = [int(e) for e in round_rng(ctx.seed, CHECK_STREAM).permutation(len(pool)) if int(e) in used]
    entries = sorted(order[:int(ctx.mix["check_entries"])])
    block = int(ctx.mix["reference_block"])
    stand_in = ctx.overrides.get("reference_quant")
    acc_gap = loss_gap = sv_gap = sv_loss_gap = 0.0
    wrong_sets = 0
    compared = 0
    signed = []
    for e in entries:
        want = ref.coalition_utilities(base, init, pool[e], sizes, images, labels, ctx.config, block)
        other = (ref.coalition_utilities(base, init, pool[e], sizes, images, labels, ctx.config, block,
                                         quant=stand_in) if stand_in else None)
        start = other[frozenset()] if other else prev
        acc_gap = max(acc_gap, abs(start[0] - want[frozenset()][0]))
        loss_gap = max(loss_gap, abs(start[1] - want[frozenset()][1]))
        for r in rounds:
            if r.entry != e:
                continue
            compared += 1
            needed = needed_coalitions(n, m, round_rng(ctx.seed, r.index))
            if other:
                utilities = {key: other[key] for key in needed}
                sv = ref.comp_contrib(n, m, other, round_rng(ctx.seed, r.index))
            else:
                utilities, sv = r.utilities, r.sv
                if set(utilities) != needed or r.evaluations != len(needed):
                    wrong_sets += 1
            for key, got in utilities.items():
                if key in want:
                    acc_gap = max(acc_gap, abs(got[0] - want[key][0]))
                    loss_gap = max(loss_gap, abs(got[1] - want[key][1]))
                    signed.append(got[1] - want[key][1])
            sv_ref = ref.comp_contrib(n, m, want, round_rng(ctx.seed, r.index))
            sv_gap = max(sv_gap, float(np.max(np.abs(sv - sv_ref))))
            sv_loss_gap = max(sv_loss_gap, float(np.max(np.abs(sv[1] - sv_ref[1]))))
    signed = np.asarray(signed or [0.0])
    return {"acc_gap": acc_gap, "loss_gap": loss_gap, "sv_gap": sv_gap, "sv_loss_gap": sv_loss_gap,
            "loss_rms": float(np.sqrt((signed ** 2).mean())),
            "wrong_coalition_sets": float(wrong_sets), "rounds_compared": compared}


def needed_coalitions(n: int, m: int, rng: np.random.Generator) -> set:
    """The non-empty coalitions a round's m draws evaluate."""
    out = set()
    for _ in range(m):
        idxs = rng.permutation(n)
        j = int(rng.integers(1, n + 1))
        for part in (idxs[:j], idxs[j:]):
            if len(part):
                out.add(frozenset(int(i) for i in part))
    return out


def check(ctx: Context, read: dict) -> dict:
    """Each reading that the cell's limits hold, as ``(value, limit)``."""
    limits = ctx.overrides.get("limits", ctx.limits)
    out = {}
    for name, value in read.items():
        if name in limits:
            out[name] = (float(value), float(limits[name]["limit"]))
    if read["rounds_compared"] == 0:
        out["rounds_compared"] = (0.0, -1.0)  # nothing compared is never correct
    return out
