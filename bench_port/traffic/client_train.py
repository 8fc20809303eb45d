"""Traffic kind ``client_train``: a client's LoRA fine-tuning steps back to
back, through the program's training step.

Set-up builds the step as ``driver/client.run_client`` does: the model spec
with ``TRAIN_SPEC`` (the ``[B, H, N, d]`` attention kernel, the MLP as torch
ops), ``fl/training.make_train_step`` on the model family's forward
(``vit_forward`` for the ViT) with Adam, and the overlay and optimizer
state. The client's shard is on the card; each
step's batch is rows drawn from the seed, as ``run_client`` draws them
(distinct rows of the shard), all drawn at set-up and put on the card in
one block of ``row_block`` steps, which the steps cycle through: a step
indexes its rows there and waits for nothing on the host. Set-up drives
that one step object through its first ``check_steps`` steps on rows that
all differ (the reference follows them), then ``warmup_steps`` more, and
hands the same object to the window. Every step, in set-up and window
alike, goes through one feed that keeps at most ``ahead_steps`` steps
dispatched ahead of the one it waits for, so a stall of the host leaves
the card work. When the window's time is up it sends nothing more, waits
for all that was sent (the last step's loss read on the host) and reads
the clock after that wait.

The mix's parameters: ``shard_images``, ``batch``, ``learning_rate``,
``check_steps``, ``warmup_steps``, ``trace_steps``, ``row_block``,
``ahead_steps``.
"""

from __future__ import annotations

import gc
import time
from collections import deque
from typing import Dict, List

import numpy as np

from bench_port.lib import inputs, program
from bench_port.lib.cell import Context, Outcome, log
from bench_port.lib.trace import TracedWindow

LEAVES = ("classifier.bias", "classifier.kernel", "lora.q.A", "lora.q.B", "lora.v.A", "lora.v.B")


def leaf(tree, path: str):
    for k in path.split("."):
        tree = tree[k]
    return tree


def make_inputs(ctx: Context):
    """The weights, overlay and shard from the seed, the checked steps' rows
    (which all differ), and the block of the other steps' rows (each
    step's rows distinct), all on the host."""
    conf, mix = ctx.config, ctx.mix
    dev = ctx.devices[0]
    fam = ctx.family()
    d = fam.dims(conf)
    gen = inputs.generator(ctx.seed, dev)
    base = fam.base(conf, gen, dev)
    init = inputs.init_overlay(d, base, gen, dev)
    images, labels = inputs.images(d, int(mix["shard_images"]), gen, dev, conf["num_labels"])
    n_local, batch = int(mix["shard_images"]), int(mix["batch"])
    rng = np.random.default_rng([int(ctx.seed) % (2**63), 1])
    perm = rng.permutation(n_local)
    rows = [perm[i * batch:(i + 1) * batch] for i in range(int(mix["check_steps"]))]
    block = np.stack([rng.choice(n_local, size=batch, replace=n_local < batch)
                      for _ in range(int(mix["row_block"]))])
    return base, init, images, labels, block, rows


def run(ctx: Context) -> Outcome:
    import torch
    from torch.profiler import record_function

    from shapley_vit_tpu_torch.driver.client import TRAIN_SPEC
    from shapley_vit_tpu_torch.fl import training as tr

    conf, mix = ctx.config, ctx.mix
    dev = ctx.devices[0]
    fam = ctx.family()
    t_build = time.perf_counter()
    spec = fam.spec(conf, remat=False, **TRAIN_SPEC)
    base, init, images, labels, block, check_rows = make_inputs(ctx)
    batch = int(mix["batch"])
    check_dev = torch.as_tensor(np.stack(check_rows), device=dev)
    block_dev = torch.as_tensor(block, device=dev)

    opt = tr.adam(float(mix["learning_rate"]))
    step = tr.make_train_step(fam.forward(spec), spec.num_classes, label_flip_prob=0.0)
    p0 = {k: leaf(init, k).detach().clone() for k in LEAVES}
    lora = tr.trainable(init)
    state = opt.init(lora)

    ahead = deque()  # an event after each step still dispatched ahead

    def one_step(take):
        nonlocal lora, state
        with record_function("bench.step"):
            x, y = images[take], labels[take]
            lora, state, loss = step(base, lora, state, x, y, None)
        if dev.type == "cuda":
            ahead.append(torch.cuda.Event())
            ahead[-1].record()
            if len(ahead) > int(mix["ahead_steps"]):
                ahead.popleft().synchronize()
        return loss

    t_check = time.perf_counter()
    check_losses: List[float] = []
    first_grad = None
    for i in range(len(check_rows)):
        loss = one_step(check_dev[i])
        check_losses.append(float(loss))
        if i == 0:  # the optimizer's first moment after one step is (1 - b1) g
            b1 = state.param_groups[0]["betas"][0]
            first_grad = {}
            for k in LEAVES:
                p = leaf(lora, k)
                m = state.state.get(p, {}).get("exp_avg")  # none: the step gave it nothing
                first_grad[k] = (m.detach().float() / (1 - b1) if m is not None
                                 else torch.zeros_like(p, dtype=torch.float32))
    change = {k: (leaf(lora, k).detach().float() - p0[k].float()) for k in LEAVES}

    drawn = 0

    def draw():
        nonlocal drawn
        drawn += 1
        return block_dev[(drawn - 1) % len(block_dev)]

    t_warm = time.perf_counter()
    for _ in range(int(mix["warmup_steps"])):
        one_step(draw())
    program.sync(ctx.devices)
    facts: Dict[str, object] = {"setup_s": time.perf_counter() - ctx.t0}
    log(f"setup: {t_build - ctx.t0:.3f} s to the cell's build, {t_check - t_build:.3f} s inputs, "
        f"{t_warm - t_check:.3f} s the checked steps, {time.perf_counter() - t_warm:.3f} s warm-up steps")

    n_steps = int(ctx.overrides.get("steps", 0))
    losses = []
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while (n_steps and len(losses) < n_steps) or (not n_steps and (not losses or time.perf_counter() < deadline)):
        losses.append(one_step(draw()))
    last = float(losses[-1])  # the window ends with the last step's loss on the host
    t1 = time.perf_counter()
    window_losses = torch.stack(losses).float().cpu().numpy()
    facts.update({"window_s": t1 - t0, "steps": len(losses),
                  "images_per_s": len(losses) * batch / (t1 - t0),
                  "window_flops": len(losses) * fam.train_step_flops(conf, batch),
                  "last_loss": last})
    summary = None
    if ctx.trace:
        with TracedWindow(ctx.devices, fam.KERNEL_FAMILIES) as tw:
            traced = [one_step(draw()) for _ in range(int(mix["trace_steps"]))]
            float(traced[-1])
        summary = tw.summary()
        facts["traced_steps"] = len(traced)
    memory = program.peak_memory(ctx.devices)
    failed = int((~np.isfinite(window_losses)).sum())

    del lora, state, step, opt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    read = readings(ctx, base, init, images, labels, check_rows, check_losses, first_grad, change)
    limits = ctx.overrides.get("limits", ctx.limits)
    checks = {k: (float(v), float(limits[k]["limit"])) for k, v in read.items() if k in limits}
    return Outcome(facts=facts, checks=checks, attempted=len(losses), failed=failed,
                   memory_peak_bytes=memory, trace=summary, readings=read)


def worst_leaf_gap(got: Dict[str, "object"], want: Dict[str, "object"], leaves,
                   difference: bool = False) -> float:
    """The worst leaf's gap between the program's norm and the reference's
    or, with ``difference``, the norm of their difference, over the larger
    of that leaf's reference norm and the median leaf's."""
    norms = {k: float(want[k].norm()) for k in want}
    median = float(np.median(list(norms.values())))

    def gap(k):
        if difference:
            return float((got[k].float() - want[k].float()).norm())
        return abs(float(got[k].norm()) - norms[k])

    return max((gap(k) / max(norms[k], median, 1e-30) for k in leaves), default=0.0)


def gaps(got: tuple, want: tuple) -> dict:
    """Compare ``(losses, first_grad, change)`` with the reference's
    ``(losses, first_grad, change, moving)``."""
    losses, first_grad, change = got
    want_losses, want_grad, want_change, moving = want
    got_change = {k: change[k] for k in moving}
    want_change = {k: want_change[k] for k in moving}
    return {
        "first_loss_gap": abs(losses[0] - want_losses[0]),
        "loss_gap": max(abs(a - b) for a, b in zip(losses, want_losses)),
        "grad_norm_gap": worst_leaf_gap(first_grad, want_grad, LEAVES),
        "grad_rel_err": worst_leaf_gap(first_grad, want_grad, LEAVES, difference=True),
        "change_norm_gap": worst_leaf_gap(got_change, want_change, moving),
        "change_rel_err": worst_leaf_gap(got_change, want_change, moving, difference=True),
    }


def reference_steps(ctx: Context, base, init, images, labels, rows, **kw):
    import torch

    batches = [torch.as_tensor(r, device=images.device) for r in rows]
    return ctx.reference().train_steps(base, init, images, labels, batches, ctx.config,
                                       float(ctx.mix["learning_rate"]), **kw)


def readings(ctx: Context, base, init, images, labels, rows, losses, first_grad, change) -> dict:
    """The compared numbers of the checked steps: the widest gap of a
    step's loss and the first step's; the worst leaf's gap of the first
    gradient's norm, and the norm of its difference from the reference's;
    the same of the change after the checked steps, over the leaves whose
    reference gradient is above a thousandth of the median leaf's at some
    step (the others move under Adam by round-off alone).

    With ``overrides["reference_quant"]`` (calibration and the card test)
    the reference computed at that precision stands in the program's place;
    with ``overrides["half_batch"]`` the reference leaving out half of each
    batch (a fault) does."""
    want = reference_steps(ctx, base, init, images, labels, rows, moving_rule=1e-3)
    stand_in = {k: v for k, v in (("quant", ctx.overrides.get("reference_quant")),
                                  ("half_batch", ctx.overrides.get("half_batch"))) if v}
    if stand_in:
        losses, first_grad, change, _ = reference_steps(ctx, base, init, images, labels, rows,
                                                        **stand_in)
    return gaps((losses, first_grad, change), want)
