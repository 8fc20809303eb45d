#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``build``   — compiles the three kernel sources of ``shapley_vit_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once; ``attention.cu`` holds two kernels).
2. ``kernels`` — each of the four kernels at its main path's shapes, in
   bfloat16 and float32, against its plain PyTorch version on the same inputs
   (float32: atol/rtol 1e-4, sums over up to 3072 terms in another order;
   bfloat16: atol/rtol 2e-2, outputs rounded to bf16), with CUDA-event times
   (median of several runs after warm-up) of the kernel, the plain version
   and, where one PyTorch call computes the same function, that call
   (``library_ms``; the port never calls it), and the least time the card
   could take (``bound_ms``). ``fused_attention``'s gradient (the
   ``autograd.Function``) is held against autograd through its plain
   version on the same inputs, with the same tolerances.
3. ``model``   — ViT-B/16 float32 logits of 8 images (LoRA overlay and two
   merged coalitions) on the card through the kernels, against the port on
   the CPU through the plain versions, from the same weights (atol 1e-3).
4. ``round``   — one Shapley round through ``driver.start.start`` with the
   default ``Config`` (ViT-B/16, bf16, merged LoRA, comp-contrib m = 50·n) on
   the synthetic OCT validation set and three client drops written by
   ``save_lora_checkpoint``; the launch counters are zeroed just before and
   read just after, and every kernel of the round must have run.
   ``shapley_exact`` over the round's persisted utility table checks the
   efficiency axiom.
5. ``profile`` — device time by kernel, and the device's idle share, over
   one more coalition pass of the round (7 coalitions, 400 images) under
   ``torch.profiler``, after the round so it touches neither its counts
   nor its time.
6. ``train``   — LoRA client training, in three parts:
   ``run_client`` with the default ``Config`` (ViT-B/16, bf16, synthetic OCT
   at scale 1.0, batch 64, Adam) for 4 steps on the card, counters zeroed
   just before: ``fused_attention`` must launch 48 times (12 blocks x 4
   steps), the loss must be finite and the re-loaded drop must have a
   non-zero LoRA B; it reports ms per step, images/s and peak memory. The
   same again with ``cfg.train.remat`` (96 launches: the backward runs each
   block's forward again). Then
   one float32 training step of ViT-B/16 at batch 2, card against CPU from
   the same weights (loss within 1e-4; each gradient leaf within 1e-3 of
   that leaf's largest magnitude: float32 sums over up to 3072 terms in
   another order, through 12 blocks). Then ``run_demo(variant="base",
   image_size=224)``: three clients trained and scored on the card, with
   the efficiency axiom checked on its utility table.

Then the card's name and power limit, the kernels summary line, and as the
last line ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before that line; without a CUDA device the script exits non-zero at once.
"""

from __future__ import annotations

import csv
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks (NVIDIA data sheets, dense): matrix rate by dtype, memory rate.
_PEAKS = {
    "sxm": {"bfloat16": 989e12, "float32": 67e12, "bytes": 3.35e12},
    "pcie": {"bfloat16": 756e12, "float32": 51e12, "bytes": 2.0e12},
}

KERNELS = {
    "patch_embed": ("shapley_vit_tpu_torch/csrc/patch_embed.cu",
                    "shapley_vit_tpu/ops/patch_embed.py:32"),
    "fused_attention_packed": ("shapley_vit_tpu_torch/csrc/attention.cu",
                               "shapley_vit_tpu/ops/attention.py:106"),
    "fused_mlp_block": ("shapley_vit_tpu_torch/csrc/mlp_block.cu",
                        "shapley_vit_tpu/ops/mlp_block.py:39"),
    "fused_attention": ("shapley_vit_tpu_torch/csrc/attention.cu",
                        "shapley_vit_tpu/ops/attention.py:33"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks(name: str) -> dict:
    return _PEAKS["pcie" if "pcie" in name.lower() else "sxm"]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_kernels(card: str) -> dict:
    """Every kernel at the round's shapes, both dtypes. Returns the bf16
    numbers per kernel (the round's dtype) for the summary line."""
    import torch
    import torch.nn.functional as F

    from shapley_vit_tpu_torch.ops import attention as att
    from shapley_vit_tpu_torch.ops import mlp_block as mlp
    from shapley_vit_tpu_torch.ops import patch_embed as pe

    pk = peaks(card)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    B, IMG, P, CH, D, H, HID = 128, 224, 16, 3, 768, 12, 3072
    NP, N = (IMG // P) ** 2, (IMG // P) ** 2 + 1
    CB = 7 * B                       # 7 coalitions x 128 images
    M = CB * N                       # tokens of one coalition batch
    TB = 64                          # the client's training batch
    summary = {}
    results = []
    grads = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        isz = torch.finfo(dtype).bits // 8
        tol = dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else dict(atol=1e-4, rtol=1e-4)
        cases = {}

        img = randn((B, IMG, IMG, CH), dtype=dtype)
        pw, pb = randn((P * P * CH, D), 0.05, dtype), randn((D,), 0.1, dtype)
        conv_w = pw.reshape(P, P, CH, D).permute(3, 2, 0, 1).contiguous()
        img_nchw = img.permute(0, 3, 1, 2)
        cases["patch_embed"] = dict(
            kernel=lambda: pe.patch_embed(img, pw, pb, P),
            plain=lambda: pe.patch_embed_plain(img, pw, pb, P),
            library=lambda: F.conv2d(img_nchw, conv_w, pb, stride=P),
            flops=2.0 * B * NP * (P * P * CH) * D,
            bytes=(img.numel() + pw.numel() + pb.numel() + B * NP * D) * isz,
            reps=20,
        )

        q, k, v = (randn((CB, N, H * 64), dtype=dtype) for _ in range(3))
        qh, kh, vh = (t.view(CB, N, H, 64).transpose(1, 2) for t in (q, k, v))
        cases["fused_attention_packed"] = dict(
            kernel=lambda: att.fused_attention_packed(q, k, v, heads=H),
            plain=lambda: att.fused_attention_packed_plain(q, k, v, heads=H),
            library=lambda: F.scaled_dot_product_attention(qh, kh, vh),
            flops=4.0 * CB * H * N * N * 64,
            bytes=4 * q.numel() * isz,
            reps=5,
        )

        x = randn((M, D), dtype=dtype)
        ls, lb = (1 + randn((D,), 0.1)).to(dtype), randn((D,), 0.1, dtype)
        w1, b1 = randn((D, HID), 0.03, dtype), randn((HID,), 0.1, dtype)
        w2, b2 = randn((HID, D), 0.03, dtype), randn((D,), 0.1, dtype)
        mlp_args = (x, ls, lb, w1, b1, w2, b2)
        cases["fused_mlp_block"] = dict(
            kernel=lambda: mlp.fused_mlp_block(*mlp_args, eps=1e-12),
            plain=lambda: mlp.fused_mlp_block_plain(*mlp_args, eps=1e-12),
            library=None,
            flops=4.0 * M * D * HID,
            bytes=(2 * M * D + 2 * D * HID + HID + 3 * D) * isz,
            reps=3,
        )

        # the training path's [B, H, N, d] views of packed projections
        tq, tk, tv = (randn((TB, N, H * 64), dtype=dtype) for _ in range(3))
        tqh, tkh, tvh = (t.view(TB, N, H, 64).transpose(1, 2) for t in (tq, tk, tv))
        cases["fused_attention"] = dict(
            kernel=lambda: att.fused_attention(tqh, tkh, tvh),
            plain=lambda: att.fused_attention_plain(tqh, tkh, tvh),
            library=lambda: F.scaled_dot_product_attention(tqh, tkh, tvh),
            flops=4.0 * TB * H * N * N * 64,
            bytes=4 * tq.numel() * isz,
            reps=10,
        )
        grads.append(attention_grad_check(dtype, tol, tqh, tkh, tvh))

        wrappers = {"patch_embed": pe.patch_embed, "fused_attention_packed": att.fused_attention_packed,
                    "fused_mlp_block": mlp.fused_mlp_block, "fused_attention": att.fused_attention}
        for name, c in cases.items():
            launched = wrappers[name].launches
            got = c["kernel"]()
            want = c["plain"]()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), **tol)
            del got, want
            t_ops = c["flops"] / pk[dname]
            t_bytes = c["bytes"] / pk["bytes"]
            row = {
                "name": name, "dtype": dname, "max_abs_err": err, "ok": ok,
                "ms": cuda_ms(c["kernel"], c["reps"]),
                "plain_ms": cuda_ms(c["plain"], c["reps"]),
                "library_ms": cuda_ms(c["library"], c["reps"]) if c["library"] else None,
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "launches": wrappers[name].launches - launched,  # this phase's, not the round's
            }
            results.append(row)
            if dtype == torch.bfloat16:
                summary[name] = row
            torch.cuda.empty_cache()
        del cases, img, q, k, v, qh, kh, vh, x, mlp_args, tq, tk, tv, tqh, tkh, tvh
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "card": card, "results": results, "gradients": grads})
    bad = [r for r in results + grads if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    return summary


def attention_grad_check(dtype, tol, q, k, v) -> dict:
    """``fused_attention``'s gradient (its ``autograd.Function``: kernel
    forward, recomputed backward) against autograd through the plain
    version, on the same inputs and cotangent."""
    import torch
    import torch.nn.functional as F

    from shapley_vit_tpu_torch.ops import attention as att

    cot = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                      device="cuda").to(dtype)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(*leaves), leaves, cot)

    out = [fwd_bwd(fn)() for fn in (att.fused_attention, att.fused_attention_plain)]
    torch.cuda.synchronize()
    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(*out)]
    ok = all(torch.allclose(a.float(), b.float(), **tol) for a, b in zip(*out))
    # forward + backward times: the kernel's forward and the recomputed
    # backward; autograd through the plain version; SDPA's own backward
    return {"name": "fused_attention.backward", "dtype": str(dtype).replace("torch.", ""),
            "shape": list(q.shape), "max_abs_err": {"dq": errs[0], "dk": errs[1], "dv": errs[2]},
            "fwd_bwd_ms": cuda_ms(fwd_bwd(att.fused_attention), 10),
            "plain_fwd_bwd_ms": cuda_ms(fwd_bwd(att.fused_attention_plain), 10),
            "library_fwd_bwd_ms": cuda_ms(fwd_bwd(F.scaled_dot_product_attention), 10),
            "ok": ok}


def phase_model() -> None:
    """ViT-B/16 float32 logits: kernels on the card vs plain versions on the CPU."""
    import torch

    from shapley_vit_tpu_torch.models import vit as tvit
    from shapley_vit_tpu_torch.ops import tree_math as tm

    spec = tvit.make_spec("base", dtype="float32")
    gen = torch.Generator().manual_seed(1)
    base = tvit.init_vit(gen, spec)
    lora = tvit.init_lora(gen, spec, classifier_from=base)
    lora = tm.tree_map(lambda a: a + 0.02 * torch.randn(a.shape, generator=gen), lora)
    deltas = tm.tree_map(lambda a: 0.02 * torch.randn((2, *a.shape), generator=gen), lora)
    images = torch.rand((8, spec.image, spec.image, spec.channels), generator=gen)
    W = torch.tensor([[0.3, 0.7], [1.0, 0.0]])

    def logits(dev):
        b = tm.tree_map(lambda a: a.to(dev), base)
        lo = tm.tree_map(lambda a: a.to(dev), lora)
        de = tm.tree_map(lambda a: a.to(dev), deltas)
        x = images.to(dev)
        with torch.inference_mode():
            one = tvit.vit_forward(b, lo, x, spec)
            merged = tvit.merge_coalition_weights(b, tm.materialize_coalitions(lo, de, W), spec)
            many = tvit.vit_forward_merged(b, merged, x, spec)
        return torch.cat([one[None], many]).cpu()

    cpu = logits("cpu")
    gpu = logits("cuda")
    err = (gpu - cpu).abs().max().item()
    ok = bool(torch.isfinite(gpu).all()) and err <= 1e-3
    emit({"phase": "model", "variant": "base", "dtype": "float32", "images": 8,
          "logits_shape": list(gpu.shape), "max_abs_err_vs_cpu": err, "atol": 1e-3, "ok": ok})
    if not ok:
        raise SystemExit("ViT-B logits on the card disagree with the CPU")


def _metric(path: str, tag: str) -> float:
    with open(path, newline="") as f:
        rows = [r for r in csv.DictReader(f) if r["tag"] == tag]
    return float(rows[-1]["value"])


def exact_efficiency(output_dir: str, n: int):
    """Exact Shapley values from a round's persisted utility table, and how
    far their sum is from the grand coalition's utility (the efficiency
    axiom), the worse of the two utility dimensions."""
    from shapley_vit_tpu_torch.fl import checkpoint as ckpt
    from shapley_vit_tpu_torch.shapley import Game, shapley_exact

    table, _ = ckpt.load_utility_table(os.path.join(output_dir, "utility_table.npz"))

    def never(W):
        raise RuntimeError("coalition missing from the round's utility table")

    game = Game(never, [1] * n, [True] * n, [0.0, 0.0], utility_dim=2, n_all=n)
    game.utility.update({k: list(v) for k, v in table.items()})
    exact = shapley_exact(game)
    grand = table[frozenset(range(n))]
    return exact, max(abs(sum(exact[d].values()) - grand[d]) for d in range(2))


def phase_round(counted) -> dict:
    """One Shapley round through the port's entry point; returns the launch
    count of each kernel during the round."""
    import numpy as np
    import torch

    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.driver import start as drv
    from shapley_vit_tpu_torch.fl import ingestion
    from shapley_vit_tpu_torch.models.convert import tree_to_numpy
    from shapley_vit_tpu_torch.ops import tree_math as tm

    cfg = Config()  # ViT-B/16, bf16, exact_f32 GELU, merged, comp-contrib
    work = os.path.join(ROOT, "exp", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)  # a stale utility table would skip evaluations
    cfg.obs.exp_dir = os.path.join(work, "out")

    # three client drops: the initial overlay plus seeded random LoRA deltas
    spec, _, init_lora = drv.build_model(cfg, device="cpu")
    init_host = tree_to_numpy(init_lora)
    rng = np.random.default_rng(7)
    paths = []
    for i, n_train in enumerate((120, 300, 580)):
        drop = tm.tree_map(
            lambda a: a + (0.02 * rng.normal(size=a.shape)).astype(np.float32), init_host
        )
        p = os.path.join(work, f"client_{i + 1}_model", "ViT_epoch_9.npz")
        ingestion.save_lora_checkpoint(p, drop, spec, num_local_data_train=n_train)
        paths.append(p)

    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    all_rounds, _ = drv.start(cfg, checkpoint_paths=paths, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}

    metrics = os.path.join(cfg.output_dir, f"party0_{cfg.obs.exp_id}_{cfg.data.mode}_metrics.csv")
    round_s = _metric(metrics, "time/shapley_round")
    evals = int(_metric(metrics, "shapley_round/coalition_evals"))
    sv = [[all_rounds[d][1][c] for c in range(cfg.shapley.num_clients)]
          for d in range(cfg.shapley.utility_dim)]

    exact, eff_err = exact_efficiency(cfg.output_dir, 3)

    valid_n = max(40, int(400 * cfg.data.synthetic_scale))  # the registry's synthetic OCT size
    ok = (
        all(math.isfinite(x) for row in sv for x in row)
        and eff_err <= 1e-4
        and all(n > 0 for n in launches.values())
    )
    emit({
        "phase": "round", "variant": "base", "dtype": cfg.model.compute_dtype,
        "eval_mode": cfg.model.eval_mode, "clients": 3, "validation_images": valid_n,
        "batches": math.ceil(valid_n / cfg.data.eval_batch_size),
        "shapley_value": {"accuracy": sv[0], "loss": sv[1]},
        "exact_shapley_value": {"accuracy": [exact[0][c] for c in range(3)],
                                "loss": [exact[1][c] for c in range(3)]},
        "efficiency_err": eff_err, "round_s": round_s, "wall_s": wall,
        "coalition_evals": evals, "coalition_evals_per_s": evals / round_s,
        "launches": launches, "ok": ok,
    })
    if not ok:
        raise SystemExit("the Shapley round failed its checks")
    return launches


def phase_train(counted) -> dict:
    """LoRA client training on the card; returns the launch count of each
    kernel during ``run_client``."""
    import logging
    import re

    import numpy as np
    import torch

    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.driver import client, run_demo
    from shapley_vit_tpu_torch.driver import start as drv
    from shapley_vit_tpu_torch.fl import ingestion
    from shapley_vit_tpu_torch.fl import training as tr
    from shapley_vit_tpu_torch.models import vit as tvit
    from shapley_vit_tpu_torch.ops import tree_math as tm
    from shapley_vit_tpu_torch.utils.profiling import StepTimer

    work = os.path.join(ROOT, "exp", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)

    def client_run(remat: bool) -> dict:
        """The client driver as a user runs it (default Config: ViT-B/16,
        bf16), 4 steps, with the launch counts of this run alone."""
        cfg = Config()
        cfg.train.remat = remat
        cfg.obs.exp_dir = os.path.join(work, f"exp_{remat}")
        cfg.paths.local_model_path = os.path.join(work, f"local_{remat}")
        losses = []

        class LossLog(logging.Handler):
            def emit(self, record):
                m = re.search(r"\(loss (\S+)\)", record.getMessage())
                if m:
                    losses.append(float(m.group(1)))

        handler = LossLog()
        logging.getLogger("shapley_vit_tpu_torch").addHandler(handler)
        timer = StepTimer()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted:
            fn.launches = 0
        try:
            t0 = time.perf_counter()
            paths = client.run_client(cfg, client_id=0, epochs=1, steps_per_epoch=4,
                                      device="cuda", timer=timer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            logging.getLogger("shapley_vit_tpu_torch").removeHandler(handler)
        launches = {fn.__name__: fn.launches for fn in counted}
        step_s = timer.times("train_step")
        spec = drv.build_model(cfg, device="cpu")[0]
        drop = ingestion.load_client_lora(paths[0], spec)
        b_max = max(float(np.abs(drop["lora"][t]["B"]).max()) for t in ("q", "v"))
        batch = cfg.train.train_batch * 8
        steady = statistics.median(step_s[1:])  # the first step also warms up
        # remat runs each block's forward again in the backward
        want = {"fused_attention": 4 * spec.depth * (2 if remat else 1), "patch_embed": 4,
                "fused_attention_packed": 0, "fused_mlp_block": 0}
        ok = (launches == want and len(losses) == 1 and math.isfinite(losses[0])
              and b_max > 0 and all(math.isfinite(float(a)) for a in
                                    (np.abs(x).max() for x in tm.tree_leaves(drop))))
        return {"remat": remat, "steps": len(step_s), "batch": batch, "loss": losses,
                "step_ms": [1e3 * t for t in step_s], "ms_per_step": 1e3 * steady,
                "images_per_s": batch / steady,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "wall_s": wall,
                "lora_b_max_abs": b_max, "launches": launches, "expected_launches": want,
                "ok": ok, "cfg": cfg, "spec": spec}

    # 1. the client driver, then the same run with per-block remat
    runs = [client_run(remat) for remat in (False, True)]
    cfg, spec, batch = runs[0]["cfg"], runs[0]["spec"], runs[0]["batch"]
    launches = runs[0]["launches"]
    client_ok = all(r["ok"] for r in runs)

    step_profile = profile_train_step(cfg, batch)

    # 2. one float32 step of ViT-B/16, card against CPU from the same weights
    spec32 = tvit.make_spec("base", dtype="float32", **client.TRAIN_SPEC)
    gen = torch.Generator().manual_seed(3)
    base = tvit.init_vit(gen, spec32)
    lora = tvit.init_lora(gen, spec32, classifier_from=base)
    lora = tm.tree_map(lambda a: a + 0.02 * torch.randn(a.shape, generator=gen), lora)
    images = torch.rand((2, spec32.image, spec32.image, spec32.channels), generator=gen)
    labels = torch.tensor([1, 3])

    def loss_and_grads(dev):
        b = tm.tree_map(lambda a: a.to(dev), base)
        lo = tr.trainable(tm.tree_map(lambda a: a.to(dev), lora))
        loss = tr.cross_entropy(tvit.vit_forward(b, lo, images.to(dev), spec32), labels.to(dev))
        leaves = tm.tree_leaves(lo)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), [g.cpu() for g in grads]

    loss_cpu, g_cpu = loss_and_grads("cpu")
    loss_gpu, g_gpu = loss_and_grads("cuda")
    rel = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(g_gpu, g_cpu)]
    step_ok = abs(loss_gpu - loss_cpu) <= 1e-4 and max(rel) <= 1e-3 and math.isfinite(loss_gpu)

    # 3. the demo: three clients trained and scored on the card
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    all_rounds, _, out_dir = run_demo.run_demo(out_dir=os.path.join(work, "demo"), variant="base",
                                               image_size=224, device="cuda")
    torch.cuda.synchronize()
    demo_wall = time.perf_counter() - t0
    demo_launches = {fn.__name__: fn.launches for fn in counted}
    demo_cfg = Config()
    demo_cfg.obs.exp_dir = os.path.join(out_dir, "exp")
    _, eff_err = exact_efficiency(demo_cfg.output_dir, 3)
    sv = [[all_rounds[d][1][c] for c in range(3)] for d in range(2)]
    demo_ok = (eff_err <= 1e-4 and all(math.isfinite(x) for row in sv for x in row)
               and demo_launches["fused_attention"] == 3 * 4 * spec.depth
               and all(n > 0 for n in demo_launches.values()))

    client_rows = [{k: v for k, v in r.items() if k not in ("cfg", "spec")} for r in runs]
    emit({
        "phase": "train", "variant": "base", "dtype": cfg.model.compute_dtype,
        "client": client_rows[0], "client_remat": client_rows[1],
        "step_profile": step_profile,
        "float32_step": {"batch": 2, "loss_cpu": loss_cpu, "loss_gpu": loss_gpu,
                         "max_rel_grad_err": max(rel), "ok": step_ok},
        "demo": {"shapley_value": {"accuracy": sv[0], "loss": sv[1]}, "efficiency_err": eff_err,
                 "wall_s": demo_wall, "launches": demo_launches, "ok": demo_ok},
    })
    if not (client_ok and step_ok and demo_ok):
        raise SystemExit("LoRA training on the card failed its checks")
    return launches


def profile_train_step(cfg, batch: int) -> dict:
    """Device time by kernel family over one training step of the client's
    model and batch (random images), under ``torch.profiler``, after two
    warm-up steps; the idle share is taken against an unprofiled step on
    the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from shapley_vit_tpu_torch.driver import client
    from shapley_vit_tpu_torch.driver import start as drv
    from shapley_vit_tpu_torch.fl import training as tr
    from shapley_vit_tpu_torch.models import vit as tvit

    spec, base, lora = drv.build_model(cfg, device="cuda")
    spec = spec.replace(**client.TRAIN_SPEC)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((batch, spec.image, spec.image, spec.channels), generator=gen, device="cuda")
    y = torch.randint(0, spec.num_classes, (batch,), generator=gen, device="cuda")
    step = tr.make_train_step(lambda b, lo, im: tvit.vit_forward(b, lo, im, spec),
                              spec.num_classes)
    lora = tr.trainable(lora)
    state = tr.adam(5e-3).init(lora)

    def one():
        step(base, lora, state, x, y)
        torch.cuda.synchronize()

    one(), one()
    t0 = time.perf_counter()
    one()
    step_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one()
    rows = device_rows(prof)
    busy = sum(ms for _, ms, _ in rows)
    families = (("fused_attention kernel", ("attention_tc_kernel", "attention_kernel")),
                ("patch_embed kernel", ("patch_embed_kernel",)),
                ("matrix products", ("gemm", "nvjet", "cutlass", "xmma", "sm90")),
                ("softmax", ("softmax",)),
                ("reductions", ("reduce_kernel",)))
    groups = {name: 0.0 for name, _ in families}
    groups["elementwise and copies"] = 0.0
    for key, ms, _ in rows:
        name = next((n for n, keys in families if any(k in key.lower() for k in keys)),
                    "elementwise and copies")
        groups[name] += ms
    return {"batch": batch, "step_ms": step_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / step_ms), "device_ms_by_group": groups,
            "top_kernels": [{"name": k[:100], "device_ms": ms, "calls": n} for k, ms, n in rows[:10]]}


def device_rows(prof) -> list:
    """(kernel name, device ms, calls) of every device-side event of a
    ``torch.profiler`` run (kernels, copies), largest first; a host op's own
    device time would count its kernels a second time."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    return sorted(((e.key, dev_us(e) / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0), key=lambda r: -r[1])


def phase_profile(work: str) -> None:
    """Device time by kernel over one coalition pass of the round (all 7
    coalitions x the 400 validation images, bf16), from ``torch.profiler``;
    the device's idle share is taken against the host-clock time of an
    unprofiled pass (``pass_ms``), since the profiler slows the host. The
    inputs are rebuilt from the same seed, data and drops as the round."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.driver import start as drv
    from shapley_vit_tpu_torch.fl import ingestion
    from shapley_vit_tpu_torch.models.convert import tree_from_numpy
    from shapley_vit_tpu_torch.ops import tree_math as tm
    from shapley_vit_tpu_torch.shapley import powerset

    cfg = Config()
    spec, base, init_lora = drv.build_model(cfg, device="cuda")
    valid = drv.load_validation_dataset(cfg, target_size=spec.image, device="cuda")
    paths = [os.path.join(work, f"client_{i + 1}_model", "ViT_epoch_9.npz") for i in range(3)]
    deltas, _, sizes = ingestion.ingest_clients(paths, init_lora, spec)
    stacked = tree_from_numpy(tm.tree_stack_host(deltas), "cuda")
    W = tm.coalition_weight_matrix(list(powerset(range(3))), sizes, 3)
    backend, eval_coalitions, _ = drv.build_eval_backend(cfg, spec, base, init_lora, device="cuda")
    data = backend.device_batches(valid, cfg.data.eval_batch_size)

    def one_pass():
        return eval_coalitions(init_lora, stacked, W, data, dataset_size=len(valid))

    one_pass()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_pass()  # the pass the idle share is taken against: no profiler overhead
    torch.cuda.synchronize()
    pass_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_pass()
        torch.cuda.synchronize()

    rows = device_rows(prof)
    busy_ms = sum(ms for _, ms, _ in rows)
    groups = {"patch_embed": 0.0, "attention": 0.0, "mlp_block": 0.0, "other": 0.0}
    for key, ms, _ in rows:
        name = next((g for g in ("patch_embed", "attention", "mlp_block") if g + "_" in key), "other")
        groups[name] += ms
    emit({"phase": "profile", "coalitions": int(W.shape[0]), "images": len(valid),
          "pass_ms": pass_ms, "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1.0 - busy_ms / pass_ms),
          "device_ms_by_group": groups,
          "top_kernels": [{"name": k[:120], "device_ms": ms, "calls": n} for k, ms, n in rows[:12]]})
    if busy_ms <= 0:
        raise SystemExit("the profiler recorded no device time")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an NVIDIA GPU",
              file=sys.stderr)
        return 2

    from shapley_vit_tpu_torch.ops import _build
    from shapley_vit_tpu_torch.ops.attention import fused_attention, fused_attention_packed
    from shapley_vit_tpu_torch.ops.mlp_block import fused_mlp_block
    from shapley_vit_tpu_torch.ops.patch_embed import patch_embed

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)

    build_s = _build.build()
    emit({"phase": "build", "seconds": build_s, "kernels": list(_build.KERNELS)})

    summary = phase_kernels(card)
    phase_model()
    launches = phase_round((patch_embed, fused_attention_packed, fused_mlp_block))
    phase_profile(os.path.join(ROOT, "exp", "chip_smoke"))
    counted = (patch_embed, fused_attention_packed, fused_mlp_block, fused_attention)
    launches["fused_attention"] = phase_train(counted)["fused_attention"]

    rows = []
    for name, (source, replaces) in KERNELS.items():
        s = summary[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"],
        })
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
