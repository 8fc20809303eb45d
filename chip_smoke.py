#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``build``   — compiles the three kernel sources of ``shapley_vit_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once; ``attention.cu`` holds four kernels).
2. ``kernels`` — each of the four kernels at its main path's shapes, in
   bfloat16 and float32, against its plain PyTorch version on the same inputs
   (float32: atol/rtol 1e-4, sums over up to 3072 terms in another order;
   bfloat16: atol/rtol 2e-2, outputs rounded to bf16), with CUDA-event times
   (one call per event pair, median of several calls after warm-up) of the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``, in float32 with cuDNN's TF32 off;
   the port never calls it; ``vs_library`` is ``ms / library_ms``; for the
   fused MLP the yardstick is the port's own torch-op MLP half,
   ``models.vit.mlp_half_xla``: LN, two cuBLAS products, GELU, residual,
   which rounds differently and is a yardstick of time only), and
   the least time the card could take (``bound_ms``, by the peak of the
   route that ran: 3xTF32 counts three TF32 products; ``bound_share`` is
   ``bound_ms / ms``). The
   kernel and the library call are also timed back to back
   (``*_back_to_back``: the device's time per call among calls launched
   without waiting, as on the main paths) with the host's time to launch
   one call (``host_us``, ``library_host_us``); ``share_differing`` is the
   share of outputs whose value differs from the plain version's, and a
   bf16 attention row holds it within ``share_bound`` (an error that
   2e-2 passes, such as a few keys of softmax mass too many or too few,
   moves most outputs off their bf16 value); ``route``
   is the kernel that ran, as the wrapper recorded it at the launch (its
   ``route`` attribute), and must be the one ``expected_route`` names:
   ``wgmma`` (the bf16 tensor-core kernels), ``tf32x3`` (the float32 patch
   embedding, fused MLP and attention on the tensor cores; ``tf32x3_wide``
   attention past head dim 128) or ``fma`` (the FMA units). The float32
   patch row has a second yardstick beside ``F.conv2d``, its plain
   version's own products (the ``patchify`` copy and one ``torch.addmm``
   with TF32 off: ``library2_ms``). Each row also has the
   device time of its kernel and of its library call alone, from
   ``torch.profiler`` over calls launched back to back (``device_ms``,
   ``library_device_ms``; ``device_kernels``: the device time of each
   kernel or copy a call ran). The fused MLP is also held with its
   weights one element past an aligned allocation (``*_unaligned``: copied
   by the wrapper, then on the dtype's tensor-core route) and at a hidden
   width of 3,070, which only the ``fma`` kernel takes (``*_fma``). Both
   attention entries are also
   held past the main paths' shapes, at the training batch: N = 257 (256
   px) and 577 (384 px), and head dim 128 (6 heads of 128), bf16 on
   ``wgmma_kl`` (the key-loop tensor-core kernel) and float32 on
   ``tf32x3``, and head dims 192, 256, 384 and 512 (4, 3, 2 and 1 heads),
   bf16 on ``wgmma_wide`` (the key loop in 128-column output panels), and
   576 (1 head), bf16 on ``fma``; float32 past 128 on ``tf32x3_wide`` (Q
   and K streamed in 32-column panels of d), its ``bound_ms`` at the
   3xTF32 rate.
   ``fused_attention``'s and ``patch_embed``'s
   gradients (each an ``autograd.Function``) are held against autograd
   through the plain version on the same inputs, with the same tolerances
   (``grad_check``: every input's gradient, in its dtype, one launch on the
   dtype's route; forward + backward and backward-alone times beside the
   plain version's and the library call's). Each row names the kernel
   that its wrapper counted the launch under (``kernel``, a key of the
   wrapper's ``launches_by``: route, dtype and, for attention, the padded
   head dim and N).
3. ``model``   — ViT-B/16 float32 logits of 8 images (LoRA overlay and two
   merged coalitions) on the card through the kernels (the patch
   embedding, the MLP and attention on ``tf32x3``), against the port on
   the CPU through the plain versions, from the same weights (atol 1e-3).
4. ``round``   — one Shapley round through ``driver.start.start`` with the
   default ``Config`` (ViT-B/16, bf16, merged LoRA, comp-contrib m = 50·n) on
   the synthetic OCT validation set and three client drops written by
   ``save_lora_checkpoint``; the launch counters are zeroed just before and
   read just after, and every kernel of the round must have run, every
   launch of the patch embedding, the MLP and the packed attention on
   ``wgmma`` (the counts by kernel). ``shapley_exact`` over the round's
   persisted utility table checks the efficiency axiom. Then the same round at
   ``compute_dtype="float32"`` (the reference's numerics; its own drops
   and outputs), every launch of the patch embedding, the MLP and the
   packed attention on ``tf32x3`` (the counts by kernel), reported as
   ``round_s_float32``.
5. ``profile`` — device time by kernel, and the device's idle share, over
   one more coalition pass of each round (7 coalitions, 400 images; bf16,
   then float32) under ``torch.profiler``, after the round so it touches
   neither its counts nor its time; by group: each of the port's kernels,
   the matrix products outside them (cuBLAS) and everything else. Every
   kernel of the attention group and of the patch group must be the
   dtype's route's (``attention_hopper_kernel``, ``attention_tf32x3_kernel``;
   ``patch_embed_hopper_kernel``, ``patch_embed_tf32x3_kernel`` and its
   weight split).
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
7. ``variants`` — the tiny (D 192, head dim 64) and micro (D 32, head dim
   16, padded to 64 by the attention wrappers) ViTs on the card, cut to
   depth 2, and ViT-B/16 with 3 heads of 256 at full depth (12) and 224
   px: float32 logits of 4 images against the port on the CPU from the
   same seeded weights (atol 1e-3, as in ``model``); a bf16 forward of
   each (4 images; 128 for ViT-B), finite, with the patch, packed-attention
   and MLP counters advancing (zeroed just before: one patch launch and
   one of each per block) and every packed-attention launch on the
   variant's route (ViT-B at head dim 256: ``wgmma_wide`` in bf16,
   ``tf32x3_wide`` in float32); each of the four kernels at the variant's
   widths (bf16 at the bf16 forward's images, float32 at 4: patch P 16 or
   4, attention heads of 64, 16 or 256, MLP D 192 / 768, 32 / 64 or 768 /
   3072) against its plain version on the same seeded inputs, bf16 on
   ``wgmma`` (attention at head dim 256 on ``wgmma_wide``) and float32 on
   ``tf32x3`` (attention at 256 on ``tf32x3_wide``), with the ``kernels``
   phase's tolerances and, for bf16 attention, its ``share_bound``; each route a literal of
   ``VARIANTS``, as the long attention rows' are of ``LONG_ROUTES``; then ``run_demo()`` at its defaults
   (micro, 16 px) and at tiny / 224 px, each through ``start()``, with the
   efficiency axiom checked as in ``train``.
8. ``int8``    — the dynamic int8 (W8A8) round: ``driver.start.start`` at
   bench.py's spec (ViT-B/16, bf16, tanh GELU, ``quant="int8"`` on
   ``INT8_TARGETS``, merged eval; the MLP half runs as torch ops, since the
   fused MLP kernel bypasses int8) on the round's data and drops, counters
   zeroed just before: patch and packed attention must launch, the fused
   MLP must not, and ``_int_mm`` must run. ``round_s`` is printed beside the
   bf16 round's. Then one coalition pass at this spec under
   ``torch.profiler``, as ``profile`` does. Then ``ops.quant.dynamic_int8_dense`` at each int8 shape
   of the round (q and v per coalition: 25,216 rows x 768 x 768; k and fc1
   over all 176,512 rows: x 768 x 768 and x 768 x 3072), card against the
   same call on the CPU: identical int8 codes, scales and int32 sums, and
   float32 outputs within 1e-6; with the card's times of the int8 product,
   of the whole call and of the bf16 product of the same shape. Then the
   float32 int8 forward of ViT-B/16 (8 images, LoRA overlay and two merged
   coalitions), card against CPU within twice the CPU's own int8-vs-float32
   difference (``int8_forward_check`` says why not the ``model`` phase's
   1e-3).
9. ``serve``   — the continuous service, ``driver.serve.serve``, on two
   epochs of LoRA drops from three clients (default ``Config``: ViT-B/16,
   bf16), counters zeroed just before: two rounds with TensorBoard and the
   per-epoch global export on, plots off; finite SVs, the efficiency axiom
   within 1e-6 per round from each epoch's utility table, the tables,
   ``service_state.json``, the TensorBoard events and both exports on disk,
   and the native inotify watcher in use. Then a recycle: a run with a
   1 MB ``max_rss_mb`` stops after one round (``rss_ceiling``), and
   ``start_epoch="auto"`` resumes at epoch 1; its SVs equal the
   uninterrupted run's within 1e-5. It prints the prewarm seconds, each
   round's ingest seconds (pipelined or not) and its seconds from the
   moment every checkpoint was there to the SVs.
10. ``rounds``  — multi-round FL with per-round Shapley valuation,
   ``driver.rounds.run_federated_rounds`` on ``driver.rounds.build_round_fns``
   (default ``Config``: ViT-B/16, bf16, merged eval; synthetic OCT at scale
   1.0, 400 validation images), counters zeroed just before: three clients
   of 120/300/580 training images, three rounds with participation
   ``[[1,1,1],[1,0,1],[1,1,1]]``, 4 local Adam 5e-3 steps at batch 64 per
   participant and round, a MILP budget of 2, comp-contrib (m = 50·n) on the
   valued rounds; all four kernels must launch. Then each valued round's
   Game again (``driver.rounds.round_game``): exact Shapley values within
   1e-6 of the efficiency axiom, comp-contrib from the round's seed
   reproducing the driver's values within 1e-6 and within 4 standard errors
   (+1e-6) of exact (comp-contrib does not satisfy the axiom itself: its
   gap is printed). Round 1's Game: the non-participant's value exactly
   0.0 under exact and comp-contrib. On the last valued round's Game, after
   exact: Monte-Carlo, Owen, KernelSHAP, Beta Shapley, Banzhaf, GTG, MR and
   TMR score from the cache with no launch. Then
   ``shapley.fed_shapley.compute_utilities_lazy`` over the 3 x 3 stacked
   (round, client) deltas, all 7 subsets in one evaluator call, against a
   sequential reconstruction (each round's FedAvg applied in turn, then
   ``fl.evaluation.evaluate_model`` on the merged forward): mean loss
   within 1e-3, accuracy within 1/200. It prints per-round training,
   evaluation and Shapley seconds, the MILP and GTG host seconds, the
   launches per kernel, peak memory and every check's measured error.
11. ``robust``  — adversarial evaluation, interpretability and the
   Inception-v3 defense (default ``Config``: ViT-B/16, bf16, on the
   training spec ``driver.client.TRAIN_SPEC``, whose patch embedding and
   ``[B, H, N, d]`` attention have a gradient; ``init_lora`` as the overlay;
   the 400 synthetic OCT validation images in batches of 128), counters
   zeroed just before each run. First the patch and ``[B, H, N, d]``
   attention kernels at every batch the phase gives them (128, the
   defended FGSM's 32 and the last batch's 16), bf16 on seeded inputs:
   the forward against the plain version on ``wgmma`` and the gradient by
   ``grad_check``, within the ``kernels`` phase's 2e-2. Then
   ``fl.adversarial.adversarial_evaluation``
   with FGSM at ε = 8/255 (adversarial loss above the clean one; 3
   forwards a batch, so 12 patch and 144 ``fused_attention`` launches and
   none of the packed attention or the fused MLP), PGD-10 from a seeded
   random start (every input the forward sees within ε of its clean batch,
   every iterate in [0, 1]; 48 and 576 launches) and
   ``multi_epsilon_evaluation`` over [0, 2/255, 8/255] (the ε = 0 metrics
   equal the clean ones; clean metrics at the first ε only); one FGSM batch
   under ``torch.profiler`` (host against device-busy time); a float32
   FGSM at batch 2, card against CPU from the same weights (the image
   gradient within 1e-3 of its largest magnitude, the adversarial images
   equal wherever |g| > 1e-3·max|g|). Then ``attention_rollout`` (mean and
   max) and ``grad_cam`` of 4 images: float32 card against CPU within
   1e-3, every attention row summing to 1 within 1e-5; bf16 maps finite,
   in [0, 1], of shape [4, 14, 14]; ``driver.report.saliency_overlays``
   (the device half of ``render_saliency``) writing four image events that
   ``utils.tb_events`` reads back and decodes. Then ``Inception3(4)`` with
   ``Denoise`` at 299 px, He-initialized, float32 with the defense, card
   against CPU within 1e-3 of the largest logit's magnitude (at least 1);
   the paired ``Net`` (finite outputs and losses); FGSM of the ViT through
   a ``Denoise(224, 224)`` front-end on 32 images (finite metrics). It
   prints seconds, metrics and peak memory of each run.

Then, for the rows of the ``kernels`` phase whose kernel (route, dtype,
head dim and N) no main path launched, and for the cases a main path does
not make (unaligned weights, other widths, longer sequences: a case that
is not its wrapper's name), a ``kernels_off_path`` line (each with
``main_path_launches``, 0); the card's name and power limit; the kernels
summary line, a row for each other row of the ``kernels`` phase, ``case``
naming it,
with ``launches`` that kernel's count by kernel over the bf16 and float32
rounds (the patch embedding, packed attention and fused MLP) or over the
train phase's ``run_client`` (``fused_attention``), the counters zeroed
just before each; the script fails unless each wrapper's row at the main
paths' shapes in each round's dtype (``fused_attention``: bf16) is among
them; and as the last line ``{"ok": true, "device": {...}}``. Any failure
exits non-zero before that line; without a CUDA device the script exits non-zero at once.
"""

from __future__ import annotations

import collections
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

# Published peaks (NVIDIA data sheets, dense): matrix rate by dtype (float32
# on the FMA units, "tfloat32" on the tensor cores), memory rate.
_PEAKS = {
    "sxm": {"bfloat16": 989e12, "float32": 67e12, "tfloat32": 495e12, "bytes": 3.35e12},
    "pcie": {"bfloat16": 756e12, "float32": 51e12, "tfloat32": 378e12, "bytes": 2.0e12},
}


def expected_route(dtype: str) -> str:
    """The kernel each wrapper launches for a dtype on the paths chip_smoke
    drives (ViT widths, N <= 224): the bf16 tensor-core kernels; float32 on
    the tensor cores in 3xTF32."""
    return "wgmma" if dtype == "bfloat16" else "tf32x3"


def share_bound(n: int) -> float:
    """The share of n bf16 attention outputs that may differ from the plain
    version's: the main paths' tensor-core kernel's at the round's shape
    (0.22 %) rounded up to 0.25 %, plus four standard deviations of a share
    drawn from n outputs."""
    return 0.0025 + 4 * math.sqrt(0.0025 / n)


def peak_ops(pk: dict, dtype: str, route: str, flops: float) -> float:
    """Seconds the card's peak rate needs for a kernel's ``flops`` on its
    route: 3xTF32 (``tf32x3``, ``tf32x3_wide``) does three TF32 products
    for each float32 one."""
    if route.startswith("tf32x3"):
        return 3 * flops / pk["tfloat32"]
    return flops / pk[dtype]


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


def zero_counts(fns) -> None:
    """Set each wrapper's launch counts to 0: the total (``launches``) and
    the counts by kernel (``launches_by``)."""
    for fn in fns:
        fn.launches = 0
        fn.launches_by.clear()


def counts_by_kernel(fns) -> dict:
    """Each wrapper's launches by kernel since its counts were zeroed."""
    return {fn.__name__: dict(fn.launches_by) for fn in fns}


def peaks(name: str) -> dict:
    return _PEAKS["pcie" if "pcie" in name.lower() else "sxm"]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after warm-up.
    One call per event pair: a short call's time includes the host's time
    to launch it."""
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


def back_to_back(fn, calls: int, runs: int = 3) -> tuple:
    """(device ms, host us) of one ``fn()`` among ``calls`` calls launched
    back to back: CUDA events around the calls, and the host clock around
    their launch (before waiting for the card), each over ``calls``; the
    median of ``runs`` runs after a warm-up call. The host launches the next
    call while the card runs the last, as on the main paths."""
    import torch

    fn()
    dev, host = [], []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b) / calls)
        host.append(1e6 * (t1 - t0) / calls)
    return statistics.median(dev), statistics.median(host)


def device_ms(fn, calls: int) -> tuple:
    """Device time of one ``fn()`` among ``calls`` calls launched back to
    back, from ``torch.profiler`` after a warm-up call: the sum of every
    kernel's and copy's device time over ``calls``, without the gaps
    between them that ``back_to_back`` counts; and that time by kernel
    (ms a call, name cut to 80 characters), largest first. A trace that
    holds no device event is taken again; after three such, (None, {})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows:
            return (sum(ms for _, ms, _ in rows) / calls,
                    {key[:80]: ms / calls for key, ms, _ in rows[:4]})
    return None, {}


# The kernels phase's shapes: the round's (128 images of 224 px, 16 px
# patches, ViT-B widths, 7 coalitions of 128 images a batch) and the
# client's training batch.
IMAGES, IMG, P, CH, D, HEADS, HID = 128, 224, 16, 3, 768, 12, 3072
NP, N = (IMG // P) ** 2, (IMG // P) ** 2 + 1
CB = 7 * IMAGES                  # 7 coalitions x 128 images
M = CB * N                       # tokens of one coalition batch
TB = 64                          # the client's training batch


def kernel_inputs(gen, dtype) -> dict:
    """The kernels phase's inputs in one dtype, drawn from ``gen`` (a CUDA
    generator) in a fixed order. ``tools/torch_attention_ab.py`` draws the
    bf16 ones from seed 0 as this script does."""
    import torch

    def randn(shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

    t = {"img": randn((IMAGES, IMG, IMG, CH)), "pw": randn((P * P * CH, D), 0.05),
         "pb": randn((D,), 0.1)}
    t["q"], t["k"], t["v"] = (randn((CB, N, HEADS * 64)) for _ in range(3))
    t["x"] = randn((M, D))
    t["ls"], t["lb"] = (1 + randn((D,), 0.1, torch.float32)).to(dtype), randn((D,), 0.1)
    t["w1"], t["b1"] = randn((D, HID), 0.03), randn((HID,), 0.1)
    t["w2"], t["b2"] = randn((HID, D), 0.03), randn((D,), 0.1)
    # the training path's q, k, v, packed; the kernel reads their head split
    t["tq"], t["tk"], t["tv"] = (randn((TB, N, HEADS * 64)) for _ in range(3))
    return t


def phase_kernels(card: str) -> dict:
    """Every kernel at the round's shapes, both dtypes, and the other
    routes' rows. Returns each row by (case, dtype), for the summary line;
    a main path's row has its wrapper's name as its case."""
    import torch
    import torch.nn.functional as F

    from shapley_vit_tpu_torch.models import vit as tvit
    from shapley_vit_tpu_torch.ops import attention as att
    from shapley_vit_tpu_torch.ops import mlp_block as mlp
    from shapley_vit_tpu_torch.ops import patch_embed as pe

    pk = peaks(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H = IMAGES, HEADS
    summary = {}
    results = []
    grads = []
    # the float32 yardsticks run in float32: cuDNN takes F.conv2d to TF32 by
    # default, and the port's float32 kernels keep float32
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        isz = torch.finfo(dtype).bits // 8
        tol = dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else dict(atol=1e-4, rtol=1e-4)
        cases = {}
        inp = kernel_inputs(gen, dtype)

        img, pw, pb = inp["img"], inp["pw"], inp["pb"]
        conv_w = conv_weight(pw, P, CH)
        img_nchw = img.permute(0, 3, 1, 2)
        cases["patch_embed"] = dict(
            kernel=lambda: pe.patch_embed(img, pw, pb, P),
            plain=lambda: pe.patch_embed_plain(img, pw, pb, P),
            library=lambda: F.conv2d(img_nchw, conv_w, pb, stride=P), library_name="F.conv2d",
            flops=2.0 * B * NP * (P * P * CH) * D,
            bytes=(img.numel() + pw.numel() + pb.numel() + B * NP * D) * isz,
            reps=20,
        )
        if dtype == torch.float32:
            # the plain version's own products: one cuBLAS SGEMM (with the
            # bias) after the patchify copy
            cases["patch_embed"].update(
                library2=lambda: torch.addmm(pb, pe.patchify(img, P).reshape(-1, P * P * CH), pw),
                library2_name="patchify + torch.addmm (cuBLAS, TF32 off)")

        q, k, v = inp["q"], inp["k"], inp["v"]
        qh, kh, vh = (t.view(CB, N, H, 64).transpose(1, 2) for t in (q, k, v))
        cases["fused_attention_packed"] = dict(
            kernel=lambda: att.fused_attention_packed(q, k, v, heads=H),
            plain=lambda: att.fused_attention_packed_plain(q, k, v, heads=H),
            library=lambda: F.scaled_dot_product_attention(qh, kh, vh),
            library_name="F.scaled_dot_product_attention",
            flops=4.0 * CB * H * N * N * 64,
            bytes=4 * q.numel() * isz,
            reps=5,
        )

        mlp_args = tuple(inp[n] for n in ("x", "ls", "lb", "w1", "b1", "w2", "b2"))
        mlp_spec = tvit.make_spec("base", dtype=dname)  # erf GELU in float32, eps 1e-12
        mlp_blk = {"ln2": {"scale": inp["ls"], "bias": inp["lb"]},
                   "mlp": {"fc1": {"kernel": inp["w1"], "bias": inp["b1"]},
                           "fc2": {"kernel": inp["w2"], "bias": inp["b2"]}}}
        mlp_case = dict(
            plain=lambda: mlp.fused_mlp_block_plain(*mlp_args, eps=1e-12),
            library=lambda: tvit.mlp_half_xla(inp["x"], mlp_blk, mlp_spec),
            library_name="models.vit.mlp_half_xla (torch ops: LN, cuBLAS fc1, GELU, cuBLAS fc2, residual)",
            flops=4.0 * M * D * HID,
            bytes=(2 * M * D + 2 * D * HID + HID + 3 * D) * isz,
            reps=3,
        )
        cases["fused_mlp_block"] = dict(
            mlp_case, kernel=lambda: mlp.fused_mlp_block(*mlp_args, eps=1e-12))
        # the same weights one element past an aligned allocation, which the
        # TMA cannot read: the wrapper copies them, and the route stays
        w1u, w2u = unaligned(inp["w1"]), unaligned(inp["w2"])
        cases["fused_mlp_block_unaligned"] = dict(
            mlp_case, wrapper="fused_mlp_block",
            kernel=lambda: mlp.fused_mlp_block(*mlp_args[:3], w1u, mlp_args[4], w2u, mlp_args[6],
                                               eps=1e-12))
        # the FMA kernel, which takes the hidden widths that are not a
        # multiple of 8 (bf16) or 4 (float32): 3,070
        hf = HID - 2
        fma_args = (*mlp_args[:3], inp["w1"][:, :hf].contiguous(), inp["b1"][:hf], inp["w2"][:hf],
                    mlp_args[6])
        fma_blk = {"ln2": mlp_blk["ln2"],
                   "mlp": {"fc1": {"kernel": fma_args[3], "bias": fma_args[4]},
                           "fc2": {"kernel": fma_args[5], "bias": fma_args[6]}}}
        cases["fused_mlp_block_fma"] = dict(
            mlp_case, wrapper="fused_mlp_block", route="fma", reps=1, shape=[M, D, hf],
            kernel=lambda: mlp.fused_mlp_block(*fma_args, eps=1e-12),
            plain=lambda: mlp.fused_mlp_block_plain(*fma_args, eps=1e-12),
            library=lambda: tvit.mlp_half_xla(inp["x"], fma_blk, mlp_spec),
            flops=4.0 * M * D * hf, bytes=(2 * M * D + 2 * D * hf + hf + 3 * D) * isz)

        # the training path's [B, H, N, d] views of packed projections
        tq, tk, tv = inp["tq"], inp["tk"], inp["tv"]
        tqh, tkh, tvh = (t.view(TB, N, H, 64).transpose(1, 2) for t in (tq, tk, tv))
        cases["fused_attention"] = dict(
            kernel=lambda: att.fused_attention(tqh, tkh, tvh),
            plain=lambda: att.fused_attention_plain(tqh, tkh, tvh),
            library=lambda: F.scaled_dot_product_attention(tqh, tkh, tvh),
            library_name="F.scaled_dot_product_attention",
            flops=4.0 * TB * H * N * N * 64,
            bytes=4 * tq.numel() * isz,
            reps=10,
        )
        grads += kernel_grad_checks(dtype, tol, img, pw, pb, tqh, tkh, tvh)
        cases.update(long_attention_cases(gen, dtype, isz))

        wrappers = {"patch_embed": pe.patch_embed, "fused_attention_packed": att.fused_attention_packed,
                    "fused_mlp_block": mlp.fused_mlp_block, "fused_attention": att.fused_attention}
        for key, c in cases.items():
            name = c.get("wrapper", key)
            shape = c.get("shape")
            launched, by = wrappers[name].launches, dict(wrappers[name].launches_by)
            got = c["kernel"]()
            route = wrappers[name].route
            counted_as = [k for k, n in wrappers[name].launches_by.items() if n != by.get(k, 0)]
            one_launch = wrappers[name].launches == launched + 1 and len(counted_as) == 1
            want = c["plain"]()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            differing = (got != want).float().mean().item()
            ok = (torch.allclose(got.float(), want.float(), **tol) and one_launch
                  and route == c.get("route", expected_route(dname))
                  and (dtype != torch.bfloat16 or "attention" not in name
                       or differing <= share_bound(got.numel())))
            del got, want
            t_ops = peak_ops(pk, dname, route, c["flops"])
            t_bytes = c["bytes"] / pk["bytes"]
            ms = cuda_ms(c["kernel"], c["reps"])
            ms_b2b, host_us = back_to_back(c["kernel"], 5 * c["reps"])
            library_ms = library_b2b = library_host_us = None
            if c["library"]:
                library_ms = cuda_ms(c["library"], c["reps"])
                library_b2b, library_host_us = back_to_back(c["library"], 5 * c["reps"])
            dev_ms, dev_kernels = device_ms(c["kernel"], 2 * c["reps"])
            library2 = {}
            if "library2" in c:
                library2 = {"library2": c["library2_name"],
                            "library2_ms": cuda_ms(c["library2"], c["reps"]),
                            "library2_ms_back_to_back": back_to_back(c["library2"], 5 * c["reps"])[0],
                            "library2_device_ms": device_ms(c["library2"], 2 * c["reps"])[0]}
            bound_ms = 1e3 * max(t_ops, t_bytes)
            row = {
                "name": name, "case": key, "dtype": dname, "route": route,
                "kernel": counted_as[0] if one_launch else None, "library": c["library_name"],
                **({"shape": shape} if shape else {}),
                "max_abs_err": err, "share_differing": differing,
                "ok": ok, "ms": ms, "plain_ms": cuda_ms(c["plain"], c["reps"]),
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "bound_share": bound_ms / ms, "vs_library": ms / library_ms if library_ms else None,
                "ms_back_to_back": ms_b2b, "library_ms_back_to_back": library_b2b,
                "vs_library_back_to_back": ms_b2b / library_b2b if library_b2b else None,
                "host_us": host_us, "library_host_us": library_host_us,
                "device_ms": dev_ms, "device_kernels": dev_kernels,
                "library_device_ms": device_ms(c["library"], 2 * c["reps"])[0] if c["library"] else None,
                **library2,
                "launches": wrappers[name].launches - launched,  # this phase's, not the round's
            }
            results.append(row)
            summary[key, dname] = row
            torch.cuda.empty_cache()
        del (cases, mlp_case, inp, img, pw, pb, q, k, v, qh, kh, vh, mlp_args, mlp_blk, tq, tk, tv, tqh,
             tkh, tvh, w1u, w2u, fma_args, fma_blk)
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    emit({"phase": "kernels", "card": card, "cudnn_allow_tf32": False, "cuda_matmul_allow_tf32": False,
          "results": results, "gradients": grads})
    bad = [r for r in results + grads if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    for dname in ("bfloat16", "float32"):
        summary["patch_embed", dname]["backward_ms"] = next(
            g["backward_ms"] for g in grads if g["name"] == "patch_embed.backward"
            and g["dtype"] == dname)
    return summary


# Attention past the main paths' shapes, at the training batch: 256 px and
# 384 px ViT-B (N = 257, 577), ViT-B's 768 columns as 6 heads of 128, 4 of
# 192, 3 of 256 and 2 of 384, and one head of 512 and one of 576 (case:
# (N, heads, head dim))
LONG_ATTENTION = {"n257": (257, 12, 64), "n577": (577, 12, 64), "d128": (N, 6, 128),
                  "d192": (N, 4, 192), "d256": (N, 3, 256), "d384": (N, 2, 384), "d512": (N, 1, 512),
                  "d576": (N, 1, 576)}
# The route each of them must take, by dtype: bf16 past the main paths' 224
# keys and head dim 64 up to 128 on the key-loop tensor-core kernel, from
# 192 to 512 on the wide one, past 512 on the FMA kernel; float32 on
# 3xTF32 up to 128, on the float32 wide tensor-core kernel past it.
LONG_ROUTES = {"n257": ("wgmma_kl", "tf32x3"), "n577": ("wgmma_kl", "tf32x3"),
               "d128": ("wgmma_kl", "tf32x3"), "d192": ("wgmma_wide", "tf32x3_wide"),
               "d256": ("wgmma_wide", "tf32x3_wide"), "d384": ("wgmma_wide", "tf32x3_wide"),
               "d512": ("wgmma_wide", "tf32x3_wide"), "d576": ("fma", "tf32x3_wide")}


def long_attention_cases(gen, dtype, isz: int) -> dict:
    """``kernels`` cases of both attention entries at ``LONG_ATTENTION``'s
    shapes, each held to the route ``LONG_ROUTES`` names for it."""
    import torch
    import torch.nn.functional as F

    from shapley_vit_tpu_torch.ops import attention as att

    cases = {}
    for tag, (n, h, d) in LONG_ATTENTION.items():
        route = LONG_ROUTES[tag][dtype != torch.bfloat16]
        q, k, v = ((torch.randn((TB, n, h * d), generator=gen, device="cuda")).to(dtype)
                   for _ in range(3))
        qh, kh, vh = (t.view(TB, n, h, d).transpose(1, 2) for t in (q, k, v))
        common = dict(route=route, reps=3, flops=4.0 * TB * h * n * n * d, bytes=4 * q.numel() * isz,
                      library=lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(qh, kh, vh),
                      library_name="F.scaled_dot_product_attention", shape=[TB, h, n, d])
        cases[f"fused_attention_packed_{tag}"] = dict(
            common, wrapper="fused_attention_packed",
            kernel=lambda q=q, k=k, v=v, h=h: att.fused_attention_packed(q, k, v, heads=h),
            plain=lambda q=q, k=k, v=v, h=h: att.fused_attention_packed_plain(q, k, v, heads=h))
        cases[f"fused_attention_{tag}"] = dict(
            common, wrapper="fused_attention",
            kernel=lambda qh=qh, kh=kh, vh=vh: att.fused_attention(qh, kh, vh),
            plain=lambda qh=qh, kh=kh, vh=vh: att.fused_attention_plain(qh, kh, vh))
    return cases


def unaligned(t):
    """A contiguous copy of ``t`` one element past an aligned allocation."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def grad_check(wrapper, kernel, plain, library, args, dtype, tol, seed: int) -> dict:
    """``wrapper``'s gradient (its ``autograd.Function``: the kernel
    forward, a torch-op backward) for every input in ``args`` against
    autograd through the plain version, on the same inputs and a seeded
    cotangent. ``ok`` only when every gradient agrees within ``tol`` and
    keeps its input's dtype, and the forward launched the kernel once on
    the dtype's route. Times (CUDA events): forward + backward, and the
    backward alone (the graph kept and run again), of the wrapper, of the
    plain version and of ``library`` (a PyTorch call for the same function,
    with its own inputs)."""
    import torch

    lib_fn, lib_args = library

    def graph(fn, inputs):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        return fn(*leaves), leaves

    def fwd_bwd(fn, inputs):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        return lambda: torch.autograd.grad(fn(*leaves), leaves, cot)

    def backward(fn, inputs):
        out, leaves = graph(fn, inputs)
        return lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)

    launched = wrapper.launches
    out, leaves = graph(kernel, args)
    route = wrapper.route
    cot = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(seed),
                      device="cuda").to(dtype)
    got = torch.autograd.grad(out, leaves, cot)
    want = torch.autograd.grad(*graph(plain, args), cot)
    torch.cuda.synchronize()
    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
    ok = (all(torch.allclose(a.float(), b.float(), **tol) for a, b in zip(got, want))
          and all(g.dtype == t.dtype for g, t in zip(got, args))
          and wrapper.launches == launched + 1
          and route == expected_route(str(dtype).replace("torch.", "")))
    del out, leaves, got, want
    return {"name": f"{wrapper.__name__}.backward", "dtype": str(dtype).replace("torch.", ""),
            "shape": list(args[0].shape), "route": route, "max_abs_err": errs,
            "fwd_bwd_ms": cuda_ms(fwd_bwd(kernel, args), 10),
            "plain_fwd_bwd_ms": cuda_ms(fwd_bwd(plain, args), 10),
            "library_fwd_bwd_ms": cuda_ms(fwd_bwd(lib_fn, lib_args), 10),
            "backward_ms": cuda_ms(backward(kernel, args), 10),
            "plain_backward_ms": cuda_ms(backward(plain, args), 10),
            "library_backward_ms": cuda_ms(backward(lib_fn, lib_args), 10),
            "ok": ok}


def patch_conv(P_: int):
    """``F.conv2d`` on ``patch_embed``'s NHWC images, with the [D, C, P, P]
    form of its kernel: the library's function for the same output."""
    import torch.nn.functional as F

    def conv(x, w, b):
        return F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=P_).flatten(2).transpose(1, 2)

    return conv


def conv_weight(pw, P_: int, C: int):
    return pw.reshape(P_, P_, C, pw.shape[1]).permute(3, 2, 0, 1).contiguous()


def kernel_grad_checks(dtype, tol, img, pw, pb, qh, kh, vh) -> list:
    """:func:`grad_check` of ``fused_attention`` on [B, H, N, d] views and of
    ``patch_embed`` (images, kernel, bias), each beside its library call
    (SDPA; ``F.conv2d``)."""
    import torch.nn.functional as F

    from shapley_vit_tpu_torch.ops import attention as att
    from shapley_vit_tpu_torch.ops import patch_embed as pe

    return [
        grad_check(att.fused_attention, att.fused_attention, att.fused_attention_plain,
                   (F.scaled_dot_product_attention, (qh, kh, vh)), (qh, kh, vh), dtype, tol, 1),
        grad_check(pe.patch_embed, lambda *a: pe.patch_embed(*a, P),
                   lambda *a: pe.patch_embed_plain(*a, P),
                   (patch_conv(P), (img, conv_weight(pw, P, CH), pb)), (img, pw, pb), dtype, tol, 2),
    ]


def phase_model() -> None:
    """ViT-B/16 float32 logits: kernels on the card vs plain versions on the CPU."""
    import torch

    from shapley_vit_tpu_torch.models import vit as tvit
    from shapley_vit_tpu_torch.ops import tree_math as tm
    from shapley_vit_tpu_torch.ops.attention import fused_attention_packed
    from shapley_vit_tpu_torch.ops.mlp_block import fused_mlp_block
    from shapley_vit_tpu_torch.ops.patch_embed import patch_embed

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
    routes = {"patch_route": patch_embed.route, "mlp_route": fused_mlp_block.route,
              "attention_route": fused_attention_packed.route}
    ok = (bool(torch.isfinite(gpu).all()) and err <= 1e-3
          and all(r == expected_route("float32") for r in routes.values()))
    emit({"phase": "model", "variant": "base", "dtype": "float32", "images": 8,
          "logits_shape": list(gpu.shape), "max_abs_err_vs_cpu": err, "atol": 1e-3,
          **routes, "ok": ok})
    if not ok:
        raise SystemExit("ViT-B logits on the card disagree with the CPU")


def _metric(path: str, tag: str) -> float:
    with open(path, newline="") as f:
        rows = [r for r in csv.DictReader(f) if r["tag"] == tag]
    return float(rows[-1]["value"])


def exact_efficiency(output_dir: str, n: int, table_name: str = "utility_table.npz"):
    """Exact Shapley values from a round's persisted utility table, and how
    far their sum is from the grand coalition's utility (the efficiency
    axiom), the worse of the two utility dimensions."""
    from shapley_vit_tpu_torch.fl import checkpoint as ckpt
    from shapley_vit_tpu_torch.shapley import Game, shapley_exact

    table, _ = ckpt.load_utility_table(os.path.join(output_dir, table_name))

    def never(W):
        raise RuntimeError("coalition missing from the round's utility table")

    game = Game(never, [1] * n, [True] * n, [0.0, 0.0], utility_dim=2, n_all=n)
    game.utility.update({k: list(v) for k, v in table.items()})
    exact = shapley_exact(game)
    grand = table[frozenset(range(n))]
    return exact, max(abs(sum(exact[d].values()) - grand[d]) for d in range(2))


def phase_round(counted, dtype: str = "bfloat16", route: str | None = None) -> tuple:
    """One Shapley round through the port's entry point at ``dtype`` (the
    default ``Config``'s bf16, or float32, the reference's numerics); returns
    each kernel's launches by kernel during the round (``counts_by_kernel``),
    and the round's seconds. ``route``: the route every launch of each
    wrapper in ``counted`` (the patch embedding, the fused MLP, the packed
    attention) must take (None: any). The float32 round's drops and outputs
    go to their own directory."""
    import numpy as np
    import torch

    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.driver import start as drv
    from shapley_vit_tpu_torch.fl import ingestion
    from shapley_vit_tpu_torch.models.convert import tree_to_numpy
    from shapley_vit_tpu_torch.ops import tree_math as tm

    cfg = Config()  # ViT-B/16, bf16, exact_f32 GELU, merged, comp-contrib
    cfg.model.compute_dtype = dtype
    work = round_dir(dtype)
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

    zero_counts(counted)
    t0 = time.perf_counter()
    all_rounds, _ = drv.start(cfg, checkpoint_paths=paths, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    by_kernel = counts_by_kernel(counted)
    # every launch on the route asked for: a key of launches_by starts with its route
    routes_ok = route is None or all(key.split()[0] == route for fn in counted
                                     for key in by_kernel[fn.__name__])

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
        and routes_ok
    )
    emit({
        "phase": "round", "variant": "base", "dtype": cfg.model.compute_dtype,
        f"round_s_{dtype}": round_s, "route": route, "routes_ok": routes_ok,
        "eval_mode": cfg.model.eval_mode, "clients": 3, "validation_images": valid_n,
        "batches": math.ceil(valid_n / cfg.data.eval_batch_size),
        "shapley_value": {"accuracy": sv[0], "loss": sv[1]},
        "exact_shapley_value": {"accuracy": [exact[0][c] for c in range(3)],
                                "loss": [exact[1][c] for c in range(3)]},
        "efficiency_err": eff_err, "round_s": round_s, "wall_s": wall,
        "coalition_evals": evals, "coalition_evals_per_s": evals / round_s,
        "launches": launches, "launches_by_kernel": by_kernel, "ok": ok,
    })
    if not ok:
        raise SystemExit("the Shapley round failed its checks")
    return by_kernel, round_s


def round_dir(dtype: str) -> str:
    """Where the round at ``dtype`` writes its drops and outputs."""
    return os.path.join(ROOT, "exp", "chip_smoke" if dtype == "bfloat16" else f"chip_smoke_{dtype}")


def phase_train(counted) -> dict:
    """LoRA client training on the card; returns each kernel's launches by
    kernel during ``run_client`` (``counts_by_kernel``)."""
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
        zero_counts(counted)
        try:
            t0 = time.perf_counter()
            paths = client.run_client(cfg, client_id=0, epochs=1, steps_per_epoch=4,
                                      device="cuda", timer=timer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            logging.getLogger("shapley_vit_tpu_torch").removeHandler(handler)
        launches = {fn.__name__: fn.launches for fn in counted}
        by_kernel = counts_by_kernel(counted)
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
                "lora_b_max_abs": b_max, "launches": launches, "launches_by_kernel": by_kernel,
                "expected_launches": want, "ok": ok, "cfg": cfg, "spec": spec}

    # 1. the client driver, then the same run with per-block remat
    runs = [client_run(remat) for remat in (False, True)]
    cfg, spec, batch = runs[0]["cfg"], runs[0]["spec"], runs[0]["batch"]
    by_kernel = runs[0]["launches_by_kernel"]
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
    zero_counts(counted)
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
    return by_kernel


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
    families = (("fused_attention kernel", ("attention_hopper_kernel", "attention_tf32x3_kernel",
                                            "attention_kernel")),
                ("patch_embed kernel", ("patch_embed_hopper_kernel", "patch_embed_tf32x3_kernel",
                                        "patch_embed_split_kernel")),
                ("matrix products", PRODUCT_KERNELS),
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


# kernel names of the matrix products outside the port's kernels (cuBLAS,
# cuBLASLt, CUTLASS); a profiled pass's "matrix_products" group
PRODUCT_KERNELS = ("gemm", "nvjet", "cutlass", "sm90", "xmma")


def phase_profile(work: str, int8: bool = False, dtype: str = "bfloat16",
                  mlp_kernel: str | None = "mlp_block_gemm_kernel",
                  attention_kernel: str | None = None, patch_kernels: tuple = ()) -> None:
    """Device time by kernel over one coalition pass of the round (all 7
    coalitions x the 400 validation images, at ``dtype``), from
    ``torch.profiler``; the device's idle share is taken against the
    host-clock time of an unprofiled pass (``pass_ms``), since the profiler
    slows the host. The inputs are rebuilt from the same seed, data and
    drops as the round; ``int8`` profiles the ``int8`` phase's spec
    instead. ``mlp_kernel``: the fused MLP's GEMM kernel that must run in
    the pass (never under ``int8``, which bypasses it; None: no check);
    ``attention_kernel``: the attention kernel that must run in it, and be
    the only one of the attention group (None: no check); ``patch_kernels``:
    the kernels the patch group must hold, the first of them the one that
    must run (empty: no check). Groups: the port's kernels by family, the matrix products
    outside them (``PRODUCT_KERNELS``: q/k/v/out, the classifier, int8's
    ``_int_mm``) and everything else (elementwise, copies, reductions)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.driver import start as drv
    from shapley_vit_tpu_torch.fl import ingestion
    from shapley_vit_tpu_torch.models.convert import tree_from_numpy
    from shapley_vit_tpu_torch.ops import tree_math as tm
    from shapley_vit_tpu_torch.shapley import powerset

    cfg = Config()
    cfg.model.compute_dtype = dtype
    if int8:
        cfg.model.gelu, cfg.model.quant = "tanh", "int8"
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
    groups = {"patch_embed": 0.0, "attention": 0.0, "mlp_block": 0.0, "matrix_products": 0.0,
              "other": 0.0}
    members = {g: [] for g in groups}
    for key, ms, n in rows:
        name = next((g for g in ("patch_embed", "attention", "mlp_block") if g + "_" in key), None)
        if name is None:
            name = "matrix_products" if any(k in key.lower() for k in PRODUCT_KERNELS) else "other"
        groups[name] += ms
        if name != "other":
            members[name].append({"name": key[:120], "device_ms": ms, "calls": n})
    emit({"phase": "profile", "dtype": dtype, "quant": cfg.model.quant, "coalitions": int(W.shape[0]),
          "images": len(valid),
          "pass_ms": pass_ms, "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1.0 - busy_ms / pass_ms),
          "device_ms_by_group": groups,
          "kernels_by_group": {g: members[g] for g in ("patch_embed", "attention", "mlp_block",
                                                       "matrix_products")},
          "top_kernels": [{"name": k[:120], "device_ms": ms, "calls": n} for k, ms, n in rows[:12]]})
    if busy_ms <= 0:
        raise SystemExit("the profiler recorded no device time")
    if mlp_kernel and int8 == any(mlp_kernel in k["name"] for k in members["mlp_block"]):
        raise SystemExit("the profiled pass ran the fused MLP kernel where it should not, "
                         "or not where it should")
    if attention_kernel and not (members["attention"] and all(
            attention_kernel in k["name"] for k in members["attention"])):
        raise SystemExit(f"the profiled pass's attention did not run on {attention_kernel} alone")
    if patch_kernels and not (any(patch_kernels[0] in k["name"] for k in members["patch_embed"]) and all(
            any(p in k["name"] for p in patch_kernels) for k in members["patch_embed"])):
        raise SystemExit(f"the profiled pass's patch embedding ran other kernels than {patch_kernels}")


INT8_SHAPES = {  # the round's int8 products: (rows, K, N, kernel dtype)
    "q_v_per_coalition": (IMAGES * N, D, D, "bfloat16"),
    "k": (CB * N, D, D, "float32"),
    "fc1": (CB * N, D, HID, "float32"),
}


def int8_product_rows() -> list:
    """``dynamic_int8_dense`` at each int8 shape of the round, card against
    the same call on the CPU, from the same seeded inputs: the activations
    in bf16 (the round's compute dtype), q/v's merged kernels in bf16, k and
    fc1's shared kernels in their float32 base."""
    import torch

    from shapley_vit_tpu_torch.ops import quant

    rows = []
    for name, (m, k, n, wdt) in INT8_SHAPES.items():
        gen = torch.Generator().manual_seed(m + n)
        x = torch.randn((m, k), generator=gen).to(torch.bfloat16)
        w = (0.03 * torch.randn((k, n), generator=gen)).to(getattr(torch, wdt))
        b = 0.1 * torch.randn((n,), generator=gen)
        xg, wg, bg = x.cuda(), w.cuda(), b.cuda()
        (xq, sx), (wq, sw) = quant.quantize_symmetric(x, -1), quant.quantize_symmetric(w, 0)
        (xqg, sxg), (wqg, swg) = quant.quantize_symmetric(xg, -1), quant.quantize_symmetric(wg, 0)
        codes_equal = (torch.equal(xqg.cpu(), xq) and torch.equal(wqg.cpu(), wq)
                       and torch.equal(sxg.cpu(), sx) and torch.equal(swg.cpu(), sw))
        acc_equal = torch.equal(quant.int8_matmul(xqg, wqg).cpu(), quant.int8_matmul(xq, wq))
        got = quant.dynamic_int8_dense(xg, wg, bg, out_dtype=torch.float32)
        want = quant.dynamic_int8_dense(x, w, b, out_dtype=torch.float32)
        err = (got.cpu() - want).abs().max().item()
        del got, want
        wb = wg.to(torch.bfloat16)
        row = {"name": name, "rows": m, "k": k, "n": n, "kernel_dtype": wdt,
               "codes_and_scales_equal": codes_equal, "int32_sums_equal": acc_equal,
               "max_abs_err": err, "atol": 1e-6,
               "int8_matmul_ms": cuda_ms(lambda: quant.int8_matmul(xqg, wqg), 5),
               "dynamic_int8_dense_ms": cuda_ms(lambda: quant.dynamic_int8_dense(xg, wg, bg), 5),
               "bf16_matmul_ms": cuda_ms(lambda: xg @ wb, 5)}
        row["ok"] = codes_equal and acc_equal and err <= 1e-6
        rows.append(row)
        del x, w, b, xg, wg, bg, xq, wq, xqg, wqg, wb
        torch.cuda.empty_cache()
    return rows


def int8_forward_check() -> dict:
    """The float32 int8 ViT-B/16 forward (the ``model`` phase's inputs: 8
    images, a LoRA overlay and two merged coalitions), card against CPU.

    The bar is the scheme's own error, not the ``model`` phase's 1e-3: the
    two devices' float32 sums differ in their last bits, a value near a
    rounding boundary gets the neighbouring int8 code on one of them, and
    the flip moves later activations by a code step, which flips more codes
    downstream. So two exact implementations differ by the int8 rounding
    noise itself. The check: the card's logits within twice the CPU's own
    int8-vs-float32 difference on the same inputs, with the CPU's
    sensitivity beside it (its int8 logits again from images perturbed by
    one part in 1e7, against the float32 logits' move)."""
    import torch

    from shapley_vit_tpu_torch.models import vit as tvit
    from shapley_vit_tpu_torch.ops import tree_math as tm

    spec = tvit.make_spec("base", dtype="float32", gelu="tanh", quant="int8",
                          quant_targets=tvit.INT8_TARGETS, mlp_impl="xla")
    gen = torch.Generator().manual_seed(1)
    base = tvit.init_vit(gen, spec)
    lora = tvit.init_lora(gen, spec, classifier_from=base)
    lora = tm.tree_map(lambda a: a + 0.02 * torch.randn(a.shape, generator=gen), lora)
    deltas = tm.tree_map(lambda a: 0.02 * torch.randn((2, *a.shape), generator=gen), lora)
    images = torch.rand((8, spec.image, spec.image, spec.channels), generator=gen)
    nudged = images * (1 + 1e-7 * torch.randn(images.shape, generator=gen))
    W = torch.tensor([[0.3, 0.7], [1.0, 0.0]])

    def logits(dev, sp=spec, imgs=images):
        b = tm.tree_map(lambda a: a.to(dev), base)
        lo = tm.tree_map(lambda a: a.to(dev), lora)
        de = tm.tree_map(lambda a: a.to(dev), deltas)
        x = imgs.to(dev)
        with torch.inference_mode():
            one = tvit.vit_forward(b, lo, x, sp)
            merged = tvit.merge_coalition_weights(b, tm.materialize_coalitions(lo, de, W), sp)
            many = tvit.vit_forward_merged(b, merged, x, sp)
        return torch.cat([one[None], many]).cpu()

    def diff(a, b):
        return (a - b).abs().max().item()

    f32 = spec.replace(quant="none")
    cpu, gpu, cpu_f32 = logits("cpu"), logits("cuda"), logits("cpu", f32)
    err, int8_err = diff(gpu, cpu), diff(cpu, cpu_f32)
    agree = (gpu.argmax(-1) == cpu.argmax(-1)).float().mean().item()
    return {"dtype": "float32", "images": 8, "logits_shape": list(gpu.shape),
            "max_abs_err_vs_cpu": err, "cpu_int8_vs_float32": int8_err,
            "bar": 2 * int8_err, "argmax_agreement": agree,
            "cpu_sensitivity_1e-7": {"int8": diff(logits("cpu", imgs=nudged), cpu),
                                     "float32": diff(logits("cpu", f32, nudged), cpu_f32)},
            "logit_spread": (cpu.max() - cpu.min()).item(),
            "ok": bool(torch.isfinite(gpu).all()) and err <= 2 * int8_err}


def phase_int8(counted, bf16_round_s: float) -> None:
    """The int8 round through ``start()``, the int8 products card vs CPU,
    and the float32 int8 ViT-B forward card vs CPU."""
    import torch

    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.driver import start as drv
    from shapley_vit_tpu_torch.models import vit as tvit
    from shapley_vit_tpu_torch.ops import quant
    from shapley_vit_tpu_torch.ops import tree_math as tm

    cfg = Config()  # ViT-B/16, bf16, merged, comp-contrib; bench.py's int8 spec:
    cfg.model.gelu = "tanh"
    cfg.model.quant = "int8"
    work = os.path.join(ROOT, "exp", "chip_smoke_int8")
    shutil.rmtree(work, ignore_errors=True)
    cfg.obs.exp_dir = os.path.join(work, "out")
    drops = round_dir("bfloat16")  # the round's drops
    paths = [os.path.join(drops, f"client_{i + 1}_model", "ViT_epoch_9.npz") for i in range(3)]

    zero_counts(counted)
    quant.int8_matmul.calls = 0
    t0 = time.perf_counter()
    all_rounds, _ = drv.start(cfg, checkpoint_paths=paths, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    products = quant.int8_matmul.calls
    metrics = os.path.join(cfg.output_dir, f"party0_{cfg.obs.exp_id}_{cfg.data.mode}_metrics.csv")
    round_s = _metric(metrics, "time/shapley_round")
    evals = int(_metric(metrics, "shapley_round/coalition_evals"))
    sv = [[all_rounds[d][1][c] for c in range(3)] for d in range(2)]
    _, eff_err = exact_efficiency(cfg.output_dir, 3)
    launches_ok = (launches["patch_embed"] > 0 and launches["fused_attention_packed"] > 0
                   and launches["fused_mlp_block"] == 0 and products > 0)
    round_ok = (launches_ok and eff_err <= 1e-4
                and all(math.isfinite(x) for row in sv for x in row))

    phase_profile(drops, int8=True)
    products_rows = int8_product_rows()

    fwd = int8_forward_check()
    ok = round_ok and fwd["ok"] and all(r["ok"] for r in products_rows)
    emit({
        "phase": "int8", "variant": "base", "dtype": cfg.model.compute_dtype,
        "gelu": cfg.model.gelu, "quant": cfg.model.quant, "quant_targets": list(tvit.INT8_TARGETS),
        "mlp": "torch ops (mlp_half_xla)", "clients": 3,
        "shapley_value": {"accuracy": sv[0], "loss": sv[1]}, "efficiency_err": eff_err,
        "round_s": round_s, "bf16_round_s": bf16_round_s, "wall_s": wall,
        "coalition_evals": evals, "launches": launches, "int8_products": products,
        "products": products_rows,
        "forward": fwd,
        "ok": ok,
    })
    if not ok:
        raise SystemExit("the int8 phase failed its checks")


def _serve_round_numbers(records) -> list:
    """Per round: ingest seconds (pipelined or not), and the seconds from the
    moment every checkpoint was there (the wait's end) to the SVs."""
    out = []
    for r in records:
        ph = r["phases"]
        out.append({
            "epoch": r["epoch"], "pipelined_ingest": r["pipelined_ingest"],
            "ingest_s": ph.get("ingest", 0.0) + ph.get("stack_deltas", 0.0),
            "arrival_to_sv_s": sum(ph.get(k, 0.0) for k in
                                   ("ingest", "stack_deltas", "persist_setup", "shapley_round")),
            "shapley_round_s": ph.get("shapley_round"), "wall_s": r["wall_s"],
            "evals": r["evals"],
        })
    return out


def phase_serve(counted) -> None:
    """The continuous service on the card: two rounds, then a recycle and
    an automatic resume that must reproduce them."""
    import numpy as np
    import torch

    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.driver import serve as svc
    from shapley_vit_tpu_torch.driver import start as drv
    from shapley_vit_tpu_torch.fl import ingestion, native
    from shapley_vit_tpu_torch.models.convert import tree_to_numpy
    from shapley_vit_tpu_torch.ops import tree_math as tm

    work = os.path.join(ROOT, "exp", "chip_smoke_serve")
    shutil.rmtree(work, ignore_errors=True)

    def service_cfg(name):
        cfg = Config()  # ViT-B/16, bf16, merged, comp-contrib
        cfg.obs.exp_dir = os.path.join(work, name)
        cfg.paths.local_model_path = os.path.join(work, "local")
        cfg.paths.global_model_path = os.path.join(work, name, "global")
        cfg.obs.render_plots = False  # no matplotlib on the card's machine
        cfg.obs.use_tensorboard = True
        return cfg

    cfg = service_cfg("service")
    spec, _, init_lora = drv.build_model(cfg, device="cpu")
    init_host = tree_to_numpy(init_lora)
    for epoch in (0, 1):
        rng = np.random.default_rng(100 + epoch)
        for i, n_train in enumerate((120, 300, 580)):
            drop = tm.tree_map(
                lambda a: a + (0.02 * rng.normal(size=a.shape)).astype(np.float32), init_host)
            ingestion.save_lora_checkpoint(
                os.path.join(cfg.paths.local_model_path, f"client_{i + 1}_model",
                             f"ViT_epoch_{epoch}.npz"),
                drop, spec, num_local_data_train=n_train)

    zero_counts(counted)
    t0 = time.perf_counter()
    records = svc.serve(cfg, max_rounds=2, timeout=120.0, policy="fail", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    out = cfg.output_dir
    watcher = "native" if native.native_available() and native._LIB_PATH else "polling"
    effs = [exact_efficiency(out, 3, f"utility_table_epoch_{e}.npz")[1] for e in (0, 1)]
    svs = [[[r["shapley"][d][c] for c in range(3)] for d in range(2)] for r in records]
    tb_dir = os.path.join(out, "tensorboard")
    on_disk = {
        "utility_tables": all(os.path.exists(os.path.join(out, f"utility_table_epoch_{e}.npz"))
                              for e in (0, 1)),
        "service_state": os.path.exists(os.path.join(out, svc.STATE_FILENAME)),
        "tensorboard_events": os.path.isdir(tb_dir) and any(
            "tfevents" in f for f in os.listdir(tb_dir)),
        "global_exports": all(os.path.exists(os.path.join(
            cfg.paths.global_model_path, f"ViT_global_epoch_{e}.npz")) for e in (0, 1)),
    }
    state = svc.read_service_state(out) or {}
    service_ok = (
        len(records) == 2 and [r["epoch"] for r in records] == [0, 1]
        and all(math.isfinite(v) for r in svs for row in r for v in row)
        and max(effs) <= 1e-6 and all(on_disk.values()) and watcher == "native"
        and state.get("next_epoch") == 2
        and launches["patch_embed"] > 0 and launches["fused_attention_packed"] > 0
        and launches["fused_mlp_block"] > 0
    )

    # the recycle: one round under a 1 MB RSS ceiling, then an automatic resume
    rcfg = service_cfg("recycle")
    first = svc.serve(rcfg, max_rounds=5, timeout=120.0, policy="fail", max_rss_mb=1.0,
                      device="cuda")
    second = svc.serve(rcfg, max_rounds=1, timeout=120.0, policy="fail", start_epoch="auto",
                       device="cuda")
    resumed = [[[r["shapley"][d][c] for c in range(3)] for d in range(2)]
               for r in list(first) + list(second)]
    recycle_err = max(abs(a - b) for r1, r2 in zip(resumed, svs)
                      for row1, row2 in zip(r1, r2) for a, b in zip(row1, row2))
    recycle_ok = (first.stop_reason == "rss_ceiling" and [r["epoch"] for r in first] == [0]
                  and [r["epoch"] for r in second] == [1] and recycle_err <= 1e-5)
    emit({
        "phase": "serve", "variant": "base", "dtype": cfg.model.compute_dtype, "clients": 3,
        "rounds": len(records), "stop_reason": records.stop_reason, "wall_s": wall,
        "prewarm_s": records.prewarm_s, "per_round": _serve_round_numbers(records),
        "shapley_value": [{"accuracy": s[0], "loss": s[1]} for s in svs],
        "utility": [r["utility"] for r in records], "efficiency_err": effs,
        "on_disk": on_disk, "watcher": watcher, "native_library": native._LIB_PATH,
        "launches": launches,
        "recycle": {"first_stop_reason": first.stop_reason,
                    "epochs": [r["epoch"] for r in list(first) + list(second)],
                    "resumed_prewarm_s": second.prewarm_s,
                    "max_abs_sv_diff_vs_uninterrupted": recycle_err, "atol": 1e-5,
                    "ok": recycle_ok},
        "ok": service_ok and recycle_ok,
    })
    if not (service_ok and recycle_ok):
        raise SystemExit("the serve phase failed its checks")


ROUNDS_PARTICIPATION = ((1, 1, 1), (1, 0, 1), (1, 1, 1))
ROUNDS_CLIENTS = (120, 300, 580)


def phase_rounds(counted, cfg=None, device="cuda") -> None:
    """Multi-round FL with per-round Shapley valuation on the card (ViT-B/16,
    bf16, the default ``Config``; ``cfg`` and ``device`` exist to rehearse
    the phase at a small size on the CPU), then the compared estimators on
    the valued rounds' Games and the lazy multi-round utilities against a
    sequential reconstruction."""
    import numpy as np
    import torch

    from shapley_vit_tpu_torch import shapley as sh
    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.driver import rounds
    from shapley_vit_tpu_torch.fl import evaluation as ev
    from shapley_vit_tpu_torch.models import vit as tvit
    from shapley_vit_tpu_torch.ops import tree_math as tm
    from shapley_vit_tpu_torch.shapley import fed_shapley as fs
    from shapley_vit_tpu_torch.utils.profiling import StepTimer

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = cfg or Config()  # ViT-B/16, bf16, merged, synthetic OCT at scale 1.0
    fns = rounds.build_round_fns(cfg, device=device, local_steps=4)  # Adam 5e-3, batch 64
    spec, base, init_lora = fns["spec"], fns["base"], fns["init_lora"]
    valid, data, train = fns["valid"], fns["data"], fns.pop("train")
    order = np.random.default_rng(5).permutation(len(train))
    ends = np.cumsum((0,) + ROUNDS_CLIENTS)
    clients = [rounds.client_tensors(train.images[order[a:b]], train.labels[order[a:b]],
                                     spec.image, device) for a, b in zip(ends[:-1], ends[1:])]
    del train
    participation = np.array(ROUNDS_PARTICIPATION, dtype=bool)
    n, n_rounds, budget, seed = 3, len(participation), 2, cfg.shapley.seed
    factory = fns["eval_coalitions_fn_factory"]

    timer = StepTimer()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_counts(counted)
    t0 = time.perf_counter()
    records = rounds.run_federated_rounds(
        num_rounds=n_rounds, clients_data=clients, init_overlay=init_lora,
        train_client_fn=fns["train_client_fn"], evaluate_fn=fns["evaluate_fn"],
        eval_coalitions_fn_factory=factory, num_local_data=ROUNDS_CLIENTS,
        participation=participation, estimator="comp_contrib", shapley_budget=budget,
        seed=seed, timer=timer)
    sync()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    valued = [t for t, r in enumerate(records) if r.shapley is not None]

    train_s = iter(timer.times("train"))
    per_round = [{"round": t, "participants": [int(c) for c in np.nonzero(participation[t])[0]],
                  "train_s": [next(train_s) for _ in range(int(participation[t].sum()))],
                  "evaluate_s": timer.times("evaluate")[t], "utility": records[t].utility,
                  "valued": t in valued} for t in range(n_rounds)]
    shapley_s = dict(zip(valued, timer.times("shapley")))
    for row in per_round:
        row["shapley_s"] = shapley_s.get(row["round"])

    def game_of(t):
        return rounds.round_game(records, t, init_lora, fns["evaluate_fn"], factory,
                                 ROUNDS_CLIENTS)

    def gap(sv, game):
        grand = game.eval_utility(game.selected_clients)
        return max(abs(sum(sv[d].values()) - grand[d]) for d in range(2))

    def arr(sv):
        return np.array([[sv[d][c] for c in range(n)] for d in range(2)])

    # each valued round again: exact's efficiency, comp-contrib reproduced
    valued_rows = []
    for t in valued:
        game = game_of(t)
        exact = sh.shapley_exact(game)
        cc, se = sh.shapley_comp_contrib(game, 50 * game.n, return_se=True,
                                         rng=np.random.default_rng(seed + 1000 + t))
        vs_exact = np.abs(arr(cc) - arr(exact))
        valued_rows.append({
            "round": t, "exact_efficiency_err": gap(exact, game),
            "comp_contrib_efficiency_gap": gap(cc, game),
            "comp_contrib_vs_driver": float(np.abs(arr(cc) - arr(records[t].shapley)).max()),
            "comp_contrib_vs_exact": float(vs_exact.max()),
            "comp_contrib_within_4se": bool((vs_exact <= 4 * arr(se) + 1e-6).all()),
            "shapley_value": {"accuracy": [records[t].shapley[0][c] for c in range(n)],
                              "loss": [records[t].shapley[1][c] for c in range(n)]},
            "exact_shapley_value": {"accuracy": [exact[0][c] for c in range(n)],
                                    "loss": [exact[1][c] for c in range(n)]},
        })
    valued_ok = all(r["exact_efficiency_err"] <= 1e-6 and r["comp_contrib_vs_driver"] <= 1e-6
                    and r["comp_contrib_within_4se"] for r in valued_rows)

    # round 1: client 1 sat out; its value is exactly 0.0
    game1 = game_of(1)
    sat_out = {"exact": [d[1] for d in sh.shapley_exact(game1)],
               "comp_contrib": [d[1] for d in sh.shapley_comp_contrib(
                   game1, 50 * game1.n, rng=np.random.default_rng(seed + 1001))]}
    sat_out_ok = all(v == 0.0 for vals in sat_out.values() for v in vals)

    # the compared estimators on the last valued round's Game: exact fills
    # the cache, every later family scores from it with no launch
    game = game_of(valued[-1])
    rng = np.random.default_rng(seed + 3000)
    sh.shapley_exact(game)
    evals = game.num_evaluations
    zero_counts(counted)
    host_s = {}

    def timed(name, fn):
        t1 = time.perf_counter()
        fn()
        host_s[name] = time.perf_counter() - t1

    timed("monte_carlo", lambda: sh.shapley_monte_carlo(game, 50 * game.n, rng=rng))
    timed("owen", lambda: sh.shapley_owen(game, rng=rng))
    timed("kernel", lambda: sh.shapley_kernel(game))
    timed("beta", lambda: sh.shapley_beta(game, alpha=1.0, beta=4.0, m=50, rng=rng))
    timed("banzhaf", lambda: sh.banzhaf_value(game, m=50, rng=rng))
    timed("gtg", lambda: [sh.GTG(d, rng=np.random.default_rng(seed + 2000 + valued[-1]),
                                 batch_prefixes=True).compute_shapley_value(game, valued[-1])
                          for d in range(2)])
    timed("mr", lambda: [sh.MR(d).compute_shapley_value(game, valued[-1]) for d in range(2)])
    timed("tmr", lambda: [sh.TMR(d).compute_shapley_value(game, valued[-1]) for d in range(2)])
    cached_launches = {fn.__name__: fn.launches for fn in counted}
    cached_ok = (all(v == 0 for v in cached_launches.values())
                 and game.num_evaluations == evals == 2 ** game.n - 1)

    # the lazy multi-round utilities: one evaluator call over the 3 x 3 stack
    zeros = tm.tree_zeros_like(init_lora)
    stacked_all = tm.tree_stack([d if d is not None else zeros for r in records for d in r.deltas])
    init_utility = list(fns["evaluate_fn"](init_lora))
    evaluate_all = factory(init_lora, stacked_all)
    calls = []

    def lazy_eval(W):
        calls.append(W.shape)
        return evaluate_all(W)

    all_subsets = fs.all_subsets_enumeration(n)
    t1 = time.perf_counter()
    with torch.inference_mode():
        _, lazy = fs.compute_utilities_lazy(
            num_clients=n, previous_utility=init_utility,
            client_deltas_all_rounds=[r.deltas for r in records],
            client_selection_matrix=participation, num_local_data=ROUNDS_CLIENTS,
            eval_coalitions_fn=lazy_eval, all_subsets=all_subsets, utility_dim=2,
            current_round=n_rounds - 1)
    sync()
    lazy_s = time.perf_counter() - t1

    def merged_forward(overlay, images):
        stacked = tm.tree_map(lambda a: a[None], overlay)
        return tvit.vit_forward_merged(base, tvit.merge_coalition_weights(base, stacked, spec),
                                       images, spec)[0]

    lazy_err = {"accuracy": 0.0, "loss": 0.0}
    for subset in all_subsets:
        overlay = init_lora
        for t, rec in enumerate(records):
            members = [j for j in subset if participation[t][j]]
            if members:
                ratio = tm.fedavg_ratio([ROUNDS_CLIENTS[j] for j in members])
                overlay = tm.apply_deltas(overlay, tm.aggregate_deltas(
                    tm.tree_stack([rec.deltas[j] for j in members]), ratio))
        acc, loss = ev.evaluate_model(merged_forward, overlay, data, dataset_size=len(valid))
        for d, (name, got) in enumerate((("accuracy", acc), ("loss", loss))):
            lazy_err[name] = max(lazy_err[name], abs(lazy[d][subset] + init_utility[d] - got))
    lazy_ok = (calls == [(7, n_rounds * n)] and lazy_err["loss"] <= 1e-3
               and lazy_err["accuracy"] <= 1 / 200)

    svs = [v for r in records if r.shapley for d in r.shapley for v in d.values()]
    run_ok = (len(valued) <= budget and all(math.isfinite(v) for v in svs)
              and (all(v > 0 for v in launches.values()) or not on_card))
    ok = run_ok and valued_ok and sat_out_ok and cached_ok and lazy_ok
    emit({
        "phase": "rounds", "variant": cfg.model.vit_variant, "dtype": cfg.model.compute_dtype,
        "eval_mode": cfg.model.eval_mode, "clients": list(ROUNDS_CLIENTS),
        "validation_images": len(valid), "participation": participation.astype(int).tolist(),
        "local_steps": 4, "batch": cfg.train.train_batch * 8, "estimator": "comp_contrib",
        "budget": budget,
        "valued_rounds": valued, "wall_s": wall, "per_round": per_round,
        "milp_s": timer.times("milp")[0], "coalition_eval_s": timer.times("coalition_eval"),
        "launches": launches, "peak_memory_gb": peak_gb,
        "valued": valued_rows, "efficiency_atol": 1e-6,
        "round1_sat_out_sv": sat_out,
        "cached_game": {"round": valued[-1], "launches": cached_launches,
                        "coalition_evals": game.num_evaluations, "host_s": host_s, "ok": cached_ok},
        "lazy": {"evaluator_calls": [list(c) for c in calls], "seconds": lazy_s,
                 "max_abs_err_vs_sequential": lazy_err, "atol": {"loss": 1e-3, "accuracy": 1 / 200},
                 "ok": lazy_ok},
        "ok": ok,
    })
    if not ok:
        raise SystemExit("the rounds phase failed its checks")


ROBUST_EPS = 8 / 255
SMALL_DENOISE = dict(fwd_out=(8, 16), num_fwd=(1, 1), back_out=(8,), num_back=(1,))


def _he_init(model, gen) -> None:
    """Redraw every convolution and linear weight of an inception module
    from N(0, 2/fan_in) (1/fan_in for the classifier): the reference's init
    (std 0.1 whatever the fan-in) grows activations by orders of magnitude
    over 17 stages, which would leave no digits to compare."""
    import torch

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) and m.weight.numel():
            fan_in = m.weight[0].numel()
            gain = 1.0 if isinstance(m, torch.nn.Linear) else 2.0
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * math.sqrt(gain / fan_in))


def robust_kernel_rows(batch_sizes) -> list:
    """The patch and [B, H, N, d] attention kernels at each batch size the
    ``robust`` phase gives them (ViT-B/16 at 224 px, bf16, as its training
    spec runs them): the forward against the plain version on seeded card
    inputs, on the ``wgmma`` route, and the gradient by :func:`grad_check`,
    with the ``kernels`` phase's bf16 tolerance."""
    import torch

    from shapley_vit_tpu_torch.ops import attention as att
    from shapley_vit_tpu_torch.ops import patch_embed as pe

    dtype, tol = torch.bfloat16, dict(atol=2e-2, rtol=2e-2)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    rows = []
    for b in batch_sizes:
        img = torch.rand((b, IMG, IMG, CH), generator=gen, device="cuda").to(dtype)
        pw, pb = randn((P * P * CH, D), 0.05), randn((D,), 0.1)
        qh, kh, vh = (randn((b, N, D)).view(b, N, HEADS, 64).transpose(1, 2) for _ in range(3))
        for wrapper, kernel, plain, args in (
                (pe.patch_embed, lambda: pe.patch_embed(img, pw, pb, P),
                 lambda: pe.patch_embed_plain(img, pw, pb, P), img),
                (att.fused_attention, lambda: att.fused_attention(qh, kh, vh),
                 lambda: att.fused_attention_plain(qh, kh, vh), qh)):
            launched = wrapper.launches
            got = kernel()
            route = wrapper.route
            want = plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = (torch.allclose(got.float(), want.float(), **tol) and route == "wgmma"
                  and wrapper.launches == launched + 1)
            rows.append({"name": wrapper.__name__, "dtype": "bfloat16", "shape": list(args.shape),
                         "route": route, "max_abs_err": err, "ok": ok})
            del got, want
        grads = kernel_grad_checks(dtype, tol, img, pw, pb, qh, kh, vh)
        rows += grads
        del img, pw, pb, qh, kh, vh
    torch.cuda.empty_cache()
    return rows


def phase_robust(counted, cfg=None, device="cuda") -> None:
    """Adversarial evaluation, interpretability and the Inception-v3 defense
    on the card (ViT-B/16, bf16, the default ``Config``; ``cfg`` and
    ``device`` exist to rehearse the phase at a small size on the CPU)."""
    import copy

    import numpy as np
    import torch
    import torch.nn.functional as F

    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.driver import client, report
    from shapley_vit_tpu_torch.driver import start as drv
    from shapley_vit_tpu_torch.fl import adversarial as adv
    from shapley_vit_tpu_torch.models import inception as inc
    from shapley_vit_tpu_torch.models import interpret
    from shapley_vit_tpu_torch.models import vit as tvit
    from shapley_vit_tpu_torch.ops import tree_math as tm
    from shapley_vit_tpu_torch.utils import tb_events
    from shapley_vit_tpu_torch.utils.logging import TensorBoardWriter

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def reset_peak():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        result = fn()
        sync()
        return result, time.perf_counter() - t0

    work = os.path.join(ROOT, "exp", "chip_smoke_robust")
    shutil.rmtree(work, ignore_errors=True)
    t_phase = time.perf_counter()
    cfg = cfg or Config()  # ViT-B/16, bf16, synthetic OCT at scale 1.0
    spec, base, overlay = drv.build_model(cfg, device=device)
    # the attack needs a gradient: the training spec, for attack and evaluation
    tspec = spec.replace(**client.TRAIN_SPEC)
    valid = drv.load_validation_dataset(cfg, target_size=spec.image, device=device)
    bs = cfg.data.eval_batch_size
    images = torch.as_tensor(valid.images, dtype=torch.float32).to(device)
    labels = torch.as_tensor(np.asarray(valid.labels), dtype=torch.long).to(device)
    batches = [(images[i:i + bs], labels[i:i + bs]) for i in range(0, len(valid), bs)]
    nb = len(batches)

    def forward(p, x):
        return tvit.vit_forward(base, p, x, tspec)

    def launches():
        return {fn.__name__: fn.launches for fn in counted}

    def want(forwards):  # patch, packed attention, fused MLP, [B, H, N, d] attention
        return dict(zip([fn.__name__ for fn in counted], (forwards, 0, 0, forwards * spec.depth)))

    checks = {}
    out = {"phase": "robust", "variant": cfg.model.vit_variant, "dtype": cfg.model.compute_dtype,
           "validation_images": len(valid), "batch": bs, "epsilon": ROBUST_EPS}
    db = min(32, len(valid))  # the defended FGSM's batch
    if on_card:
        # every batch size the attacks give the kernels (the last batch is
        # the remainder), forward and gradient against the plain versions
        sizes = sorted({len(x) for x, _ in batches} | {db}, reverse=True)
        rows = robust_kernel_rows(sizes)
        checks["kernels_at_robust_shapes"] = all(r["ok"] for r in rows)
        out["kernels"] = rows

    # FGSM with clean evaluation: three forwards a batch (clean, attack, adversarial)
    reset_peak()
    zero_counts(counted)
    fgsm, fgsm_s = timed(lambda: adv.adversarial_evaluation(forward, overlay, batches, ROBUST_EPS))
    fgsm_launches = launches()
    checks["fgsm_adv_loss_above_clean"] = fgsm["adv_loss"] > fgsm["clean_loss"]
    checks["fgsm_launches"] = fgsm_launches == want(3 * nb) or not on_card
    out["fgsm"] = {**fgsm, "seconds": fgsm_s, "seconds_per_batch": fgsm_s / nb,
                   "launches": fgsm_launches, "expected_launches": want(3 * nb),
                   "peak_memory_gb": peak_gb()}

    # PGD-10 from a seeded random start; every input the forward sees is
    # held against its batch's clean images
    current, seen = {}, []

    def tracked():
        for x, y in batches:
            current["clean"] = x
            yield x, y

    def watched(p, x):
        d = x.detach()
        seen.append(torch.stack([(d - current["clean"]).abs().max(), d.min(), d.max()]))
        return forward(p, x)

    reset_peak()
    zero_counts(counted)
    pgd, pgd_s = timed(lambda: adv.adversarial_evaluation(
        watched, overlay, tracked(), ROBUST_EPS, attack="pgd", pgd_steps=10, key=cfg.shapley.seed))
    pgd_launches = launches()
    # per batch: the clean forward, the random start, iterates 1-9, the final one
    stats = torch.stack(seen).cpu().numpy().reshape(nb, 12, 3)
    ball = float(stats[:, 1:, 0].max())
    lo, hi = float(stats[:, 2:, 1].min()), float(stats[:, 2:, 2].max())
    checks["pgd_in_ball"] = ball <= ROBUST_EPS + 1e-6
    checks["pgd_in_range"] = lo >= 0.0 and hi <= 1.0
    checks["pgd_launches"] = pgd_launches == want(12 * nb) or not on_card
    out["pgd"] = {**pgd, "steps": 10, "seconds": pgd_s, "launches": pgd_launches,
                  "expected_launches": want(12 * nb), "max_dist_from_clean": ball,
                  "iterate_min": lo, "iterate_max": hi, "peak_memory_gb": peak_gb()}

    # the multi-epsilon sweep: two forwards a batch at each epsilon
    zero_counts(counted)
    eps = [0.0, 2 / 255, ROBUST_EPS]
    sweep, sweep_s = timed(lambda: adv.multi_epsilon_evaluation(forward, overlay, batches, eps))
    at0 = sweep[0.0]
    checks["eps0_equals_clean"] = (at0["adv_acc"] == at0["clean_acc"]
                                   and at0["adv_loss"] == at0["clean_loss"])
    checks["clean_once"] = [("clean_acc" in sweep[e]) for e in eps] == [True, False, False]
    checks["sweep_launches"] = launches() == want(6 * nb) or not on_card
    out["multi_epsilon"] = {"results": {str(e): r for e, r in sweep.items()}, "seconds": sweep_s,
                            "launches": launches()}

    # one FGSM batch (attack and adversarial evaluation): host clock against
    # the device's busy time
    one = batches[:1]

    def fgsm_batch():
        return adv.adversarial_evaluation(forward, overlay, one, ROBUST_EPS, use_clean_eval=False)

    timed(fgsm_batch)
    _, batch_s = timed(fgsm_batch)
    out["fgsm_batch_profile"] = {"images": len(one[0][0]), "host_ms": 1e3 * batch_s}
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            timed(fgsm_batch)
        rows = device_rows(prof)
        busy = sum(ms for _, ms, _ in rows)
        out["fgsm_batch_profile"].update({
            "device_busy_ms": busy, "device_idle_share": max(0.0, 1.0 - busy / (1e3 * batch_s)),
            "top_kernels": [{"name": k[:100], "device_ms": ms, "calls": n}
                            for k, ms, n in rows[:8]]})

    # float32 FGSM of the same model at batch 2: the card against the CPU
    cfg32 = copy.deepcopy(cfg)
    cfg32.model.compute_dtype = "float32"
    spec32, base32, lora32 = drv.build_model(cfg32, device="cpu")
    x2, y2 = images[:2].cpu(), labels[:2].cpu()

    def to(tree, dev):
        return tm.tree_map(lambda a: a.to(dev), tree)

    def fgsm32(dev):
        b, lo_ = to(base32, dev), to(lora32, dev)
        sp = spec32.replace(**client.TRAIN_SPEC)

        def f(p, x):
            return tvit.vit_forward(b, p, x, sp)

        x = x2.to(dev).requires_grad_(True)
        (g,) = torch.autograd.grad(F.cross_entropy(f(lo_, x), y2.to(dev)), x)
        return g.cpu(), adv.fgsm(f, lo_, x2.to(dev), y2.to(dev), ROBUST_EPS).cpu()

    g_cpu, a_cpu = fgsm32("cpu")
    g_dev, a_dev = fgsm32(device)
    scale = g_cpu.abs().max().item()
    grad_err = (g_dev - g_cpu).abs().max().item() / scale
    sure = g_cpu.abs() > 1e-3 * scale
    checks["fgsm32_grad"] = scale > 0 and grad_err <= 1e-3
    checks["fgsm32_images"] = bool(torch.equal(a_dev[sure], a_cpu[sure]))
    out["fgsm_float32_vs_cpu"] = {"images": 2, "grad_max_abs": scale,
                                  "grad_err_vs_largest": grad_err, "bar": 1e-3,
                                  "differing_where_sure": int((a_dev[sure] != a_cpu[sure]).sum()),
                                  "differing_elsewhere": int((a_dev[~sure] != a_cpu[~sure]).sum()),
                                  "elements": int(a_cpu.numel())}

    # interpretability on 4 validation images: float32 card against CPU,
    # then the model's own dtype (bf16) on the card
    g = spec.image // spec.patch
    x4 = images[:4]
    b32, l32 = to(base32, device), to(lora32, device)
    methods = {
        "rollout_mean": lambda b, lo_, x, sp: interpret.attention_rollout(b, lo_, x, sp, "mean"),
        "rollout_max": lambda b, lo_, x, sp: interpret.attention_rollout(b, lo_, x, sp, "max"),
        "grad_cam": lambda b, lo_, x, sp: interpret.grad_cam(b, lo_, x, sp),
    }
    maps = {}
    for name, fn in methods.items():
        cpu = fn(base32, lora32, x4.cpu(), spec32)
        dev32, s32 = timed(lambda: fn(b32, l32, x4, spec32))
        dev16, s16 = timed(lambda: fn(base, overlay, x4, spec))
        err = (dev32.cpu() - cpu).abs().max().item()
        ok16 = (tuple(dev16.shape) == (4, g, g) and bool(torch.isfinite(dev16).all())
                and dev16.min().item() >= 0.0 and dev16.max().item() <= 1.0)
        checks[f"{name}_float32"] = err <= 1e-3
        checks[f"{name}_model_dtype"] = ok16
        maps[name] = {"float32_max_abs_err_vs_cpu": err, "float32_seconds": s32,
                      "model_dtype_seconds": s16, "model_dtype_shape": list(dev16.shape),
                      "model_dtype_ok": ok16}
    with torch.no_grad():
        _, probs, _ = interpret._forward_collect(b32, l32, x4, spec32)
    row_err = (probs.sum(-1) - 1).abs().max().item()
    checks["attention_rows_sum_to_one"] = row_err <= 1e-5
    tb_dir = os.path.join(work, "tensorboard")
    tb = TensorBoardWriter(tb_dir)
    (_, sal), sal_s = timed(lambda: report.saliency_overlays(base, overlay, valid.images, spec,
                                                             round_idx=1, tb=tb))
    tb.close()
    events = [e for f in sorted(os.listdir(tb_dir))
              for e in tb_events.read_image_events(os.path.join(tb_dir, f))]
    decoded = [tb_events.decode_png(e[4]).shape for e in events]
    checks["saliency_events"] = ([e[0] for e in events]
                                 == [f"saliency/grad_cam/img_{i}" for i in range(4)]
                                 and decoded == [(spec.image, spec.image, 3)] * 4)
    out["interpretability"] = {"images": 4, "maps": maps, "attention_row_sum_err": row_err,
                               "saliency_overlays_seconds": sal_s, "saliency_shape": list(sal.shape),
                               "tensorboard_events": [e[0] for e in events]}
    del b32, l32, probs

    # the defense: Inception3 with Denoise, float32, card against CPU from
    # the same weights; the paired Net; FGSM through a Denoise front-end
    size = 299 if on_card else 75
    den_kw = {} if on_card else SMALL_DENOISE
    gen = torch.Generator().manual_seed(cfg.shapley.seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.shapley.seed)
        model = inc.Inception3(num_classes=4, denoise=inc.Denoise(size, size, **den_kw),
                               image_size=(size, size))
    _he_init(model, gen)
    model.eval()
    xi = torch.rand((2, size, size, 3), generator=gen)
    with torch.no_grad():
        cpu = model(xi, defense=True)
        dev_model = copy.deepcopy(model).to(device)
        dev, inc_s = timed(lambda: dev_model(xi.to(device), defense=True))
    inc_err = (dev.cpu() - cpu).abs().max().item()
    inc_bar = 1e-3 * max(1.0, cpu.abs().max().item())
    checks["inception_denoise_float32"] = inc_err <= inc_bar
    net = inc.get_net((size, size), seed=cfg.shapley.seed, **den_kw)
    _he_init(net, gen)
    net = net.to(device).eval()
    xa = (xi + 0.03 * torch.randn(xi.shape, generator=gen)).clamp(0, 1)
    with torch.no_grad():
        paired, net_s = timed(lambda: net(xi.to(device), xa.to(device)))
    orig, adv_out, loss, control, control_loss = paired
    checks["paired_net_finite"] = all(bool(torch.isfinite(t).all())
                                      for t in (orig, adv_out, control, *loss, *control_loss))
    del model, dev_model, net, paired, orig, adv_out, control
    denoise = inc.Denoise(spec.image, spec.image).to(device).eval()
    reset_peak()
    defended, def_s = timed(lambda: adv.adversarial_evaluation(
        forward, overlay, [(images[:db], labels[:db])], ROBUST_EPS, defense_fn=denoise))
    checks["defended_fgsm_finite"] = all(math.isfinite(v) for v in defended.values())
    out["defense"] = {
        "inception_image": size, "inception_denoise_max_abs_err_vs_cpu": inc_err,
        "inception_bar": inc_bar, "inception_logits_max_abs": cpu.abs().max().item(),
        "inception_seconds": inc_s, "paired_net_seconds": net_s,
        "paired_losses": {"defended": [v.item() for v in loss],
                          "control": [v.item() for v in control_loss]},
        "defended_fgsm": {**defended, "images": db, "seconds": def_s, "peak_memory_gb": peak_gb()},
    }
    del denoise
    if on_card:
        torch.cuda.empty_cache()

    ok = all(checks.values())
    out.update({"wall_s": time.perf_counter() - t_phase, "checks": checks, "ok": ok})
    emit(out)
    if not ok:
        raise SystemExit(f"the robust phase failed its checks: {[k for k, v in checks.items() if not v]}")


def variant_kernel_rows(spec, images: dict, attention_routes: dict) -> list:
    """Each of the four kernels at a variant's widths (``images[dtype]``
    images of ``spec.image`` px: the bf16 forward's count in bf16) against
    its plain version on the same seeded inputs, bf16 and float32, with the
    ``kernels`` phase's tolerances and, for bf16 attention, its
    ``share_bound``: the route each launch took and the one it should take
    (attention: ``attention_routes[dtype]``), the largest difference and the
    share of outputs that differ."""
    import torch

    from shapley_vit_tpu_torch.ops import attention as att
    from shapley_vit_tpu_torch.ops import mlp_block as mlp
    from shapley_vit_tpu_torch.ops import patch_embed as pe

    gen = torch.Generator(device="cuda").manual_seed(12)
    P, C, D, H, d, Hd = spec.patch, spec.channels, spec.hidden, spec.heads, spec.head_dim, spec.mlp_dim
    n = (spec.image // P) ** 2 + 1
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        tol = dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else dict(atol=1e-4, rtol=1e-4)
        b = images[dtype]

        def randn(shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

        img, pw, pb = randn((b, spec.image, spec.image, C)), randn((P * P * C, D), 0.05), randn((D,), 0.1)
        q, k, v = (randn((b, n, D)) for _ in range(3))
        qh, kh, vh = (t.view(b, n, H, d).transpose(1, 2) for t in (q, k, v))
        args = (randn((b * n, D)), (1 + randn((D,), 0.1).float()).to(dtype), randn((D,), 0.1),
                randn((D, Hd), 0.03), randn((Hd,), 0.1), randn((Hd, D), 0.03), randn((D,), 0.1))
        mlp_kw = dict(eps=spec.layernorm_eps, approximate_gelu=spec.gelu == "tanh")
        cases = {
            "patch_embed": (pe.patch_embed, (img, pw, pb, P), {}, pe.patch_embed_plain),
            "fused_attention_packed": (att.fused_attention_packed, (q, k, v), dict(heads=H),
                                       att.fused_attention_packed_plain),
            "fused_mlp_block": (mlp.fused_mlp_block, args, mlp_kw, mlp.fused_mlp_block_plain),
            "fused_attention": (att.fused_attention, (qh, kh, vh), {}, att.fused_attention_plain),
        }
        for name, (kernel, a, kw, plain) in cases.items():
            got = kernel(*a, **kw)
            want = plain(*a, **kw)
            torch.cuda.synchronize()
            dname = str(dtype).replace("torch.", "")
            differing = (got != want).float().mean().item()
            rows.append({"name": name, "dtype": dname, "shape": list(a[0].shape), "route": kernel.route,
                         "expected_route": (attention_routes[dtype] if "attention" in name
                                            else expected_route(dname)),
                         "max_abs_err": (got.float() - want.float()).abs().max().item(),
                         "share_differing": differing,
                         "ok": (torch.allclose(got.float(), want.float(), **tol)
                                and (dtype != torch.bfloat16 or "attention" not in name
                                     or differing <= share_bound(got.numel())))})
    return rows


# The variants phase's ViTs: (name, variant, overrides, images of the bf16
# forward, packed attention's route in bf16 and in float32). ViT-B/16 with 3
# heads of 256 runs at full depth and width, the bf16 forward at the round's
# 128 images.
VARIANTS = (("tiny", "tiny", dict(depth=2), 4, ("wgmma", "tf32x3")),
            ("micro", "micro", dict(depth=2), 4, ("wgmma", "tf32x3")),
            ("base_heads3", "base", dict(heads=3), IMAGES, ("wgmma_wide", "tf32x3_wide")))


def phase_variants(counted) -> None:
    """The ``VARIANTS`` ViTs on the card: float32 logits of 4 images
    against the CPU port, a bf16 forward through the kernels, every packed
    attention launch of both on the route ``VARIANTS`` names (ViT-B/16 with
    3 heads of 256: ``wgmma_wide`` in bf16, ``tf32x3_wide`` in float32),
    each kernel at the variant's widths (bf16 at the bf16 forward's images)
    against its plain version, and ``run_demo`` at its defaults (micro) and
    at tiny / 224 px."""
    import torch

    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.driver import run_demo
    from shapley_vit_tpu_torch.models import vit as tvit
    from shapley_vit_tpu_torch.ops import attention as att
    from shapley_vit_tpu_torch.ops import tree_math as tm

    names = [fn.__name__ for fn in counted]
    out = {"phase": "variants"}
    ok = True
    for vname, variant, over, bf16_images, (bf16_route, f32_route) in VARIANTS:
        spec = tvit.make_spec(variant, dtype="float32", **over)
        gen = torch.Generator().manual_seed(11)
        base = tvit.init_vit(gen, spec)
        lora = tvit.init_lora(gen, spec, classifier_from=base)
        lora = tm.tree_map(lambda a: a + 0.02 * torch.randn(a.shape, generator=gen), lora)
        images = torch.rand((4, spec.image, spec.image, spec.channels), generator=gen)
        bf_images = images if bf16_images == 4 else torch.rand(
            (bf16_images, spec.image, spec.image, spec.channels), generator=gen)

        def logits(dev, sp, imgs=images):
            b = tm.tree_map(lambda a: a.to(dev), base)
            lo = tm.tree_map(lambda a: a.to(dev), lora)
            with torch.inference_mode():
                return tvit.vit_forward(b, lo, imgs.to(dev), sp).cpu()

        def attention_routes_ok(by: dict, route: str) -> bool:
            """every packed attention launch on the variant's route"""
            return all(key.split()[0] == route for key in by)

        cpu = logits("cpu", spec)
        zero_counts(counted)
        gpu = logits("cuda", spec)
        f32_launches = {fn.__name__: fn.launches for fn in counted}
        f32_attention = dict(att.fused_attention_packed.launches_by)
        err = (gpu - cpu).abs().max().item()
        spec16 = spec.replace(dtype="bfloat16")
        zero_counts(counted)
        bf = logits("cuda", spec16, bf_images)
        bf_launches = {fn.__name__: fn.launches for fn in counted}
        bf_attention = dict(att.fused_attention_packed.launches_by)
        want = dict(zip(names, (1, spec.depth, spec.depth, 0)))  # patch, packed attention, MLP
        kernel_rows = variant_kernel_rows(spec, {torch.bfloat16: bf16_images, torch.float32: 4},
                                          {torch.bfloat16: bf16_route, torch.float32: f32_route})
        routes_ok = (all(r["route"] == r["expected_route"] for r in kernel_rows)
                     and attention_routes_ok(f32_attention, f32_route)
                     and attention_routes_ok(bf_attention, bf16_route))
        v_ok = (bool(torch.isfinite(gpu).all()) and err <= 1e-3 and f32_launches == want
                and bool(torch.isfinite(bf).all()) and bf_launches == want
                and all(r["ok"] for r in kernel_rows) and routes_ok)
        ok = ok and v_ok
        out[vname] = {"hidden": spec.hidden, "heads": spec.heads, "head_dim": spec.head_dim,
                      "mlp_dim": spec.mlp_dim, "image": spec.image, "depth": spec.depth,
                      "logits_shape": list(gpu.shape), "float32_max_abs_err_vs_cpu": err,
                      "atol": 1e-3, "float32_launches": f32_launches,
                      "float32_attention_by_kernel": f32_attention,
                      "bfloat16_images": bf.shape[0], "bfloat16_finite": bool(torch.isfinite(bf).all()),
                      "bfloat16_launches": bf_launches, "bfloat16_attention_by_kernel": bf_attention,
                      "kernels": kernel_rows, "ok": v_ok}
        del base, lora, images, bf_images, gpu, cpu, bf
        torch.cuda.empty_cache()

    work = os.path.join(ROOT, "exp", "chip_smoke_variants")
    shutil.rmtree(work, ignore_errors=True)
    demos = {}
    for name, kw in (("defaults", {}), ("tiny_224", dict(variant="tiny", image_size=224))):
        zero_counts(counted)
        t0 = time.perf_counter()
        all_rounds, _, out_dir = run_demo.run_demo(out_dir=os.path.join(work, name), device="cuda",
                                                   **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        cfg = Config()
        cfg.obs.exp_dir = os.path.join(out_dir, "exp")
        _, eff_err = exact_efficiency(cfg.output_dir, 3)
        sv = [[all_rounds[d][1][c] for c in range(3)] for d in range(2)]
        d_ok = (eff_err <= 1e-4 and all(math.isfinite(v) for row in sv for v in row)
                and all(n > 0 for n in launches.values()))
        ok = ok and d_ok
        demos[name] = {"variant": kw.get("variant", "micro"), "image_size": kw.get("image_size", 16),
                       "shapley_value": {"accuracy": sv[0], "loss": sv[1]},
                       "efficiency_err": eff_err, "wall_s": wall, "launches": launches, "ok": d_ok}
    out["demo"] = demos
    out["ok"] = ok
    emit(out)
    if not ok:
        raise SystemExit("a variant's ViT failed its checks on the card")


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
    round_kernels = (patch_embed, fused_attention_packed, fused_mlp_block)
    bf16_by, bf16_round_s = phase_round(round_kernels, route="wgmma")
    phase_profile(round_dir("bfloat16"), attention_kernel="attention_hopper_kernel",
                  patch_kernels=("patch_embed_hopper_kernel",))
    # the float32 round, the reference's numerics: the same kernels, all
    # three on the tensor cores in 3xTF32
    f32_by, _ = phase_round(round_kernels, dtype="float32", route="tf32x3")
    phase_profile(round_dir("float32"), dtype="float32", mlp_kernel="mlp_block_tf32x3_kernel",
                  attention_kernel="attention_tf32x3_kernel",
                  patch_kernels=("patch_embed_tf32x3_kernel", "patch_embed_split_kernel"))
    counted = (patch_embed, fused_attention_packed, fused_mlp_block, fused_attention)
    train_by = phase_train(counted)
    phase_variants(counted)
    # last, so that nothing they leave on the card moves the train phase's
    # peak memory
    phase_int8(counted, bf16_round_s)
    phase_serve(counted)
    phase_rounds(counted)
    phase_robust(counted)

    # the main paths' launches of each wrapper by kernel: the two rounds'
    # (patch embedding, packed attention, fused MLP), the train phase's
    # run_client's (fused_attention)
    on_path = {fn.__name__: collections.Counter() for fn in counted}
    for by in (bf16_by, f32_by, {"fused_attention": train_by["fused_attention"]}):
        for name, counts in by.items():
            on_path[name].update(counts)
    rows, off_path = [], []
    for (case, dname), s in summary.items():
        name = s["name"]
        source, replaces = KERNELS[name]
        row = {
            "name": name, "case": case, "dtype": dname, "route": "cuda", "kernel_route": s["route"],
            "kernel": s["kernel"], "source": source, "replaces": replaces,
            "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"], "library": s["library"],
            "bound_share": s["bound_share"], "vs_library": s["vs_library"],
            **{key: s[key] for key in ("shape", "ms_back_to_back", "library_ms_back_to_back",
                                       "vs_library_back_to_back", "host_us", "library_host_us",
                                       "device_ms", "library_device_ms", "library2", "library2_ms",
                                       "library2_ms_back_to_back", "library2_device_ms",
                                       "backward_ms") if key in s},
        }
        # a main path's row is its wrapper's own case; the other cases
        # (unaligned weights, other widths, longer sequences) are off path
        # even where their kernel is one a main path launched
        n = on_path[name][s["kernel"]] if case == name else 0
        if n:
            rows.append({**row, "launches": n})
        else:
            off_path.append({**row, "main_path_launches": n})
    main_rows = {(name, "bfloat16") for name in KERNELS} | {(fn.__name__, "float32") for fn in round_kernels}
    missing = main_rows - {(r["case"], r["dtype"]) for r in rows}
    if missing:
        raise SystemExit(f"no main path launched the kernel of these kernels-phase rows: {sorted(missing)}")
    emit({"kernels_off_path": off_path})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
