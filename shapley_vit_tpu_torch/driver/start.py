"""The Shapley-server driver: one Shapley round.

The port of ``shapley_vit_tpu/driver/start.py`` (reference
``shapleyserver/start.py`` ``start()`` + ``getInitialShapleyValue``):

  1. build ViT + LoRA (r=16, α=8, q+v, classifier trainable);
  2. load the OCT validation set (or its synthetic stand-in) and resize it
     to the model's input size;
  3. evaluate the initial global model -> ``previous_utility = [acc, loss]``;
  4. seed the round-0 SV as ``prev_utility/num_clients`` per client;
  5. wait for every client checkpoint, ingest it, evaluate each client
     alone, and take its delta against the initial overlay;
  6. build the Game and run comp-contrib (m = 50·n); the utility table
     persists so the round can resume.

Entry points run on the card unless the caller passes ``device="cpu"``
(the tests do); they raise when no card is present, and nothing falls back
to the CPU on its own. The CLI (``python -m
shapley_vit_tpu_torch.driver.start``) runs on the card only.

``model.quant="int8"`` evaluates with dynamic W8A8 on ``INT8_TARGETS``
(``ops/quant.py``); ``paths.global_model_path`` receives the round's FedAvg
global overlay as ``ViT_global.npz``; ``obs.use_tensorboard`` writes the
round's scalars under ``<output_dir>/tensorboard``. Grad-CAM overlays
(``obs.use_grad_cam``) are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from shapley_vit_tpu_torch.config import Config
from shapley_vit_tpu_torch.data.arrays import ArrayDataset
from shapley_vit_tpu_torch.data.registry import get_dataset
from shapley_vit_tpu_torch.fl import evaluation as ev
from shapley_vit_tpu_torch.fl import ingestion
from shapley_vit_tpu_torch.fl.client import EvalClient
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from shapley_vit_tpu_torch.ops import tree_math as tm
from shapley_vit_tpu_torch.shapley import Game, run_configured_comp_contrib
from shapley_vit_tpu_torch.utils.logging import CSVLogger, TensorBoardWriter, get_logger
from shapley_vit_tpu_torch.utils.profiling import StepTimer, trace

Tree = Any


def resolve_device(device=None) -> torch.device:
    """``device`` or the card; raises when a CUDA device is asked for and
    none is present (pass ``device="cpu"`` to run on the CPU)."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port on the CPU"
        )
    return device


def build_model(cfg: Config, generator: Optional[torch.Generator] = None, device="cuda"):
    """ViT + LoRA construction (reference start.py:258-276). Returns
    (spec, base_params, init_lora) on ``device``; the weights are drawn from
    ``generator`` (seed 0 by default)."""
    variant = cfg.model.vit_variant
    if cfg.model.model_type.lower().startswith("vit-"):
        variant = cfg.model.model_type.split("-", 1)[1].lower()
    if cfg.model.quant not in ("none", "int8"):
        raise ValueError(
            f"model.quant must be 'none' or 'int8', got {cfg.model.quant!r}"
        )
    # fail config typos at bring-up, not after minutes of model/data setup
    if cfg.shapley.cc_stratify not in ("uniform", "balanced", "neyman"):
        raise ValueError(
            "shapley.cc_stratify must be 'uniform', 'balanced' or 'neyman', "
            f"got {cfg.shapley.cc_stratify!r}"
        )
    spec = tvit.make_spec(
        variant,
        num_classes=cfg.model.num_classes,
        lora_r=cfg.model.lora_r,
        lora_alpha=cfg.model.lora_alpha,
        dtype=cfg.model.compute_dtype,
        gelu=cfg.model.gelu,
        quant=cfg.model.quant,
        quant_targets=tvit.INT8_TARGETS,
        # under int8 the MLP half runs as torch ops, so fc1 quantizes: the
        # JAX drivers build their spec with mlp_impl="xla", and the port's
        # fused MLP kernel (like the JAX Pallas MLP) bypasses int8. The
        # int8 round computes what the JAX int8 round computes
        **({"mlp_impl": "xla"} if cfg.model.quant == "int8" else {}),
    )
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    base = tvit.init_vit(gen, spec, device=device)
    lora = tvit.init_lora(gen, spec, classifier_from=base, device=device)
    return spec, base, lora


def build_eval_backend(cfg: Config, spec, base, init_lora, device="cuda", log_fn=None):
    """Mode-dependent evaluation surface.

    ``cfg.model.eval_mode``:
      * ``"merged"`` (default) — fold each coalition's LoRA into dense q/v
        kernels before the forward (``merge_coalition_weights`` +
        ``vit_forward_merged``); single-model evals ride the same path as a
        C=1 stack.
      * ``"overlay"`` — the rank-16 two-matmul LoRA path.

    Returns ``(backend, eval_coalitions, chunk)`` where
    ``eval_coalitions(overlay, stacked_deltas, W, batches, dataset_size)``
    evaluates the weight matrix's coalitions, materializing (and, in merged
    mode, folding ~2·L·D² compute-dtype bytes per coalition) ``chunk``
    coalitions at a time, so a large batch never materializes all at once.
    """
    chunk = cfg.shapley.coalition_chunk or ev.suggest_coalition_chunk(
        spec.seq_len, spec.hidden, cfg.data.eval_batch_size, device=device
    )
    mode = cfg.model.eval_mode
    if mode not in ("merged", "overlay"):
        raise ValueError(f"model.eval_mode must be 'merged' or 'overlay', got {mode!r}")
    if mode == "merged":
        fwd = lambda b, m, x: tvit.vit_forward_merged(b, m, x, spec)  # noqa: E731

        def mat(o, s, W):
            return tvit.merge_coalition_weights(base, tm.materialize_coalitions(o, s, W), spec)

        zero1 = tm.tree_stack([tm.tree_zeros_like(init_lora)])
        W1 = np.zeros((1, 1), np.float32)
        stack_single = lambda overlay: mat(overlay, zero1, W1)  # noqa: E731
    else:
        fwd = lambda b, l, x: tvit.vit_forward_coalitions(b, l, x, spec)  # noqa: E731
        mat = tm.materialize_coalitions
        stack_single = None
    if log_fn is not None:
        log_fn(f"coalition eval on {torch.device(device)}: {mode} mode, chunk {chunk}")
    backend = ev.EvalBackend(fwd, coalition_chunk=chunk, device=device,
                             stack_single=stack_single)

    def eval_coalitions(overlay, stacked_deltas, W, batches, dataset_size=None):
        C = int(np.shape(W)[0])
        if not chunk or C <= chunk:
            return backend.evaluate(
                base, mat(overlay, stacked_deltas, W), batches, dataset_size=dataset_size
            )
        outs = [
            backend.evaluate(
                base, mat(overlay, stacked_deltas, W[s : s + chunk]), batches,
                dataset_size=dataset_size,
            )
            for s in range(0, C, chunk)
        ]
        return np.concatenate(outs, axis=0)

    return backend, eval_coalitions, chunk


def resize_images(images: np.ndarray, target: int, device="cpu", block: int = 256) -> np.ndarray:
    """[N, H, W, C] -> [N, target, target, C] by antialiased bilinear
    resampling: a triangle kernel widened by 1/scale when downscaling, the
    same function as ``jax.image.resize(..., "bilinear")``."""
    out = []
    for s in range(0, len(images), block):
        x = torch.as_tensor(images[s : s + block]).to(device).permute(0, 3, 1, 2)
        y = F.interpolate(x, size=(target, target), mode="bilinear", align_corners=False,
                          antialias=True)
        out.append(y.permute(0, 2, 3, 1).cpu().numpy())
    return np.concatenate(out, axis=0)


def load_oct_splits(cfg: Config) -> Dict[str, ArrayDataset]:
    """The OCT splits via the .env path (reference getOCTData2,
    start.py:51-56) with the synthetic fallback for offline runs, at the
    images' own size."""
    root = cfg.paths.validation_dataset or cfg.data.data_dir
    splits, _ = get_dataset(
        "oct", data_dir=root, synthetic_ok=True, seed=cfg.shapley.seed,
        synthetic_scale=cfg.data.synthetic_scale,
    )
    return splits


def load_validation_dataset(cfg: Config, target_size: Optional[int] = None,
                            device="cpu", splits: Optional[Dict[str, ArrayDataset]] = None
                            ) -> ArrayDataset:
    """OCT validation data (:func:`load_oct_splits`, or ``splits`` when a
    caller has them already). Images are resized once (on ``device``) to
    the model's input size."""
    ds = (splits or load_oct_splits(cfg))["val"]
    target = target_size or cfg.data.image_size
    if ds.images.shape[1] != target:
        ds = ArrayDataset(
            images=resize_images(ds.images, target, device=device),
            labels=ds.labels,
            names=ds.names,
            classes=ds.classes,
        )
    return ds


def _refuse_unported(cfg: Config) -> None:
    if cfg.obs.use_grad_cam:
        raise NotImplementedError("Grad-CAM overlays are not ported to the GPU yet")


def get_initial_shapley_value(
    cfg: Config,
    valid: ArrayDataset,
    spec,
    base: Tree,
    init_lora: Tree,
    checkpoint_paths: Optional[List] = None,
    csv_logger: Optional[CSVLogger] = None,
    device="cuda",
) -> Tuple[List[List[Dict[int, float]]], List[Dict[int, float]]]:
    """Round bootstrap + first Shapley round (reference start.py:82-222).
    Returns (per-round SVs, summed SVs), one dict per utility dimension."""
    _refuse_unported(cfg)
    device = resolve_device(device)
    logger = get_logger()
    n = cfg.shapley.num_clients
    utility_dim = cfg.shapley.utility_dim

    backend, eval_coalitions, chunk = build_eval_backend(
        cfg, spec, base, init_lora, device=device, log_fn=logger.info
    )
    data = backend.device_batches(valid, cfg.data.eval_batch_size)

    # step 3: initial global utility (start.py:84-96)
    fed_valid_acc, fed_valid_loss = backend.evaluate_single(
        base, init_lora, data, dataset_size=len(valid)
    )
    previous_utility = [fed_valid_acc, fed_valid_loss]
    logger.info(f"Previous utility: {previous_utility}")

    # step 4: round-0 seed SV (start.py:104-106)
    shapley_value_all_rounds: List[List[Dict[int, float]]] = [[] for _ in range(utility_dim)]
    shapley_value_sum: List[Dict[int, float]] = [{} for _ in range(utility_dim)]
    for i in range(utility_dim):
        shapley_value_all_rounds[i].append({cid: previous_utility[i] / n for cid in range(n)})
        shapley_value_sum[i] = dict(shapley_value_all_rounds[i][0])

    # step 5: wait for + ingest client checkpoints (start.py:134-164)
    if checkpoint_paths is None:
        root = cfg.paths.local_model_path or os.path.join(os.getcwd(), "local_training")
        checkpoint_paths = ingestion.checkpoint_path_candidates(root, n)
    # resume runs block indefinitely (checkpoints are known to exist); fresh
    # runs bound the wait at an hour and fail loudly
    watch = ingestion.wait_for_checkpoints(
        checkpoint_paths,
        timeout=None if cfg.train.resume else 3600.0,
        policy="wait" if cfg.train.resume else "fail",
        log_fn=logger.info,
    )
    deltas, selection, sizes = ingestion.ingest_clients(watch.paths, init_lora, spec)
    weights = ingestion.resolve_data_sizes(sizes, selection, logger.info)

    # step 6: stack the host deltas and upload them once
    zeros_host = tm.tree_map(lambda x: np.zeros(tuple(x.shape), np.float32), init_lora)
    stacked = tree_from_numpy(
        tm.tree_stack_host([d if d is not None else zeros_host for d in deltas]), device
    )

    # per-client standalone evaluation (start.py:157-161, logged not used)
    clients: List[EvalClient] = []
    local_metrics = []
    for cid, delta in enumerate(deltas):
        n_local = int(weights[cid])
        if delta is None:
            clients.append(EvalClient(cid, num_local_data_train=n_local))
            continue
        client_lora = tm.tree_add(init_lora, tm.tree_map(lambda a, c=cid: a[c], stacked))
        acc, loss = backend.evaluate_single(base, client_lora, data, dataset_size=len(valid))
        local_metrics.append((cid, acc, loss))
        logger.info(f"Client {cid}: accuracy={acc} loss={loss}")
        clients.append(EvalClient(cid, num_local_data_train=n_local, delta=delta))
    if csv_logger is not None:
        for cid, acc, loss in local_metrics:
            csv_logger.log(["client_eval", cid, acc, loss])

    def eval_coalitions_fn(W: np.ndarray) -> np.ndarray:
        return eval_coalitions(init_lora, stacked, W, data, dataset_size=len(valid))

    game = Game(
        eval_coalitions_fn=eval_coalitions_fn,
        num_local_data=[c.num_local_data_train for c in clients],
        client_selection_vector=selection,
        previous_utility=previous_utility,
        utility_dim=utility_dim,
        n_all=n,
    )
    # resumable utility table: reseed a restarted round from it only when
    # its input fingerprint matches this round's deltas/weights/baseline
    if cfg.shapley.persist_utility_table:
        from shapley_vit_tpu_torch.fl import checkpoint as ckpt

        fp = ckpt.fingerprint_inputs(
            stacked,
            extra=(
                [c.num_local_data_train for c in clients],
                selection,
                [f"{u:.12g}" for u in previous_utility],
            ),
        )
        table_path = os.path.join(cfg.ensure_output_dir(), "utility_table.npz")
        if ckpt.utility_table_exists(table_path):
            restored = ckpt.resume_game(game, table_path, fingerprint=fp)
            if restored:
                logger.info(f"resumed {restored} coalition utilities from {table_path}")
        ckpt.checkpointed_game(game, table_path, fingerprint=fp, block=chunk or 8)

    timer = StepTimer()
    rng = np.random.default_rng(cfg.shapley.seed)
    with trace(cfg.obs.profile_dir, enabled=cfg.obs.profile):
        with timer.span("shapley_round"):
            shapley_value, _sv_se = run_configured_comp_contrib(
                game, cfg.shapley, rng=rng, logger=logger
            )
    # completed round -> one self-contained npz (consolidates the append-log)
    flush_table = getattr(game, "flush_table", None)
    if flush_table is not None:
        flush_table()
    stats = timer.summary()["shapley_round"]
    logger.info(
        f"Shapley round: {stats['total_s']:.2f}s, "
        f"{game.num_evaluations} distinct coalition evals "
        f"({game.num_evaluations / max(stats['total_s'], 1e-9):.2f}/s)"
    )
    if csv_logger is not None:
        timer.log_to(csv_logger, step=1)
        csv_logger.scalar_summary("shapley_round/coalition_evals", game.num_evaluations, 1)

    # the post-round FedAvg global overlay, exported to GLOBAL_MODEL_PATH
    # (the .env contract's third path: the FL loop reads the global model
    # from there); aggregated only when it is exported
    participating = [i for i, s in enumerate(selection) if s]
    if participating and cfg.paths.global_model_path:
        ratio = tm.fedavg_ratio([clients[i].num_local_data_train for i in participating])
        agg = tm.aggregate_deltas(
            tree_from_numpy(tm.tree_stack_host([deltas[i] for i in participating])), ratio
        )
        global_overlay = tm.apply_deltas(tm.tree_map(lambda a: a.cpu(), init_lora), agg)
        ingestion.save_lora_checkpoint(
            os.path.join(cfg.paths.global_model_path, "ViT_global.npz"), global_overlay, spec
        )

    for i in range(utility_dim):
        shapley_value_all_rounds[i].append(shapley_value[i])
        for cid, v in shapley_value[i].items():
            shapley_value_sum[i][cid] = shapley_value_sum[i].get(cid, 0.0) + v
    if csv_logger is not None:
        for i in range(utility_dim):
            csv_logger.log(["shapley_round1", i] + [shapley_value[i][c] for c in range(n)])
    if cfg.obs.use_tensorboard:
        tb = TensorBoardWriter(os.path.join(cfg.ensure_output_dir(), "tensorboard"))
        tb.log_round(
            1, shapley_value, se=_sv_se, utility=previous_utility,
            wall_s=stats["total_s"], evals=game.num_evaluations,
        )
        tb.close()
    return shapley_value_all_rounds, shapley_value_sum


def main(argv: Optional[List[str]] = None):
    """Console entry: the reference's mainShapley.py invocation — CLI flags
    + the .env path contract — on the card."""
    cfg = Config.from_args(sys.argv[1:] if argv is None else argv)
    cfg.paths = Config.from_env().paths
    start(cfg, device="cuda")
    return 0


def start(cfg: Optional[Config] = None, checkpoint_paths: Optional[List] = None, device=None):
    """Entry point (reference mainShapley.py -> start.py:248-331); runs on
    the card unless ``device="cpu"`` is passed."""
    cfg = cfg or Config.from_env()
    _refuse_unported(cfg)
    device = resolve_device(device)
    logger = get_logger()
    out_dir = cfg.ensure_output_dir()
    csv_logger = CSVLogger(out_dir, cfg.dist.dist_rank, cfg.obs.exp_id, cfg.data.mode)
    try:
        spec, base, init_lora = build_model(cfg, device=device)
        valid = load_validation_dataset(cfg, target_size=spec.image, device=device)
        logger.info(f"validation dataset: {len(valid)} images")

        n_trainable = tvit.trainable_params(init_lora)
        n_all = tvit.trainable_params(base) + n_trainable
        logger.info(
            f"trainable params: {n_trainable} || all params: {n_all} || "
            f"trainable%: {100 * n_trainable / n_all:.2f}"
        )
        return get_initial_shapley_value(
            cfg, valid, spec, base, init_lora,
            checkpoint_paths=checkpoint_paths, csv_logger=csv_logger, device=device,
        )
    finally:
        csv_logger.close()


if __name__ == "__main__":
    sys.exit(main())
