"""Typed configuration tree for shapley_vit_tpu_torch.

A copy of ``shapley_vit_tpu/config.py``: the port imports nothing of the JAX
package, so it keeps its own copy of this stdlib-only module. The field
names, defaults and flag surface are the same, so one ``Config`` drives
either package, plus one field of the port's own: ``train.remat``
(``--remat``), which the client driver honours.

Replaces the reference's import-side-effect argparse singleton
(``shapleyserver/opts.py:6-110``) with a pure dataclass tree: nothing happens at
import time, no directories are created until :meth:`Config.ensure_output_dir` is
called, and model code receives config explicitly instead of importing a global.

The public flag surface of ``opts.py`` is preserved verbatim in
:func:`build_arg_parser` (same ``--flag`` spellings, same defaults), and the three
``.env`` path variables consumed by ``shapleyserver/start.py:22-27``
(``LOCAL_MODEL_PATH``, ``GLOBAL_MODEL_PATH``, ``VALIDATION_DATASET``) are honoured
by :func:`Config.from_env`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence


def _parse_env_file(path: str) -> dict:
    """Minimal ``.env`` parser (KEY=VALUE lines, '#' comments) — avoids a
    python-dotenv dependency while keeping file-format compatibility with the
    reference's ``.env`` (reference root ``.env:1-3``)."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            out[key.strip()] = value.strip().strip("'\"")
    return out


@dataclass
class PathsConfig:
    """The three .env-sourced paths (reference start.py:26-28)."""

    local_model_path: Optional[str] = None
    global_model_path: Optional[str] = None
    validation_dataset: Optional[str] = None
    # persistent XLA compilation cache for the long-running drivers; also
    # settable via $SVT_COMPILE_CACHE (utils/runtime.py). None = off.
    compile_cache_dir: Optional[str] = None


@dataclass
class DistConfig:
    """Multi-party / multi-host topology (reference opts.py:22-25 — flags only
    there; here they actually drive ``jax.distributed`` + mesh construction)."""

    dist_num: int = 3          # number of parties (FL clients)
    dist_rank: int = 0
    master_addr: str = "127.0.0.1"
    master_port: int = 29500
    # TPU mesh axes for coalition-sharded evaluation. n_coalition_shards *
    # n_data_shards must divide the device count when a mesh is built.
    mesh_coalition_axis: str = "coalition"
    mesh_data_axis: str = "data"
    # Driver sharding gate (parallel.coalition_eval.make_eval_backend):
    # "auto" = shard coalition evaluation over ALL visible devices whenever
    # more than one is present (the reference's always-on nn.DataParallel,
    # start.py:283, done TPU-right); "off" = force the single-chip evaluator.
    mesh: str = "auto"
    # coalition-axis size of the driver mesh; 0 = auto-select from the
    # workload (parallel.autoshape: minimal padded work, then largest
    # per-device batch, memory-filtered — the drivers pass hints; callers
    # without hints get pure data-parallel). >=1 forces that split.
    mesh_coalition_shards: int = 0


@dataclass
class TrainConfig:
    """Training hyperparameters (reference opts.py:37-41)."""

    lr: float = 3e-1
    epochs: int = 250
    train_batch: int = 8
    batch_size: int = 32
    epoch_st: int = 0
    epoch_end: int = 250
    save_interval: int = 1
    resume: bool = False
    load_model: Optional[str] = None
    snapshot_fname_prefix: str = ""
    # DP noise (reference opts.py:87). The reference DEFAULT is 0.5 with no
    # consumer; DP-SGD is therefore gated on the explicit use_dp opt-in
    # (a >0 multiplier alone must not silently switch optimizers)
    noise_multiplier: float = 0.5
    use_dp: bool = False
    # Label-flipping poisoning fixture (reference client.py:53-59)
    label_flip_prob: float = 0.0
    # recompute each ViT block's activations in the client's backward
    # instead of keeping them (ViTSpec.remat): less card memory, one more
    # forward per step. The port's own field; the JAX Config has none
    remat: bool = False


@dataclass
class DataConfig:
    """Data layer config (reference opts.py:63-66, 83)."""

    dataset_type: str = "x-ray"
    data_dir: str = ""
    data_sub_dir: Optional[str] = None
    patch_size: int = 256
    mode: str = "train"
    num_classes: int = 4
    image_size: int = 224
    eval_batch_size: int = 128   # reference start.py:84
    num_workers: int = 1
    use_whole_dataset: bool = False
    clear_cache: bool = False
    # scale factor for synthetic stand-in datasets (1.0 = full-size val set)
    synthetic_scale: float = 1.0


@dataclass
class ModelConfig:
    """Model selection + LoRA (reference opts.py:68; start.py:258-276)."""

    model_type: str = "ViT"
    vit_variant: str = "base"      # tiny | small | base | large
    patch: int = 16
    num_classes: int = 4
    # LoRA: r=16, alpha=8, targets q,v + trainable classifier (start.py:274-276)
    lora_r: int = 16
    lora_alpha: float = 8.0
    lora_dropout: float = 0.05
    lora_targets: Sequence[str] = ("query", "value")
    modules_to_save: Sequence[str] = ("classifier",)
    # Numerics: bf16 compute + f32 accumulation on TPU; 'highest' for parity runs
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    matmul_precision: str = "default"
    # GELU flavor: exact_f32 (HF parity) | exact | tanh (fast TPU eval)
    gelu: str = "exact_f32"
    # matmul quantization: none | int8 (dynamic W8A8 on q/k/v/fc1 — the
    # measured-best target set; +8% eval throughput on v5e with 100%
    # trained-model argmax agreement, tools/quant_agreement.py).
    # DEFAULT DECISION (round 5, VERDICT #5): measured IN the production
    # serve loop at n=32 (tools/serve_soak.py --quant int8) int8 is ~10%
    # faster per round (shapley span ~13.1 s vs ~14.5 s bf16), but the
    # default stays "none": int8 perturbs the LOSS-dim utilities beyond
    # the 1e-4 SV parity bar vs the f32 torch reference (the accuracy dim
    # is argmax-faithful on trained weights), and reference parity is the
    # default contract. Opt in for production serving where the SV
    # consumer cares about ranking/accuracy-dim attribution:
    # SVT_QUANT=int8 or cfg.model.quant="int8" (BENCH_NOTES round 5).
    quant: str = "none"
    # coalition-eval execution mode: "merged" folds each coalition's LoRA
    # into dense q/v kernels before the forward (bench.py's fastest config;
    # +9% over the overlay path at the service protocol,
    # tools/merged_probe.py) — "overlay" keeps the rank-16 two-matmul path
    # (the pre-round-3 behavior; also what non-LoRA/full-delta configs use)
    eval_mode: str = "merged"


@dataclass
class ShapleyConfig:
    """Shapley-game config (reference game2.py / utils_shapley.py)."""

    num_clients: int = 3                   # reference start.py:101, game2.py:25
    utility_dim: int = 2                   # acc + loss (game2.py:30)
    method: str = "comp_contrib"           # utils_shapley.py:14
    samples_per_client: int = 50           # m = 50 * n (utils_shapley.py:16)
    seed: int = 0                          # explicit PRNG (ref is unseeded)
    # comp-contrib split-point allocation: uniform (reference parity) |
    # balanced | neyman — variance reduction at equal eval budget
    # (shapley/estimators.py, tools/sample_efficiency.py)
    cc_stratify: str = "uniform"
    # when > 0, replace the fixed m = 50n budget with the adaptive
    # estimator: sample until every client's SV standard error is <=
    # target_se (shapley_comp_contrib_adaptive); bounded by
    # samples_per_client * n * 10
    target_se: float = 0.0
    # coalition eval execution
    coalition_chunk: int = 0               # 0 = no chunking of the coalition axis
    persist_utility_table: bool = True     # resumable rounds (ref memo is RAM-only)
    # retention for per-epoch utility tables: a table is only ever read to
    # resume ITS OWN epoch, so completed epochs' tables are dead weight —
    # keep the most recent K behind the cursor (debugging), delete older.
    # 0 = keep everything (pre-round-4 behavior)
    keep_utility_tables: int = 2


@dataclass
class ObservabilityConfig:
    """Logging/plot/experiment-dir knobs (reference opts.py:27-31, 45-48, 70-72)."""

    exp_id: str = "default"
    exp_dir: str = "exp"
    use_tensorboard: bool = False
    use_vis: bool = False
    plot_server: str = "http://127.0.0.1"
    plot_port: int = 31831
    exp_name: str = "shapley_vit_tpu"
    debug: bool = False
    profile: bool = False                  # torch.profiler trace per Shapley round
    profile_dir: str = "exp/profile"
    # per-round PNG rendering costs ~0.55 s/round (matplotlib) — the largest
    # non-eval cost of a steady-state serve round (tools/serve_profile.py);
    # CSV artifacts are always written
    render_plots: bool = True
    # render the per-round PNG on a worker thread so the serve loop never
    # waits on matplotlib (driver/report.flush_async_plots drains at stop)
    render_plots_async: bool = True
    # Grad-CAM saliency overlays of the round's global model on sample
    # validation images (reference opts.py:70-72 flags with no in-repo
    # consumer; models/interpret.grad_cam is the real backend here)
    use_grad_cam: bool = False
    sal_image_dir: str = "exps/"


@dataclass
class AdversarialConfig:
    """Adversarial-eval / defense flags (reference opts.py:74-81)."""

    epsilon: float = 0.0
    adv_dataset_mode: str = "train"
    requires_control: bool = False
    is_defense: bool = False
    use_clean_eval: bool = False
    use_multi_epsilon: bool = False


@dataclass
class Config:
    """Root config tree."""

    paths: PathsConfig = field(default_factory=PathsConfig)
    dist: DistConfig = field(default_factory=DistConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    shapley: ShapleyConfig = field(default_factory=ShapleyConfig)
    obs: ObservabilityConfig = field(default_factory=ObservabilityConfig)
    adv: AdversarialConfig = field(default_factory=AdversarialConfig)
    no_fl: bool = True                     # reference opts.py:18-20
    test: bool = False
    eval: bool = False
    demo: str = ""

    # ---- derived -------------------------------------------------------------

    @property
    def output_dir(self) -> str:
        return os.path.join(self.obs.exp_dir, self.obs.exp_id)

    def ensure_output_dir(self) -> str:
        os.makedirs(self.output_dir, exist_ok=True)
        return self.output_dir

    # ---- construction --------------------------------------------------------

    @classmethod
    def from_env(cls, env_file: str = ".env", **overrides: Any) -> "Config":
        """Build a config honouring the reference's `.env` contract
        (start.py:22-28): real environment variables win over the env file."""
        file_vars = _parse_env_file(env_file)

        def get(name: str) -> Optional[str]:
            return os.environ.get(name, file_vars.get(name))

        cfg = cls(**overrides)
        cfg.paths.local_model_path = get("LOCAL_MODEL_PATH")
        cfg.paths.global_model_path = get("GLOBAL_MODEL_PATH")
        cfg.paths.validation_dataset = get("VALIDATION_DATASET")
        cfg.paths.compile_cache_dir = get("SVT_COMPILE_CACHE")
        # production fast-eval opt-in (see ModelConfig.quant: int8 is ~10%
        # faster per serve round at n=32, accuracy-dim faithful; default
        # stays f32/bf16 for reference SV parity)
        quant = get("SVT_QUANT")
        if quant:
            if quant not in ("none", "int8"):
                raise ValueError(f"SVT_QUANT must be none|int8, got {quant!r}")
            cfg.model.quant = quant
        return cfg

    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None) -> "Config":
        """Parse the reference's CLI flag surface into the typed tree."""
        ns = build_arg_parser().parse_args(argv)
        cfg = cls()
        cfg.no_fl = ns.no_fl
        cfg.test = ns.test
        cfg.eval = ns.eval
        cfg.demo = ns.demo
        d = cfg.dist
        d.dist_num, d.dist_rank = ns.dist_num, ns.dist_rank
        d.master_addr, d.master_port = ns.master_addr, ns.master_port
        t = cfg.train
        t.lr, t.epochs, t.train_batch, t.batch_size = ns.lr, ns.epochs, ns.trainBatch, ns.batch_size
        t.epoch_st, t.epoch_end = ns.epoch_st, ns.epoch_end
        t.save_interval = ns.save_interval
        t.resume, t.load_model = ns.resume, ns.loadModel
        t.snapshot_fname_prefix = ns.snapshot_fname_prefix
        t.noise_multiplier = ns.noise_multiplier
        t.use_dp, t.label_flip_prob = ns.use_dp, ns.label_flip_prob
        t.remat = ns.remat
        da = cfg.data
        da.dataset_type, da.data_dir = ns.dataset_type, ns.data_dir
        da.data_sub_dir, da.patch_size, da.mode = ns.data_sub_dir, ns.patch_size, ns.mode
        da.use_whole_dataset, da.clear_cache = ns.use_whole_dataset, ns.clear_cache
        cfg.model.model_type = ns.model_type
        o = cfg.obs
        o.exp_id, o.exp_dir, o.exp_name = ns.exp_id, ns.exp_dir, ns.exp_name
        o.use_tensorboard, o.use_vis, o.debug = ns.use_tensorboard, ns.use_vis, ns.debug
        o.plot_server, o.plot_port = ns.plot_server, ns.plot_port
        o.use_grad_cam, o.sal_image_dir = ns.use_grad_cam, ns.sal_image_fname_dir
        a = cfg.adv
        a.epsilon, a.adv_dataset_mode = ns.epsilon, ns.adv_dataset_mode
        a.requires_control, a.is_defense = ns.requires_control, ns.is_defense
        a.use_clean_eval, a.use_multi_epsilon = ns.use_clean_eval, ns.use_multi_epsilon
        cfg.shapley.num_clients = ns.dist_num
        return cfg

    # ---- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def log_lines(self) -> list:
        """Flat 'key,value' lines matching Opts.log() output shape (opts.py:92-105)."""
        lines = []

        def walk(prefix: str, obj: Any):
            if dataclasses.is_dataclass(obj):
                for f in dataclasses.fields(obj):
                    walk(f"{prefix}{f.name}.", getattr(obj, f.name))
            else:
                lines.append(f"{prefix[:-1]},{obj}")

        walk("", self)
        return sorted(lines)


def build_arg_parser() -> argparse.ArgumentParser:
    """The reference's exact public flag surface (opts.py:16-90)."""
    p = argparse.ArgumentParser(description="shapley_vit_tpu")
    p.add_argument("--fl", dest="no_fl", action="store_false", help="use fl")
    p.add_argument("--no-fl", dest="no_fl", action="store_true", help="no fl")
    p.set_defaults(no_fl=True)
    p.add_argument("--dist-num", "--dist_num", type=int, default=3)
    p.add_argument("--dist-rank", "--dist_rank", type=int, default=0)
    p.add_argument("--master-addr", "--master_addr", type=str, default="127.0.0.1")
    p.add_argument("--master-port", "--master_port", type=int, default=29500)
    p.add_argument("--exp-id", "--exp_id", default="default")
    p.add_argument("--exp-dir", "--exp_dir", default="exp")
    p.add_argument("-test", action="store_true")
    p.add_argument("-demo", default="")
    p.add_argument("-resume", default=False, type=bool, metavar="BOOL")
    p.add_argument("-loadModel", default=None)
    p.add_argument("-lr", type=float, default=3e-1)
    p.add_argument("-epochs", type=int, default=250)
    p.add_argument("-trainBatch", type=int, default=8)
    p.add_argument("--batch-size", "--batch_size", type=int, default=32)
    p.add_argument("--clear-cache", "--clear_cache", default=False, type=bool, metavar="BOOL")
    p.add_argument("--plot-server", "--plot_server", type=str, default="http://127.0.0.1")
    p.add_argument("--exp-name", "--exp_name", type=str, default="shapley_vit_tpu")
    p.add_argument("--plot-port", "--plot_port", type=int, default=31831)
    p.add_argument("--save-interval", "--save_interval", type=int, default=1)
    p.add_argument("--snapshot-fname-prefix", "--snapshot_fname_prefix", default="", type=str, metavar="PATH")
    p.add_argument("--sal-image-fname-dir", "--sal_image_fname_dir", default="exps/", type=str, metavar="PATH")
    p.add_argument("--epoch-st", "--epoch_st", default=0, type=int)
    p.add_argument("--epoch-end", "--epoch_end", default=250, type=int)
    p.add_argument("--debug", dest="debug", action="store_true", default=False)
    p.add_argument("--eval", dest="eval", action="store_true", default=False)
    p.add_argument("--use-vis", "--use_vis", dest="use_vis", action="store_true", default=False)
    p.add_argument("--mode", type=str, default="train")
    p.add_argument("--patch-size", "--patch_size", type=int, default=256)
    p.add_argument("--data-dir", "--data_dir", type=str, default="")
    p.add_argument("--data-sub-dir", "--data_sub_dir", type=str, default=None)
    p.add_argument("--model-type", "--model_type", type=str, default="ViT")
    p.add_argument("--use-grad-cam", "--use_grad_cam", dest="use_grad_cam", action="store_true", default=False)
    p.add_argument("--use-tensorboard", "--use_tensorboard", dest="use_tensorboard", action="store_true", default=False)
    p.add_argument("--use-grad-cam-layers", "--use_grad_cam_layers", dest="use_grad_cam_layers", action="store_true", default=False)
    p.add_argument("--epsilon", type=float, default=0)
    p.add_argument("--adv-dataset-mode", "--adv_dataset_mode", type=str, default="train")
    p.add_argument("--requires-control", "--requires_control", dest="requires_control", action="store_true", default=False)
    p.add_argument("--is-defense", "--is_defense", dest="is_defense", action="store_true", default=False)
    p.add_argument("--use-clean-eval", "--use_clean_eval", dest="use_clean_eval", action="store_true", default=False)
    p.add_argument("--use-multi-epsilon", "--use_multi_epsilon", dest="use_multi_epsilon", action="store_true", default=False)
    p.add_argument("--dataset-type", "--dataset_type", type=str, default="x-ray")
    p.add_argument("--num-of-tasks", "--num_of_tasks", type=int, default=14)
    p.add_argument("--use-whole-dataset", "--use_whole_dataset", dest="use_whole_dataset", action="store_true", default=False)
    p.add_argument("--noise-multiplier", "--noise_multiplier", type=float, default=0.5)
    # framework extensions (not in the reference opts.py): the reference's
    # --noise-multiplier has no in-repo consumer, so DP-SGD is gated on an
    # explicit opt-in, and the v1 client's label_flip_prob (client.py:53-59)
    # gets a CLI knob — without these, svt-client could never reach either
    # path from the command line
    p.add_argument("--use-dp", "--use_dp", dest="use_dp",
                   action="store_true", default=False)
    p.add_argument("--label-flip-prob", "--label_flip_prob",
                   dest="label_flip_prob", type=float, default=0.0)
    # the port's own: per-block rematerialization in the client's training
    p.add_argument("--remat", dest="remat", action="store_true", default=False)
    return p
