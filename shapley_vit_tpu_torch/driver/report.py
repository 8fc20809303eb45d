"""Round reporting: render Shapley results into CSV + plots.

The port of ``shapley_vit_tpu/driver/report.py`` (host code: CSV writers,
the single artifact worker thread, matplotlib plots imported lazily) and
the Grad-CAM overlays (``render_saliency``), whose saliency runs on the
device of the model's weights.

The reference's reporting is scattered prints plus offline plotly notebooks
(SURVEY.md §5 observability). This consolidates a round's outputs — per-client
SV per utility dim, the coalition-utility table, timing — into one artifact
directory: ``shapley_round.csv``, ``utility_table.csv``, ``sv_bar.png``,
``sv_rounds.png`` (when multiple rounds are given).
"""

from __future__ import annotations

import csv
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from shapley_vit_tpu_torch.utils.logging import UTILITY_NAMES  # noqa: F401 (re-export)

# Async plot rendering: matplotlib PNG rendering costs ~0.55 s/round — ~23%
# of a steady-state serve round (tools/serve_profile.py) — and nothing waits
# on the file. A single worker thread renders plots off the round loop; one
# worker (not a pool) serializes matplotlib, which is not re-entrant.
_PLOT_EXECUTOR = None
_PLOT_PENDING: List = []
_PLOT_LOCK = threading.Lock()


def submit_async_artifact(fn, *args, **kwargs):
    """Run an artifact job (plot render, checkpoint export) on the single
    ordered worker thread. One worker — matplotlib is not re-entrant, and
    ordering keeps per-round artifacts consistent on disk.

    Failures are LOGGED AT FAILURE TIME on the worker (an unbounded
    production service must see a dead disk every round, not at a return
    that never comes); :func:`flush_async_plots` additionally waits for and
    can re-raise them. Settled futures are pruned on each submit so the
    pending list stays bounded across an unbounded service — including
    FAILED ones beyond the most recent few: a failed future pins its
    arguments through the exception traceback (for the async global export,
    a whole overlay pytree), so retaining every failure across a
    persistently dead disk would grow RSS by an overlay per round."""
    global _PLOT_EXECUTOR
    from concurrent.futures import ThreadPoolExecutor

    name = getattr(fn, "__name__", str(fn))

    def run():
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            from shapley_vit_tpu_torch.utils.logging import get_logger

            get_logger().error(f"async artifact {name} failed: {e!r}")
            raise

    with _PLOT_LOCK:
        if _PLOT_EXECUTOR is None:
            _PLOT_EXECUTOR = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="svt-plot"
            )
        # prune settled-and-clean futures; keep only the most recent
        # failures for a later flush to surface (each was already logged
        # above, and each retains its args via the traceback — see
        # docstring)
        live = [f for f in _PLOT_PENDING if not f.done()]
        failed = [
            f for f in _PLOT_PENDING
            if f.done() and f.exception() is not None
        ]
        _PLOT_PENDING[:] = live + failed[-8:]
        fut = _PLOT_EXECUTOR.submit(run)
        _PLOT_PENDING.append(fut)
        return fut


_plot_async = submit_async_artifact


def pending_artifact_jobs() -> int:
    """Unfinished jobs on the artifact worker right now — the service
    exports this as a TB scalar so a backlogged worker (the round-4 soak's
    wall-creep mechanism: growing render jobs contending the tunnel with
    the next round's host digests) is visible in production, not just in
    offline soak runs."""
    with _PLOT_LOCK:
        return sum(1 for f in _PLOT_PENDING if not f.done())


def flush_async_plots(
    timeout: Optional[float] = None, raise_errors: bool = True
) -> int:
    """Block until every queued artifact job has finished (service
    shutdown / test determinism). Returns the number of failed jobs;
    ``raise_errors=True`` re-raises the first failure after draining (the
    serve loop passes False so one bad render cannot discard a completed
    run's records — failures were already logged per-job)."""
    with _PLOT_LOCK:
        pending, _PLOT_PENDING[:] = list(_PLOT_PENDING), []
    first_err = None
    failed = 0
    for fut in pending:
        try:
            fut.result(timeout=timeout)
        except Exception as e:
            failed += 1
            if first_err is None:
                first_err = e
    if first_err is not None and raise_errors:
        raise first_err
    return failed


def write_shapley_csv(
    path: str, shapley_value: Sequence[Dict[int, float]],
    round_idx: int = 0, append: bool = True,
) -> None:
    """Rows: round, utility_dim_name, client_id, sv."""
    new = not (append and os.path.exists(path))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a" if append else "w", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(["round", "utility", "client_id", "shapley_value"])
        for dim, sv in enumerate(shapley_value):
            name = UTILITY_NAMES.get(dim, str(dim))
            for cid in sorted(sv):
                w.writerow([round_idx, name, cid, sv[cid]])


def write_utility_table_csv(path: str, utility: Dict, utility_dim: int = 2) -> None:
    """Dump the Game memo: coalition members + per-dim utilities."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["coalition"] + [UTILITY_NAMES.get(i, str(i)) for i in range(utility_dim)])
        for key in sorted(utility, key=lambda k: (len(k), sorted(k))):
            w.writerow(["|".join(map(str, sorted(key)))] + list(utility[key]))


def plot_shapley_bar(
    shapley_value: Sequence[Dict[int, float]], save_path: str, title: str = "Shapley values",
    se: Optional[Sequence[Dict[int, float]]] = None,
) -> None:
    """Per-client grouped bars, one group color per utility dim.
    ``se`` (same structure) adds ±2σ whiskers so a bar whose whisker spans
    zero reads as "not significant at this sample budget"."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dims = len(shapley_value)
    clients = sorted(shapley_value[0])
    width = 0.8 / dims
    fig, ax = plt.subplots(figsize=(1.2 * len(clients) + 3, 4))
    for d in range(dims):
        xs = np.arange(len(clients)) + d * width
        yerr = [2 * se[d][c] for c in clients] if se is not None else None
        ax.bar(xs, [shapley_value[d][c] for c in clients], width=width,
               yerr=yerr, capsize=3 if yerr else 0,
               label=UTILITY_NAMES.get(d, str(d)))
    ax.set_xticks(np.arange(len(clients)) + 0.4 - width / 2)
    ax.set_xticklabels([f"client {c}" for c in clients])
    ax.axhline(0, color="k", linewidth=0.8)
    ax.set_title(title)
    ax.legend()
    ax.grid(alpha=0.3, axis="y")
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_shapley_rounds(
    per_round: Sequence[Sequence[Dict[int, float]]], save_path: str, dim: int = 0,
) -> None:
    """SV trajectory across rounds for one utility dim (one line per client)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # union across rounds: a straggler skipped in round 0 but present later
    # must still get a trajectory line (absent rounds plot as 0.0)
    clients = sorted({c for sv in per_round for c in sv[dim]})
    fig, ax = plt.subplots(figsize=(6, 4))
    for c in clients:
        ax.plot(
            range(len(per_round)), [sv[dim].get(c, 0.0) for sv in per_round],
            marker="o", label=f"client {c}",
        )
    ax.set_xlabel("round")
    ax.set_ylabel(f"SV ({UTILITY_NAMES.get(dim, dim)})")
    ax.legend()
    ax.grid(alpha=0.3)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def render_round_report(
    out_dir: str,
    shapley_value: Sequence[Dict[int, float]],
    game=None,
    round_idx: int = 0,
    timer=None,
    se: Optional[Sequence[Dict[int, float]]] = None,
    render_plots: bool = True,
    plots_async: bool = False,
) -> List[str]:
    """One call per round; returns created artifact paths.
    ``render_plots=False`` skips the PNG (matplotlib costs ~0.55 s/round —
    the largest non-eval cost of a steady-state serve round); CSVs are
    always written. ``plots_async=True`` queues the PNG on the plot worker
    thread instead (the serve loop's default — nothing waits on plots); the
    returned path exists once :func:`flush_async_plots` drains."""
    paths = []
    p = os.path.join(out_dir, "shapley_round.csv")
    write_shapley_csv(p, shapley_value, round_idx)
    paths.append(p)
    if game is not None and game.utility:
        p = os.path.join(out_dir, f"utility_table_r{round_idx}.csv")
        write_utility_table_csv(p, game.utility, game.utility_dim)
        paths.append(p)
    if render_plots:
        p = os.path.join(out_dir, f"sv_bar_r{round_idx}.png")
        render = plot_shapley_bar if not plots_async else (
            lambda *a, **kw: _plot_async(plot_shapley_bar, *a, **kw)
        )
        render(
            shapley_value, p, title=f"Shapley values — round {round_idx}", se=se
        )
        paths.append(p)
    if timer is not None:
        p = os.path.join(out_dir, f"timing_r{round_idx}.csv")
        with open(p, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["span", "count", "total_s", "mean_s", "max_s"])
            for name, s in timer.summary().items():
                w.writerow([name, s.get("count"), s.get("total_s"), s.get("mean_s"), s.get("max_s")])
        paths.append(p)
    return paths


def saliency_overlays(base, lora, images, spec, round_idx: int = 0, k: int = 4,
                      method: str = "grad_cam", tb=None):
    """The device half of :func:`render_saliency`, on the caller's thread:
    the saliency maps of the first ``k`` images by ``grad_cam`` (or
    ``attention_rollout``) on the base's device, upsampled to the image
    size by ``np.kron``; with an active ``tb``, the numpy blends as image
    events ``saliency/{method}/img_{i}``. Returns (images [k, H, W, C],
    maps [k, H, W]) as float32 numpy."""
    import torch

    from shapley_vit_tpu_torch.models import interpret

    imgs = np.asarray(images[:k], dtype=np.float32)
    fn = interpret.grad_cam if method == "grad_cam" else interpret.attention_rollout
    device = base["patch_embed"]["kernel"].device
    sal = fn(base, lora, torch.as_tensor(imgs, device=device), spec).float().cpu().numpy()
    scale = imgs.shape[1] // sal.shape[1]
    sal_up = np.kron(sal, np.ones((1, scale, scale)))

    if tb is not None and getattr(tb, "active", False):
        # native TB image events of the blended overlays: pure numpy, no
        # matplotlib on this thread
        for i, (img, s) in enumerate(zip(imgs, sal_up)):
            rng = float(s.max() - s.min())
            s_n = (s - s.min()) / rng if rng > 0 else np.zeros_like(s)
            heat = np.stack([s_n, np.zeros_like(s_n), 1.0 - s_n], axis=-1)
            shown = np.clip(img, 0.0, 1.0)
            if shown.ndim == 2:
                shown = shown[:, :, None]
            if shown.shape[-1] == 1:
                shown = np.repeat(shown, 3, axis=-1)
            tb.add_image(
                f"saliency/{method}/img_{i}",
                np.clip(0.6 * shown + 0.4 * heat, 0.0, 1.0),
                round_idx,
            )
    return imgs, sal_up


def render_saliency(
    out_dir: str,
    base,
    lora,
    images,
    spec,
    round_idx: int = 0,
    k: int = 4,
    method: str = "grad_cam",
    tb=None,
) -> str:
    """Grad-CAM (or attention-rollout) overlays of the round's global model
    on ``k`` validation images (the backend for the reference's
    ``--use-grad-cam`` / ``--sal-image-fname-dir`` flags, opts.py:70-72).
    Synchronous and opt-in.

    Two-thread split: the device compute (:func:`saliency_overlays`) stays
    on the caller's thread, while the matplotlib render of
    ``saliency_r{round_idx}.png`` runs ON the single artifact worker and is
    waited for: serve() queues its bar/trajectory plots on that same worker,
    and pyplot's global figure state is not re-entrant. Without matplotlib
    the render raises ``ImportError``."""
    imgs, sal_up = saliency_overlays(base, lora, images, spec, round_idx=round_idx, k=k,
                                     method=method, tb=tb)

    def _render() -> str:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, len(imgs), figsize=(2.4 * len(imgs), 2.6))
        if len(imgs) == 1:
            axes = [axes]
        for ax, img, s in zip(axes, imgs, sal_up):
            shown = img.squeeze()
            ax.imshow(
                np.clip(shown, 0, 1), cmap="gray" if shown.ndim == 2 else None
            )
            ax.imshow(s, cmap="jet", alpha=0.4)
            ax.axis("off")
        fig.suptitle(f"{method} — round {round_idx} global model")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"saliency_r{round_idx}.png")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path

    return submit_async_artifact(_render).result()
