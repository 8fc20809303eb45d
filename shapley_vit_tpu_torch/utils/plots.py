"""Plot helpers: learning-curve series and error-band report plots (a copy
of ``shapley_vit_tpu/utils/plots.py``).

Reference: matplotlib ``plot_series``/``plot_series_mul`` + monotone curve
(federated_learning/utils.py:1045-1131) and the plotly error-band report
family (``line`` extension, ``mean_std_df``, ``nice_plot``,
``nice_plot_multi_columns``, bar variants — utils_plot.py:5-244).
matplotlib is imported only when a helper draws, so the module imports
where it is not installed; plotly is used only where it is installed, and
without it the ``nice_plot`` family renders the same mean±std bands with
matplotlib ``fill_between``.
The dataframe contracts (group/aggregate column naming) match the
reference; the frames come from the caller (pandas is never imported
here).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _plotly():
    """plotly.graph_objects, or None where plotly is not installed: the
    interactive backend is gated (reference utils_plot.py is plotly-only)."""
    try:
        import plotly.graph_objects as go

        return go
    except ImportError:
        return None


def _plotly_error_band_figure(go, groups, x_axis, y_axis, title, y_label):
    """The reference's error-band ``line`` extension (utils_plot.py:5-44):
    per group a mean trace plus a translucent upper/lower band."""
    fig = go.Figure()
    for name, agg in groups:
        label = str(name) if name is not None else y_axis
        fig.add_trace(
            go.Scatter(x=list(agg[x_axis]), y=list(agg["mean"]),
                       mode="lines", name=label)
        )
        if agg["std"].notna().any():
            std = agg["std"].fillna(0)
            fig.add_trace(
                go.Scatter(
                    x=list(agg[x_axis]) + list(agg[x_axis])[::-1],
                    y=list(agg["mean"] + std) + list((agg["mean"] - std))[::-1],
                    fill="toself", opacity=0.3, line=dict(width=0),
                    showlegend=False, name=f"{label} ±std",
                )
            )
    fig.update_layout(title=title, xaxis_title=x_axis,
                      yaxis_title=y_label or y_axis)
    return fig


# ---------------------------------------------------------------------------
# series plots (utils.py:1045-1131)
# ---------------------------------------------------------------------------

def plot_series(
    series: Sequence[float], y_min=None, y_max=None, title="Test acc", step: int = 1,
    save: bool = False, save_path: Optional[str] = None,
):
    """Single learning curve (utils.py:1079-1101)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 4))
    xs = np.arange(len(series)) * step
    ax.plot(xs, list(series))
    if y_min is not None or y_max is not None:
        ax.set_ylim(y_min, y_max)
    ax.set_title(title)
    ax.set_xlabel("epoch")
    ax.grid(alpha=0.3)
    if save and save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_series_mul(
    series_list: Sequence[Sequence[float]], y_min=None, y_max=None,
    title="Test acc", step: int = 1, save: bool = False,
    save_path: Optional[str] = None, labels: Optional[Sequence[str]] = None,
):
    """Multiple curves on one axis (utils.py:1045-1077)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, series in enumerate(series_list):
        xs = np.arange(len(series)) * step
        label = labels[i] if labels else f"run {i}"
        ax.plot(xs, list(series), label=label)
    if y_min is not None or y_max is not None:
        ax.set_ylim(y_min, y_max)
    ax.set_title(title)
    ax.set_xlabel("epoch")
    ax.legend()
    ax.grid(alpha=0.3)
    if save and save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return fig


def monotone_curve(series: Sequence[float]) -> np.ndarray:
    """Running best (the monotone learning curve of utils.py:1104-1112)."""
    return np.maximum.accumulate(np.asarray(series, dtype=float))


# ---------------------------------------------------------------------------
# report plots (utils_plot.py)
# ---------------------------------------------------------------------------

def mean_std_df(df, group_columns, columns_to_agg):
    """Group + mean/std aggregate with flattened '<col>_mean'/'<col>_std'
    column names (utils_plot.py:47-50)."""
    xdf = df.groupby(group_columns).agg(
        {column: ["mean", "std"] for column in columns_to_agg}
    )
    xdf.columns = xdf.columns.map("_".join)
    return xdf.reset_index()


def nice_plot(
    df, x_axis: str, y_axis: str, group_by: Optional[str] = None,
    error_band: bool = True, title: str = "", save_path: Optional[str] = None,
    y_label: Optional[str] = None, backend: str = "auto",
):
    """Mean±std error-band line plot per group (utils_plot.py:132-244).

    ``backend``: 'auto' uses plotly (interactive HTML, the reference's
    medium) when importable and falls back to matplotlib; 'plotly' requires
    it; 'matplotlib' forces the static render. With plotly, an ``.html``
    ``save_path`` writes a self-contained interactive file.
    """
    assert x_axis in df.columns and y_axis in df.columns
    if backend in ("auto", "plotly"):
        go = _plotly()
        if go is None and backend == "plotly":
            raise ImportError("backend='plotly' requested but plotly is not installed")
        # 'auto' uses plotly only for interactive outputs (no file, or .html);
        # raster save paths need kaleido, which plotly installs don't imply —
        # matplotlib keeps serving .png et al. exactly as before
        if backend == "auto" and save_path and not str(save_path).endswith(".html"):
            go = None
        if go is not None:
            groups = [(None, df)] if group_by is None else list(df.groupby(group_by))
            aggs = [
                (name, g.groupby(x_axis)[y_axis].agg(["mean", "std"]).reset_index())
                for name, g in groups
            ]
            if not error_band:
                for _, agg in aggs:
                    agg["std"] = np.nan
            fig = _plotly_error_band_figure(go, aggs, x_axis, y_axis, title, y_label)
            if save_path:
                if str(save_path).endswith(".html"):
                    fig.write_html(save_path)
                else:
                    fig.write_image(save_path)
            return fig
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    groups = [(None, df)] if group_by is None else list(df.groupby(group_by))
    for name, g in groups:
        agg = g.groupby(x_axis)[y_axis].agg(["mean", "std"]).reset_index()
        label = str(name) if name is not None else y_axis
        (line,) = ax.plot(agg[x_axis], agg["mean"], label=label)
        if error_band and agg["std"].notna().any():
            ax.fill_between(
                agg[x_axis], agg["mean"] - agg["std"].fillna(0),
                agg["mean"] + agg["std"].fillna(0),
                alpha=0.3, color=line.get_color(), linewidth=0,
            )
    ax.set_xlabel(x_axis)
    ax.set_ylabel(y_label or y_axis)
    ax.set_title(title)
    if group_by is not None:
        ax.legend(title=group_by)
    ax.grid(alpha=0.3)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return fig


def nice_plot_multi_columns(
    df, x_axis: str, y_axes: Sequence[str], error_band: bool = True,
    title: str = "", save_path: Optional[str] = None,
):
    """One error-band line per metric column (utils_plot.py:66-129)."""
    plt = _mpl()
    assert x_axis in df.columns
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for y_axis in y_axes:
        assert y_axis in df.columns
        agg = df.groupby(x_axis)[y_axis].agg(["mean", "std"]).reset_index()
        (line,) = ax.plot(agg[x_axis], agg["mean"], label=y_axis)
        if error_band and agg["std"].notna().any():
            ax.fill_between(
                agg[x_axis], agg["mean"] - agg["std"].fillna(0),
                agg["mean"] + agg["std"].fillna(0),
                alpha=0.3, color=line.get_color(), linewidth=0,
            )
    ax.set_xlabel(x_axis)
    ax.set_title(title)
    ax.legend()
    ax.grid(alpha=0.3)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return fig


def nice_bar(
    df, x_axis: str, y_axis: str, group_by: Optional[str] = None,
    title: str = "", save_path: Optional[str] = None,
):
    """Grouped bar chart with std error bars (utils_plot.py bar variants)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    if group_by is None:
        agg = df.groupby(x_axis)[y_axis].agg(["mean", "std"]).reset_index()
        ax.bar(agg[x_axis].astype(str), agg["mean"], yerr=agg["std"].fillna(0), capsize=3)
    else:
        cats = sorted(df[x_axis].unique())
        groups = sorted(df[group_by].unique())
        width = 0.8 / len(groups)
        for gi, gname in enumerate(groups):
            g = df[df[group_by] == gname]
            agg = g.groupby(x_axis)[y_axis].agg(["mean", "std"]).reindex(cats).reset_index()
            xs = np.arange(len(cats)) + gi * width
            ax.bar(xs, agg["mean"], width=width, yerr=agg["std"].fillna(0),
                   capsize=3, label=str(gname))
        ax.set_xticks(np.arange(len(cats)) + 0.4 - width / 2)
        ax.set_xticklabels([str(c) for c in cats])
        ax.legend(title=group_by)
    ax.set_xlabel(x_axis)
    ax.set_ylabel(y_axis)
    ax.set_title(title)
    ax.grid(alpha=0.3, axis="y")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_client_histogram(labels, client_idcs, num_classes: int, save_path=None):
    """Per-client label histogram (utils.py:502-509 show_data_histogram_client)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(12, 3))
    data = [np.asarray(labels)[idcs] for idcs in client_idcs.values()] if isinstance(
        client_idcs, dict
    ) else [np.asarray(labels)[idcs] for idcs in client_idcs]
    ax.hist(
        data, stacked=True,
        bins=np.arange(-0.5, num_classes + 0.5, 1),
        label=[f"Client {i}" for i in range(len(data))],
    )
    ax.set_xticks(np.arange(num_classes))
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return fig
