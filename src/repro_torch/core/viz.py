"""Visualization support (paper §V), rendered with matplotlib (Agg).

The paper's Bokeh views map 1:1 onto these functions; each returns the
matplotlib Axes (and saves to ``save`` when given) so examples/benchmarks can
emit the same figures as the paper: timeline (Figs. 8-10), time profile
(Fig. 2), comm matrix (Fig. 3), comm by process (Fig. 6), message histogram
(Fig. 4), multirun stacked bars (Figs. 12-13).

Mirrors :mod:`repro.core.viz`, with one difference: matplotlib is imported
when a plot is first drawn, not with the module, so ``import repro_torch``
works where matplotlib is not installed, and a plot there raises an
ImportError that says so.  The plots read the trace's ops on the trace's
device.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from .constants import DEPTH, ENTER, ET, MATCH, MPI_SEND, NAME, PROC, TS
from .frame import EventFrame


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported on first use."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "repro_torch's plot_* functions need matplotlib, which is not "
            "installed; the analysis ops themselves do not") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


@functools.lru_cache(maxsize=1)
def _cmap():
    return _pyplot().get_cmap("tab20")


def _color(i: int):
    return _cmap()(i % 20)


def plot_timeline(trace, x_start: Optional[float] = None, x_end: Optional[float] = None,
                  show_messages: bool = True, show_critical_path: bool = False,
                  max_functions: int = 19, ax=None, save: Optional[str] = None):
    """Events-over-time view: bars per call offset by depth, arrows per message."""
    plt = _pyplot()
    trace._ensure_structure()
    ev = trace.events
    ts = np.asarray(ev[TS], np.float64)
    match = np.asarray(ev.column(MATCH), np.int64)
    depth = np.asarray(ev.column(DEPTH), np.int64)
    procs = np.asarray(ev[PROC], np.int64)
    names = ev.codes(NAME)
    cats = ev.cat(NAME).categories

    if x_start is None:
        x_start = float(ts.min())
    if x_end is None:
        x_end = float(ts.max())

    if ax is None:
        _, ax = plt.subplots(figsize=(12, 0.6 * (trace.num_processes + 2) + 1))

    is_enter = ev.cat(ET).mask_eq(ENTER)
    sel = np.nonzero(is_enter & (match >= 0))[0]
    s, e = ts[sel], ts[match[sel]]
    vis = (e >= x_start) & (s <= x_end)
    sel, s, e = sel[vis], s[vis], e[vis]

    # color by function, rank functions by total time for a stable legend
    tot = np.zeros(len(cats))
    np.add.at(tot, names[sel], e - s)
    rank = np.argsort(-tot, kind="stable")
    color_of = np.full(len(cats), max_functions, np.int64)
    color_of[rank[:max_functions]] = np.arange(min(max_functions, len(rank)))

    lane = procs[sel].astype(np.float64) + 0.08 * np.minimum(depth[sel], 8)
    for i, row in enumerate(sel):
        ax.barh(lane[i], e[i] - s[i], left=s[i], height=0.35,
                color=_color(color_of[names[row]]), edgecolor="none")
    if show_messages and trace._msg_match is None:
        trace._ensure_messages()
    if show_messages and trace._msg_match is not None:
        mm = trace._msg_match
        name_cat = ev.cat(NAME)
        sends = np.nonzero(name_cat.mask_eq(MPI_SEND) & (mm >= 0))[0]
        for srow in sends[:2000]:
            rrow = mm[srow]
            if ts[srow] > x_end or ts[rrow] < x_start:
                continue
            ax.annotate("", xy=(ts[rrow], procs[rrow]), xytext=(ts[srow], procs[srow]),
                        arrowprops=dict(arrowstyle="->", color="black", lw=0.6, alpha=0.6))
    if show_critical_path:
        paths = trace.critical_path_analysis()
        if paths and len(paths[0]):
            p = paths[0]
            ax.plot(np.asarray(p[TS], np.float64), np.asarray(p[PROC], np.float64),
                    "r-o", lw=1.6, ms=3, label="critical path")
            ax.legend(loc="upper right")
    handles = [plt.Rectangle((0, 0), 1, 1, color=_color(i)) for i in
               range(min(max_functions, len(rank)))]
    labels = [str(cats[rank[i]]) for i in range(min(max_functions, len(rank)))]
    if handles:
        ax.legend(handles, labels, loc="center left", bbox_to_anchor=(1.0, 0.5),
                  fontsize=7)
    ax.set_xlim(x_start, x_end)
    ax.set_xlabel("time (ns)")
    ax.set_ylabel("process")
    ax.set_yticks(range(trace.num_processes))
    ax.invert_yaxis()
    if save:
        ax.figure.savefig(save, bbox_inches="tight", dpi=110)
        plt.close(ax.figure)
    return ax


def plot_time_profile(trace, num_bins: int = 32, ax=None, save: Optional[str] = None):
    plt = _pyplot()
    prof = trace.time_profile(num_bins=num_bins)
    cols = [c for c in prof.columns if c not in ("bin_start", "bin_end")]
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 4))
    x = np.asarray(prof["bin_start"], np.float64)
    width = np.asarray(prof["bin_end"], np.float64) - x
    bottom = np.zeros(len(x))
    for i, c in enumerate(cols[:19]):
        v = np.asarray(prof[c], np.float64)
        ax.bar(x, v, width=width, bottom=bottom, align="edge", label=c,
               color=_color(i), edgecolor="none")
        bottom += v
    ax.set_xlabel("time (ns)")
    ax.set_ylabel("total time per bin")
    ax.legend(fontsize=7, loc="center left", bbox_to_anchor=(1.0, 0.5))
    if save:
        ax.figure.savefig(save, bbox_inches="tight", dpi=110)
        plt.close(ax.figure)
    return ax


def plot_comm_matrix(trace, output: str = "size", log_scale: bool = False,
                     ax=None, save: Optional[str] = None):
    plt = _pyplot()
    mat = trace.comm_matrix(output=output)
    if ax is None:
        _, ax = plt.subplots(figsize=(5.5, 5))
    from matplotlib.colors import LogNorm
    norm = LogNorm(vmin=max(mat[mat > 0].min(), 1e-9), vmax=mat.max()) \
        if log_scale and (mat > 0).any() else None
    im = ax.imshow(mat, cmap="viridis", norm=norm)
    ax.figure.colorbar(im, ax=ax, label=f"{output} sent")
    ax.set_xlabel("receiver")
    ax.set_ylabel("sender")
    if save:
        ax.figure.savefig(save, bbox_inches="tight", dpi=110)
        plt.close(ax.figure)
    return ax


def plot_comm_by_process(trace, output: str = "size", ax=None,
                         save: Optional[str] = None):
    plt = _pyplot()
    t = trace.comm_by_process(output=output)
    if ax is None:
        _, ax = plt.subplots(figsize=(9, 3.5))
    procs = np.asarray(t[PROC], np.int64)
    ax.bar(procs - 0.2, np.asarray(t["sent"]), width=0.4, label="sent")
    ax.bar(procs + 0.2, np.asarray(t["received"]), width=0.4, label="received")
    ax.set_xlabel("process")
    ax.set_ylabel(output)
    ax.legend()
    if save:
        ax.figure.savefig(save, bbox_inches="tight", dpi=110)
        plt.close(ax.figure)
    return ax


def plot_message_histogram(trace, bins: int = 10, ax=None, save: Optional[str] = None):
    plt = _pyplot()
    counts, edges = trace.message_histogram(bins=bins)
    if ax is None:
        _, ax = plt.subplots(figsize=(7, 3.5))
    ax.bar(edges[:-1], counts, width=np.diff(edges), align="edge", edgecolor="white")
    ax.set_xlabel("message size (bytes)")
    ax.set_ylabel("count")
    if save:
        ax.figure.savefig(save, bbox_inches="tight", dpi=110)
        plt.close(ax.figure)
    return ax


def plot_multirun(table: EventFrame, label_column: str = "Run", ax=None,
                  save: Optional[str] = None):
    """Stacked bars across runs (paper Figs. 12-13)."""
    plt = _pyplot()
    cols = [c for c in table.columns if c != label_column]
    labels = [str(x) for x in table[label_column]]
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))
    x = np.arange(len(labels))
    bottom = np.zeros(len(labels))
    for i, c in enumerate(cols[:19]):
        v = np.asarray(table[c], np.float64)
        ax.bar(x, v, bottom=bottom, label=c, color=_color(i))
        bottom += v
    ax.set_xticks(x, labels, rotation=20, ha="right", fontsize=8)
    ax.legend(fontsize=7, loc="center left", bbox_to_anchor=(1.0, 0.5))
    if save:
        ax.figure.savefig(save, bbox_inches="tight", dpi=110)
        plt.close(ax.figure)
    return ax
