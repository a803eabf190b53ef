"""Visualization: track canvas + trajectory viewer + graph dumps (port of
``xivo_tpu/viz.py``).

Host-side matplotlib replacements for the reference's Pangolin viewer
(src/viewer.{h,cpp}), Canvas overlay (src/visualize.{h,cpp}) and the
Graphviz dumper (src/graphwriter.{h,cpp}). Out of the perf path by
design (SURVEY §2.5). They read the port's ``Estimator``, whose state
carries a batch axis of 1; matplotlib is imported only when a figure is
drawn.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .api.estimator import _np as _leaf
from .filter.state import (FS_GAUGE, FS_INITIALIZING, FS_INSTATE, FS_READY,
                           TS_TRACKED)

_STATUS_COLORS = {
    FS_INITIALIZING: "tab:orange",
    FS_READY: "tab:blue",
    FS_INSTATE: "tab:green",
    FS_GAUGE: "tab:red",
}


def plot_tracks(est, save_path: Optional[str] = None):
    """Feature canvas color-coded by status (Canvas::Draw parity)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fr = est.state.features
    fid = _leaf(fr.fid)
    xp = _leaf(fr.xp)
    status = _leaf(fr.status)
    track = _leaf(fr.track)

    rows, cols = int(est.cfg.cam_params[0]), int(est.cfg.cam_params[1])
    fig, ax = plt.subplots(figsize=(8, 6))
    for st, color in _STATUS_COLORS.items():
        sel = (fid >= 0) & (status == st) & (track == TS_TRACKED)
        ax.scatter(xp[sel, 0], xp[sel, 1], s=12, c=color,
                   label=f"status={st} (n={int(sel.sum())})")
    ax.set_xlim(0, cols)
    ax.set_ylim(rows, 0)
    ax.legend(loc="upper right", fontsize=7)
    Rsb, Tsb = est.gsb()
    ax.set_title(f"T=[{Tsb[0]:.2f} {Tsb[1]:.2f} {Tsb[2]:.2f}] "
                 f"instf={est.num_instate_features()} "
                 f"instg={est.num_instate_groups()}")
    if save_path:
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
        return save_path
    return fig


def plot_trajectory(ts, Tsb, gt_Tsb=None, save_path: Optional[str] = None):
    """3-panel trajectory plot (viewer replacement)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    Tsb = np.asarray(Tsb)
    fig, axes = plt.subplots(3, 1, figsize=(9, 7), sharex=True)
    for i, name in enumerate("xyz"):
        axes[i].plot(ts, Tsb[:, i], label="estimate")
        if gt_Tsb is not None:
            axes[i].plot(ts, np.asarray(gt_Tsb)[:, i], "--", label="gt")
        axes[i].set_ylabel(name + " [m]")
    axes[0].legend()
    axes[-1].set_xlabel("t [s]")
    if save_path:
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
        return save_path
    return fig


def write_graphviz(est, path: str):
    """Visibility-graph .dot dump (GraphWriter parity,
    src/graphwriter.h:17-34)."""
    fr = est.state.features
    gr = est.state.groups
    fid = _leaf(fr.fid)
    gid = _leaf(gr.gid)
    adj = _leaf(fr.adj)
    ref = _leaf(fr.ref)
    sind = _leaf(gr.sind)
    lines = ["graph vio {"]
    for g in np.nonzero(gid >= 0)[0]:
        shape = "doublecircle" if int(sind[g]) >= 0 else "circle"
        lines.append(f'  g{gid[g]} [shape={shape}];')
    for f in np.nonzero(fid >= 0)[0]:
        lines.append(f'  f{fid[f]} [shape=point];')
        for g in np.nonzero(adj[f])[0]:
            style = "bold" if ref[f] == g else "dotted"
            lines.append(f'  f{fid[f]} -- g{gid[g]} [style={style}];')
    lines.append("}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
