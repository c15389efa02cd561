"""Cohort-level reports: CSV statistics tables and distortion charts.

Replaces the reference's get_group_stats*.py (CSV of CC/DICE/distortion per
group) and plot_distortions*.py (charts; matplotlib here instead of plotly).
"""
from __future__ import annotations

import csv
from typing import Dict, Sequence

import numpy as np

STAT_COLUMNS = ["cc", "dice", "areal_mean", "areal_max", "areal_95",
                "areal_98", "shape_mean", "shape_max"]


def group_stats_csv(stats_by_group: Dict[str, dict], path: str) -> None:
    """One row per group (get_group_stats.py:36-80 output contract)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["group"] + STAT_COLUMNS)
        for gid, st in stats_by_group.items():
            w.writerow([gid] + [st.get(c, "") for c in STAT_COLUMNS])


def read_group_stats_csv(path: str) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    with open(path) as f:
        r = csv.DictReader(f)
        for row in r:
            gid = row.pop("group")
            out[gid] = {k: float(v) for k, v in row.items() if v != ""}
    return out


def plot_distortions(per_subject_distortions: Dict[str, Sequence[np.ndarray]],
                     path: str, kind: str = "areal") -> None:
    """Violin plot of per-subject |log2| distortion distributions per group
    (plot_distortions.py equivalent)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups = list(per_subject_distortions)
    data = [np.abs(np.concatenate([np.ravel(d) for d in per_subject_distortions[g]]))
            for g in groups]
    fig, ax = plt.subplots(figsize=(max(4, 1.2 * len(groups)), 4))
    ax.violinplot(data, showmedians=True)
    ax.set_xticks(range(1, len(groups) + 1))
    ax.set_xticklabels(groups)
    ax.set_ylabel(f"|log2 {kind} distortion|")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
