"""Offline visualisation: trajectory, graph and map rendering to PNG.

The port's copy of `gorio_tpu/utils/viz.py`, the counterpart of the
reference's rviz surfaces (`radar_graph_slam_nodelet.cpp:885-1121`: the
MarkerArray of nodes, edges and loops, and the map cloud topic): it renders
`RadarGraphSLAM.export_markers` JSON, TUM trajectories and a `slam --map`
npz headlessly with matplotlib, which is imported inside `render_run` only.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def render_run(
    out_png: str,
    markers_json: str | None = None,
    trajectory_tum: str | None = None,
    groundtruth_tum: str | None = None,
    map_npz: str | None = None,
    title: str | None = None,
    max_map_points: int = 200_000,
) -> str:
    """Render any combination of graph markers, trajectories, and map cloud
    into a top-down PNG. Returns the output path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 10))

    if map_npz:
        m = np.load(map_npz)
        xyz = m["xyz"]
        if len(xyz) > max_map_points:
            sel = np.random.default_rng(0).choice(len(xyz), max_map_points, replace=False)
            xyz = xyz[sel]
        ax.scatter(
            xyz[:, 0], xyz[:, 1], s=0.3, c=xyz[:, 2], cmap="viridis",
            alpha=0.5, linewidths=0, label=f"map ({len(xyz)} pts)",
        )

    if groundtruth_tum:
        from ..io.tum import load_tum

        _, gp = load_tum(groundtruth_tum)
        ax.plot(gp[:, 0, 3], gp[:, 1, 3], "k--", lw=1.2, label="ground truth")

    if trajectory_tum:
        from ..io.tum import load_tum

        _, ep = load_tum(trajectory_tum)
        ax.plot(ep[:, 0, 3], ep[:, 1, 3], "-", color="tab:blue", lw=1.5,
                label="estimate")

    if markers_json:
        data = json.loads(Path(markers_json).read_text())
        pos = {n["id"]: n["position"] for n in data.get("nodes", [])}
        if pos:
            P = np.asarray([pos[k] for k in sorted(pos)])
            ax.plot(P[:, 0], P[:, 1], ".", color="tab:orange", ms=2,
                    label=f"keyframes ({len(P)})")
        for l in data.get("loops", []):
            a, b = pos.get(l["from"]), pos.get(l["to"])
            if a is not None and b is not None:
                ax.plot([a[0], b[0]], [a[1], b[1]], "-", color="tab:red",
                        lw=1.0, alpha=0.8)
        if data.get("loops"):
            ax.plot([], [], "-", color="tab:red", label=f"loops ({len(data['loops'])})")

    ax.set_aspect("equal")
    ax.grid(alpha=0.3)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(loc="best", fontsize=9)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_png, dpi=130)
    plt.close(fig)
    return out_png
