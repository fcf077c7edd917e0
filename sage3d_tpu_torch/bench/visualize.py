"""Trajectory visualization: agent path + GT path over the 2D semantic map.

Re-implementation of the reference visualizer (run_benchmark.py:781-994 +
reverse_position_mapping :742-778): world-frame trajectories mapped back into
the map frame, drawn over obstacle masks with start/goal markers and the
episode's metric summary in the title.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.transforms import world_to_map_xy


def _bounds_from_map(map_data: List[Dict]):
    xs, ys = [], []
    for inst in map_data:
        for y, x in inst.get("mask_coords_m", []):
            ys.append(float(y))
            xs.append(float(x))
    if not xs:
        return None
    return min(xs), max(xs), min(ys), max(ys)


def visualize_trajectory(
    trajectory_world: Sequence[Sequence[float]],
    map_data: List[Dict],
    out_path,
    gt_locations: Optional[Sequence[Sequence[float]]] = None,
    goal_world: Optional[Sequence[float]] = None,
    title: str = "",
    measurements: Optional[Dict[str, float]] = None,
) -> Optional[Path]:
    """Render the episode trajectory PNG. Returns the written path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    bounds = _bounds_from_map(map_data)
    if bounds is None:
        return None

    def to_map(points):
        pts = np.asarray([[p[0], p[1]] for p in points], float)
        mx, my = world_to_map_xy(pts[:, 0], pts[:, 1], bounds)
        return np.stack([mx, my], axis=1)

    fig, ax = plt.subplots(figsize=(10, 10))

    # obstacle scatter background
    for inst in map_data:
        cat = str(inst.get("category_label", "")).lower()
        coords = np.asarray(inst.get("mask_coords_m", []), float)
        if coords.size == 0:
            continue
        if cat == "wall":
            ax.scatter(coords[:, 1], coords[:, 0], s=1, c="#9edae5", marker="s")
        elif cat == "unable area":
            ax.scatter(coords[:, 1], coords[:, 0], s=1, c="#ff8080", marker="s")

    # object bboxes
    for inst in map_data:
        bbox = inst.get("bbox_m")
        cat = str(inst.get("category_label", "")).lower()
        if bbox and len(bbox) == 4 and cat not in ("wall", "unable area"):
            x0, y0, x1, y1 = [float(v) for v in bbox]
            ax.add_patch(plt.Rectangle((x0, y0), x1 - x0, y1 - y0,
                                       fill=False, edgecolor="gray",
                                       linewidth=0.5))

    if gt_locations is not None and len(gt_locations) > 1:
        gt = to_map(gt_locations)
        ax.plot(gt[:, 0], gt[:, 1], "g--", linewidth=1.5, label="GT path")

    if len(trajectory_world) > 1:
        tr = to_map(trajectory_world)
        ax.plot(tr[:, 0], tr[:, 1], "b-", linewidth=2, label="agent")
        ax.plot(tr[0, 0], tr[0, 1], "go", markersize=10, label="start")
        ax.plot(tr[-1, 0], tr[-1, 1], "bs", markersize=8, label="end")

    if goal_world is not None:
        g = to_map([goal_world])[0]
        ax.plot(g[0], g[1], "r*", markersize=16, label="goal")

    if measurements:
        parts = [f"SR={measurements.get('success', 0):.0f}",
                 f"SPL={measurements.get('spl', 0):.2f}",
                 f"NE={measurements.get('navigation_error', 0):.2f}m",
                 f"CR={measurements.get('collision_count', 0):.0f}"]
        title = (title + "  " if title else "") + " ".join(parts)
    ax.set_title(title)
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
