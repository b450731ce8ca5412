"""Headless map / trajectory / frame drawings (matplotlib, Agg).

Counterpart of structure_slam_pointline_tpu/viz/viewer.py: the map's
points, line segments and keyframe centres seen from above (x-z), and a
frame with its keypoints and segments, written to image files. The map is
read through one device -> host copy of the fields drawn.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from structure_slam_pointline_tpu_torch.world.map_store import MapState


def _require_agg():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_map(state: MapState, n_kf: int, path: str,
             trajectory: Optional[np.ndarray] = None,
             gt_trajectory: Optional[np.ndarray] = None) -> None:
    """Top-down (x-z) view: points, line segments, keyframe centres with
    their viewing direction, and optionally the trajectory and ground
    truth ([N, 4, 4] T_wc)."""
    plt = _require_agg()
    host = {f: getattr(state, f).cpu().numpy()
            for f in ("mp_xyz", "mp_valid", "ml_endpoints", "ml_valid", "kf_T_cw", "kf_valid")}
    fig, ax = plt.subplots(figsize=(9, 9))
    mp = host["mp_xyz"][host["mp_valid"]]
    if len(mp):
        ax.scatter(mp[:, 0], mp[:, 2], s=1.5, c="#333333", alpha=0.5, label="map points")
    for seg in host["ml_endpoints"][host["ml_valid"]]:
        ax.plot([seg[0], seg[3]], [seg[2], seg[5]], c="#cc3333", lw=1.2)
    T, valid = host["kf_T_cw"], host["kf_valid"]
    for k in range(min(n_kf, len(T))):
        if not valid[k]:
            continue
        T_wc = np.linalg.inv(T[k])
        c = T_wc[:3, 3]
        z = T_wc[:3, 2] * 0.15
        ax.plot([c[0], c[0] + z[0]], [c[2], c[2] + z[2]], c="#2266cc", lw=1.0)
        ax.scatter([c[0]], [c[2]], s=8, c="#2266cc")
    if trajectory is not None:
        ax.plot(trajectory[:, 0, 3], trajectory[:, 2, 3], c="#22aa55", lw=1.0, label="trajectory")
    if gt_trajectory is not None:
        ax.plot(gt_trajectory[:, 0, 3], gt_trajectory[:, 2, 3], c="#999999", lw=1.0,
                ls="--", label="ground truth")
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def draw_frame(img: np.ndarray, path: str,
               kp_xy: Optional[np.ndarray] = None, kp_matched: Optional[np.ndarray] = None,
               line_ep: Optional[np.ndarray] = None, line_valid: Optional[np.ndarray] = None,
               text: str = "") -> None:
    """A frame with its keypoints (green: matched) and line segments."""
    plt = _require_agg()
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    if kp_xy is not None:
        m = kp_matched if kp_matched is not None else np.zeros(len(kp_xy), bool)
        ax.scatter(kp_xy[~m, 0], kp_xy[~m, 1], s=4, c="#4488ff", alpha=0.6)
        ax.scatter(kp_xy[m, 0], kp_xy[m, 1], s=6, c="#33cc33")
    if line_ep is not None:
        lv = line_valid if line_valid is not None else np.ones(len(line_ep), bool)
        for seg in line_ep[lv]:
            ax.plot([seg[0], seg[2]], [seg[1], seg[3]], c="#ff4444", lw=1.2)
    if text:
        ax.set_title(text, fontsize=9)
    ax.set_xticks([])
    ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


__all__ = ["draw_map", "draw_frame"]
