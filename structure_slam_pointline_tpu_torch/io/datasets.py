"""Dataset manifests, image loading and TUM trajectory files.

Counterpart of structure_slam_pointline_tpu/io/datasets.py (host numpy and
PIL, no torch): TUM `rgb.txt` and ICL-NUIM `mono-normal.txt` manifests,
grayscale decoding, and the TUM trajectory writer and reader used for
evaluation (`t tx ty tz qx qy qz qw` of camera-to-world).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Sequence:
    timestamps: np.ndarray          # [N] float64 seconds
    image_paths: List[str]
    aux_paths: Optional[List[str]] = None  # e.g. normal maps in ICL manifests

    def __len__(self):
        return len(self.image_paths)


def _manifest_rows(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line.split()


def load_tum_rgb_manifest(seq_dir: str, manifest: str = "rgb.txt") -> Sequence:
    """TUM format: lines `timestamp rgb/xxx.png` (# comments skipped)."""
    rows = list(_manifest_rows(os.path.join(seq_dir, manifest)))
    return Sequence(np.asarray([float(r[0]) for r in rows]),
                    [os.path.join(seq_dir, r[1]) for r in rows])


def load_icl_manifest(path: str, base_dir: str | None = None) -> Sequence:
    """ICL mono-normal manifests: `timestamp rgb/N.png Normal/N.png`."""
    base = base_dir or os.path.dirname(path)
    rows = list(_manifest_rows(path))
    aux = [os.path.join(base, r[2]) for r in rows if len(r) > 2]
    return Sequence(np.asarray([float(r[0]) for r in rows]),
                    [os.path.join(base, r[1]) for r in rows], aux or None)


def load_image_grayscale(path: str) -> np.ndarray:
    """PNG / JPG -> float32 [H, W] grayscale in [0, 255] (PIL's "L")."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), np.float32)


def write_trajectory_tum(path: str, timestamps, poses_T_cw) -> None:
    """One TUM row of T_wc per pose, as SLAMSystem.save_trajectory_tum."""
    from structure_slam_pointline_tpu_torch.models.system import _tum_row

    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses_T_cw):
            f.write(_tum_row(ts, T))


def read_trajectory_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (timestamps [N], T_wc [N, 4, 4])."""
    ts, Ts = [], []
    for row in _manifest_rows(path):
        v = [float(x) for x in row]
        T = np.eye(4)
        T[:3, :3] = _quat_to_rot(*v[4:8])
        T[:3, 3] = v[1:4]
        ts.append(v[0])
        Ts.append(T)
    return np.asarray(ts), np.asarray(Ts)


def _quat_to_rot(x, y, z, w) -> np.ndarray:
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


__all__ = ["Sequence", "load_tum_rgb_manifest", "load_icl_manifest", "load_image_grayscale",
           "write_trajectory_tum", "read_trajectory_tum"]
