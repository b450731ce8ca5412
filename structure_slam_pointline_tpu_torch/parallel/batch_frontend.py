"""Data-parallel feature extraction over a mesh of frame shards.

Counterpart of structure_slam_pointline_tpu/parallel/batch_frontend.py,
which vmaps the single-frame extraction over a batch of frames sharded
over devices. Here each shard of a `frame_mesh` (parallel/mesh.py) takes
a contiguous block of the frames and runs, on its own CUDA stream:

- `extract.extract_orb` of the whole block: one launch each of kernel 25
  (the pyramid and blur), kernel 1 (FAST + NMS), kernel 11 (the
  selection) and kernel 2 (ORB), every level of all the block's frames in
  each: the batch entries, the counterpart of the vmap;
- with lines, LSD and LBD frame by frame, as the reference's `one(img)`
  runs them: `lsd.detect_lines` (one octave: kernels 5, 11, 6 and 26) and
  `lbd.describe_lines` (kernel 7).

Every frame's keypoints, descriptors, lines and LBD words equal the
single-frame frontend's. No collective is needed: the frames are
independent.
"""

from __future__ import annotations

import numpy as np
import torch

from structure_slam_pointline_tpu_torch.config import FrontendConfig
from structure_slam_pointline_tpu_torch.ops import extract, lbd, lsd
from structure_slam_pointline_tpu_torch.parallel.mesh import Mesh

FRAME_AXIS = "frame"


def frame_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A mesh of `n_devices` frame shards (default one) on this process's
    device (the card unless the caller asks for the CPU)."""
    return Mesh(n_devices or 1, device, FRAME_AXIS)


def _stack(parts: list):
    """Per-frame named tuples -> one named tuple of [B, ...] fields."""
    return type(parts[0])(*[torch.cat([getattr(p, f) for p in parts])
                            for f in parts[0]._fields])


def make_batch_extractor(mesh: Mesh, cfg: FrontendConfig, with_lines: bool = True):
    """Returns fn(imgs [B, H, W], B divisible by the mesh size) -> batched
    Keypoints (leading axis B), or with lines the tuple (Keypoints, Lines,
    LBD words [B, L, 8])."""
    if mesh.world != 1:
        raise ValueError("make_batch_extractor: a frame mesh is one process's shards")

    def block(imgs: torch.Tensor):
        kp = extract.extract_orb(imgs, cfg)
        if not with_lines:
            return (kp,)
        lns, words = [], []
        for img in imgs:
            ln = lsd.detect_lines(img, cfg)
            w, _ = lbd.describe_lines(img, ln.endpoints.contiguous(), ln.valid)
            lns.append(type(ln)(*[t[None] for t in ln]))
            words.append(w[None])
        return kp, _stack(lns), torch.cat(words)

    def run(imgs):
        imgs = torch.as_tensor(np.asarray(imgs, np.float32) if not isinstance(
            imgs, torch.Tensor) else imgs, dtype=torch.float32, device=mesh.device)
        if imgs.dim() != 3 or imgs.shape[0] % mesh.size:
            raise ValueError(f"make_batch_extractor: {tuple(imgs.shape)} frames do not "
                             f"divide into {mesh.size} shards")
        per = imgs.shape[0] // mesh.size
        main = torch.cuda.current_stream(mesh.device) if mesh.device.type == "cuda" else None
        outs = []
        for s, stream in enumerate(mesh.streams):
            chunk = imgs[s * per:(s + 1) * per]
            if stream is None:
                outs.append(block(chunk))
                continue
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                outs.append(block(chunk))
        for stream in mesh.streams:
            if stream is not None:
                main.wait_stream(stream)
        res = [_stack([o[i] for o in outs]) if i < 2 else torch.cat([o[i] for o in outs])
               for i in range(len(outs[0]))]
        return res[0] if not with_lines else tuple(res)

    return run


__all__ = ["FRAME_AXIS", "frame_mesh", "make_batch_extractor"]
