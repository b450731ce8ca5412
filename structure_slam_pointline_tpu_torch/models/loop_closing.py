"""The vocabulary and keyframe BoW index of the loop closer.

Counterpart of the index half of structure_slam_pointline_tpu/models/
loop_closing.py: `LoopCloser.__init__`'s vocabulary fields (:192-209),
`_gather_descs` (:211), `ensure_vocabulary` (:216) and `_index_keyframe`
(:259, here `_index_keyframes`, any number of keyframes per launch).
Relocalization shares this index with loop closing, as in the
reference. The vocabulary is trained lazily, on the host, from every
keyframe's descriptors the first time a lost frame needs it; keyframes
are then indexed through kernel 13 (ops/bow.transform), all of them in
one batched launch.

Still to be ported with loop closing (ROADMAP.md queue 1 item 15):
`maybe_retrain` and `add_keyframe` (only `_run_loop_closing` calls them),
`detect`, `verify`, `correct`, `remap_keyframes`, the jitted helpers
at :55, :89, :104, :125 and :140 of the reference module, and the
retraining bookkeeping (`_descs_at_train`, `_descs_seen`) that only
`maybe_retrain` reads.

As in the reference, nothing indexes a keyframe inserted after the
vocabulary was trained until it becomes a relocalization candidate
(`add_keyframe` runs only with loop closing on), so its BoW row stays
zero and scores 0.5 against any query; and `SLAMSystem.reset()` keeps
the loop closer with its vocabulary and index (ROADMAP.md queue 3).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from structure_slam_pointline_tpu_torch.config import SLAMConfig
from structure_slam_pointline_tpu_torch.ops import bow
from structure_slam_pointline_tpu_torch.world.map_store import MapState


class LoopCloser:
    """The vocabulary and the keyframe BoW index over the device-resident
    map (the detector / corrector half is still to be ported)."""

    def __init__(self, cfg: SLAMConfig):
        self.cfg = cfg
        self.voc: Optional[bow.Vocabulary] = None
        self.kf_bows: Optional[torch.Tensor] = None  # [K, W] float32, map's device
        self.kf_words: dict = {}                     # k -> [F] int32 numpy

    def _gather_descs(self, state: MapState, n_kf: int) -> np.ndarray:
        valid = state.kf_kp_valid[:n_kf].cpu().numpy()
        desc = state.kf_desc[:n_kf].cpu().numpy().view(np.uint32)
        return desc[valid]

    def ensure_vocabulary(self, state: MapState, n_kf: int) -> bool:
        if self.voc is not None:
            return True
        if n_kf < 2:
            return False
        descs = self._gather_descs(state, n_kf)
        if len(descs) < 500:
            return False
        self.voc = bow.train_vocabulary(descs, self.cfg.bow.branching, self.cfg.bow.depth,
                                        seed=self.cfg.seed)
        K = state.kf_valid.shape[0]
        self.kf_bows = torch.zeros((K, self.voc.n_words), dtype=torch.float32,
                                   device=state.kf_valid.device)
        self._index_keyframes(state, range(n_kf))
        return True

    def _index_keyframes(self, state: MapState, ks) -> None:
        """Words and BoW rows of keyframes `ks`, one kernel-13 launch."""
        ks = list(ks)
        if not ks:
            return
        ids = torch.as_tensor(ks, dtype=torch.long, device=state.kf_valid.device)
        words, vecs = bow.transform(self.voc, state.kf_desc[ids], state.kf_kp_valid[ids])
        self.kf_bows[ids] = vecs
        words = words.cpu().numpy()
        for i, k in enumerate(ks):
            self.kf_words[k] = words[i]


__all__ = ["LoopCloser"]
