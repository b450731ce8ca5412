"""Loop closing: BoW detection, Sim(3) verification, essential-graph
correction and the loop fuse.

Counterpart of structure_slam_pointline_tpu/models/loop_closing.py (the
reference's LoopClosing thread; off by default, `enable_loop_closing`).
The host keeps the reference's control flow, its numpy draws and its
edge lists; the device work runs through the kernels:

- the vocabulary (host numpy training) and the keyframe BoW index,
  kernel 13 (ops/bow.transform, any number of keyframes per launch);
  relocalization shares this index, as in the reference;
- `detect`: the covisibility matrix (kernel 24, world/map_store.py) and
  the L1 scores of keyframe k against every row, kernel 14
  (ops/bow.query_database, nothing masked); the masks, the 0.75 x best
  cut and the consistency groups on a host copy;
- `verify`: BoW-gated matching, kernel 3; Sim(3) RANSAC, kernel 16
  (optim/sim3_solver.py) on sample sets drawn from `rng` in the
  reference's order; the Sim(3) widening and the loop-pool acceptance,
  kernel 22 (`sim3_widen_match`, `pool_match`); the inlier-gated
  refinement, kernel 17 (optim/pose_graph.py); the group's covisibility
  rows, kernel 24;
- `correct`: the essential graph built on the host in the reference's
  edge order, optimized by kernel 18; landmarks and line endpoints
  corrected through their reference keyframes on the device; the loop
  fuse with its eight projection matches in ONE kernel-22 launch
  ([8, 4096, F], none of the inputs changes between the reference's
  eight sequential matches), the merges then walked in the reference's
  order by kernel 23 (`loop_merge`, `fuse_finish`).

Each kernel wrapper takes its `_plain` version on CPU tensors: the
reference's formulation in torch (window masks, kernel 3, host loops).

`remap_keyframes` follows a pool compaction and waits for it
(ROADMAP.md queue 1 item 16). As in the reference, nothing indexes a
keyframe inserted after the vocabulary was trained until loop closing
(`add_keyframe`) or relocalization needs it, and `SLAMSystem.reset()`
keeps the loop closer (ROADMAP.md queue 3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from structure_slam_pointline_tpu_torch.config import SLAMConfig
from structure_slam_pointline_tpu_torch.ops import bow, matching
from structure_slam_pointline_tpu_torch.optim import pose_graph, sim3_solver
from structure_slam_pointline_tpu_torch.utils import camera as cam_utils
from structure_slam_pointline_tpu_torch.utils import lie
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics
from structure_slam_pointline_tpu_torch.utils.indexing import nonzero_fixed, set_drop
from structure_slam_pointline_tpu_torch.world import map_store
from structure_slam_pointline_tpu_torch.world.map_store import MapState


@dataclasses.dataclass
class LoopCandidate:
    kf_id: int
    score: float


LOOP_POOL = 4096   # loop-side landmark pool capacity (candidate + neighbours)
FUSE_KFS = 8       # current-side keyframes receiving the loop fuse


def _cam_points(state: MapState, k: int) -> torch.Tensor:
    """[F, 3] the landmarks bound to keyframe k's features, in its camera
    frame (unbound features read landmark 0; callers mask them)."""
    P = state.mp_valid.shape[0]
    T = state.kf_T_cw[k]
    X = state.mp_xyz[torch.clamp(state.kf_kp_mp[k], 0, P - 1).long()]
    return X @ T[:3, :3].T + T[:3, 3]


def _sim3_widen_matches_plain(state: MapState, k: int, cand: int, S12: torch.Tensor,
                              intr: Intrinsics, max_dist: int) -> matching.MatchResult:
    """SearchBySim3: mutual Sim(3)-projection windowed descriptor match
    between the two keyframes' landmark-bound features; a pair is a
    candidate only when both projections land within 7.5 px. Rows =
    features of k, idx into cand's features."""
    has_k = state.kf_kp_mp[k] >= 0
    has_c = state.kf_kp_mp[cand] >= 0
    X1 = _cam_points(state, k)
    X2 = _cam_points(state, cand)
    S21 = lie.sim3_inverse(S12)
    X2_in1 = X2 @ S12[:3, :3].T + S12[:3, 3]
    X1_in2 = X1 @ S21[:3, :3].T + S21[:3, 3]
    uv2_in1, z21 = cam_utils.project(intr, X2_in1)
    uv1_in2, z12 = cam_utils.project(intr, X1_in2)
    w1 = matching.window_mask(uv2_in1, has_c & (z21 > 0.1), state.kf_xy[k], has_k, 7.5)
    w2 = matching.window_mask(uv1_in2, has_k & (z12 > 0.1), state.kf_xy[cand], has_c, 7.5)
    return matching.masked_match(state.kf_desc[k], state.kf_desc[cand], w1.T & w2,
                                 max_dist=max_dist)


def _sim3_widen_matches(state: MapState, k: int, cand: int, S12: torch.Tensor,
                        intr: Intrinsics, max_dist: int) -> matching.MatchResult:
    """SearchBySim3 ([F] idx / dist / valid). CPU tensors -> plain version;
    CUDA tensors -> kernel 22's mutual-window entry (or raise), which
    writes none of the three [F, F] masks. S21 comes from the plain
    version's own lie.sim3_inverse."""
    if state.kf_kp_mp.device.type == "cpu":
        return _sim3_widen_matches_plain(state, k, cand, S12, intr, max_dist)
    F = state.kf_kp_mp.shape[1]
    m = matching.fused_match(
        "sim3_widen_match", 1, F, F, dict(
            table=state.kf_kp_mp, xyz=state.mp_xyz, kf_T=state.kf_T_cw, S12=S12,
            S21=lie.sim3_inverse(S12), kf_xy=state.kf_xy, kf_desc=state.kf_desc),
        intr, P=state.mp_valid.shape[0], max_dist=int(max_dist), k=int(k),
        cand=int(cand), radius=7.5)
    return matching.MatchResult(idx=m.idx[0], dist=m.dist[0], valid=m.valid[0])


def _loop_pool(state: MapState, nb_ids: torch.Tensor) -> torch.Tensor:
    """[LOOP_POOL] int32 ids of the live landmarks observed by the group
    nb_ids ([W] keyframe ids, -1 padded), -1 padded."""
    K = state.kf_valid.shape[0]
    P = state.mp_valid.shape[0]
    rows = torch.clamp(nb_ids, 0, K - 1).long()
    pool = torch.where((nb_ids >= 0)[:, None], state.kf_kp_mp[rows], -1)
    mask = torch.zeros(P + 1, dtype=torch.bool, device=pool.device)
    mask[torch.where(pool >= 0, pool, P).reshape(-1).long()] = True
    return nonzero_fixed(mask[:P] & state.mp_valid, LOOP_POOL).to(torch.int32)


def _project_pool_matches_plain(state: MapState, kf_id, M_cw: torch.Tensor,
                                pool_ids: torch.Tensor, intr: Intrinsics, radius: float,
                                max_dist: int):
    """Project the loop pool through M_cw (world -> corrected camera of
    kf_id, may carry scale) and window-match the pool's descriptors
    against that keyframe's features. kf_id an int and M_cw [4, 4], or
    kf_id [B] and M_cw [B, 4, 4] for B keyframes in one kernel-3 launch.
    Returns the MatchResult, rows = pool (the reference also returns the
    visible mask, which no caller reads)."""
    P = state.mp_valid.shape[0]
    safe = torch.clamp(pool_ids, 0, P - 1).long()
    ok = pool_ids >= 0
    X = state.mp_xyz[safe]
    p = X @ M_cw[..., :3, :3].transpose(-1, -2) + M_cw[..., None, :3, 3]
    uv, z = cam_utils.project(intr, p)
    vis = ok & (z > 0.1)
    allow = matching.window_mask(uv, vis, state.kf_xy[kf_id], state.kf_kp_valid[kf_id], radius)
    return matching.masked_match(state.mp_desc[safe], state.kf_desc[kf_id], allow,
                                 max_dist=max_dist)


def _project_pool_matches(state: MapState, kf_id, M_cw: torch.Tensor, pool_ids: torch.Tensor,
                          intr: Intrinsics, radius: float, max_dist: int):
    """The loop pool's projection match (MatchResult, rows = pool; [B, n]
    for kf_id [B]). CPU tensors -> plain version; CUDA tensors ->
    kernel 22's pool entry (or raise), no [B, n, F] mask written."""
    if state.kf_kp_mp.device.type == "cpu":
        return _project_pool_matches_plain(state, kf_id, M_cw, pool_ids, intr, radius,
                                           max_dist)
    batched = M_cw.dim() == 3
    dev = state.kf_kp_mp.device
    kf = torch.as_tensor(kf_id, device=dev).reshape(-1).to(torch.int32)
    Mb = M_cw.reshape(-1, 4, 4)
    F = state.kf_kp_mp.shape[1]
    m = matching.fused_match(
        "pool_match", Mb.shape[0], pool_ids.shape[0], F, dict(
            b_ids=kf, M_cw=Mb, pool_ids=pool_ids.to(torch.int32), xyz=state.mp_xyz,
            desc=state.mp_desc, kf_xy=state.kf_xy, kf_valid=state.kf_kp_valid,
            kf_desc=state.kf_desc),
        intr, P=state.mp_valid.shape[0], max_dist=int(max_dist), radius=float(radius))
    return m if batched else matching.MatchResult(*(t[0] for t in m[:3]))


def loop_merge_plain(table: torch.Tensor, valid: torch.Tensor, rows: torch.Tensor,
                     present: torch.Tensor, pool_ids: torch.Tensor, feat_idx: torch.Tensor,
                     hits: torch.Tensor):
    """The loop fuse's merges in the reference's order (its loop over the
    FUSE_KFS keyframes rows, each `present` or padding): a pool match on a
    feature bound to a landmark outside the pool redirects that landmark
    to the pool's, a match on an unbound feature adds the observation.
    Returns (table, valid, redirect)."""
    F = table.shape[1]
    P = valid.shape[0]
    dev = table.device
    redirect = torch.arange(P, dtype=torch.int32, device=dev)
    is_pool = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    is_pool[torch.where(pool_ids >= 0, pool_ids, P).long()] = True
    is_pool = is_pool[:P]
    pool_val = torch.where(pool_ids >= 0, pool_ids, -1)
    for w in range(rows.shape[0]):
        t = rows[w]
        hit = hits[w] & present[w]
        feat = feat_idx[w]
        cur = table[t][torch.clamp(feat, 0, F - 1).long()]
        repl = (hit & (cur >= 0) & (cur != pool_ids)
                & ~is_pool[torch.clamp(cur, 0, P - 1).long()])
        gone = torch.where(repl, cur, P)
        redirect = set_drop(redirect, gone, pool_val)
        valid = set_drop(valid, gone, False)
        add = hit & (cur < 0)
        row = set_drop(table[t], torch.where(add, feat, F), pool_val)
        table = table.clone()
        table[t] = row
    return table, valid, redirect


def loop_merge(table: torch.Tensor, valid: torch.Tensor, rows: torch.Tensor,
               present: torch.Tensor, pool_ids: torch.Tensor, feat_idx: torch.Tensor,
               hits: torch.Tensor):
    """The loop fuse's merges. CPU tensors -> plain version; CUDA tensors
    -> kernel 23's merge walk with the loop rule (or raise)."""
    if table.device.type == "cpu":
        return loop_merge_plain(table, valid, rows, present, pool_ids, feat_idx, hits)
    i32 = torch.int32
    return matching.merge_walk("loop_merge", table, valid, rows.to(i32), feat_idx, hits,
                               present=present, pool_ids=pool_ids.to(i32))


def _loop_fuse(state: MapState, tgt_ids: np.ndarray, pool_ids: torch.Tensor,
               intr: Intrinsics, max_dist: int) -> MapState:
    """SearchAndFuse: project the loop pool into each (corrected)
    current-side keyframe of tgt_ids ([FUSE_KFS], -1 padded); a match
    against a feature bound to another landmark merges that landmark into
    the loop one everywhere, a match against an unbound feature adds the
    observation. The eight matches are one batched launch (kernel 22 on
    the card; none of their inputs changes between the reference's eight
    sequential matches); the merges run in the reference's order (kernel
    23)."""
    K = state.kf_kp_mp.shape[0]
    dev = state.kf_kp_mp.device
    rows = torch.as_tensor(np.clip(tgt_ids, 0, K - 1), dtype=torch.long, device=dev)
    present = torch.as_tensor(np.asarray(tgt_ids) >= 0, device=dev)
    m = _project_pool_matches(state, rows, state.kf_T_cw[rows], pool_ids, intr, 4.0, max_dist)
    table, mp_valid, redirect = loop_merge(state.kf_kp_mp, state.mp_valid, rows, present,
                                           pool_ids, m.idx, m.valid)
    table = matching.fuse_finish(table, mp_valid, redirect, clear_invalid=False)
    return state._replace(kf_kp_mp=table, mp_valid=mp_valid)


class LoopCloser:
    """Stateful detector / corrector over the device-resident map; its
    vocabulary and BoW index also serve relocalization."""

    def __init__(self, cfg: SLAMConfig, intr: Intrinsics, seed: int = 0):
        self.cfg = cfg
        self.intr = intr
        self.voc: Optional[bow.Vocabulary] = None
        self.kf_bows: Optional[torch.Tensor] = None  # [K, W] float32, map's device
        self.kf_words: dict = {}                     # k -> [F] int32 numpy
        self._consistent_groups: List[Tuple[set, int]] = []
        self.rng = np.random.default_rng(seed)
        self.min_gap = 10         # keyframe id gap before a loop is considered
        self.consistency_th = 3   # consecutive detections required
        # persisted loop edges (i, j, S_ji), re-added to every later
        # essential-graph solve
        self.loop_edges: List[Tuple[int, int, np.ndarray]] = []
        self.n_corrections = 0
        self._descs_at_train = 0  # descriptor-pool size when the tree was trained
        self._descs_seen = 0      # descriptors indexed since

    # ------------------------------------------------------------------ #
    def _gather_descs(self, state: MapState, n_kf: int) -> np.ndarray:
        valid = state.kf_kp_valid[:n_kf].cpu().numpy()
        desc = state.kf_desc[:n_kf].cpu().numpy().view(np.uint32)
        return desc[valid]

    def _train(self, state: MapState, n_kf: int) -> int:
        descs = self._gather_descs(state, n_kf)
        if self.voc is None and len(descs) < 500:
            return 0
        self.voc = bow.train_vocabulary(descs, self.cfg.bow.branching, self.cfg.bow.depth,
                                        seed=self.cfg.seed)
        self._descs_seen = 0   # re-accumulated by the indexing that follows
        self.kf_words = {}
        K = state.kf_valid.shape[0]
        self.kf_bows = torch.zeros((K, self.voc.n_words), dtype=torch.float32,
                                   device=state.kf_valid.device)
        return len(descs)

    def ensure_vocabulary(self, state: MapState, n_kf: int) -> bool:
        if self.voc is not None:
            return True
        if n_kf < 2:
            return False
        n_desc = self._train(state, n_kf)
        if not n_desc:
            return False
        self._descs_at_train = n_desc
        self._index_keyframes(state, range(n_kf))
        return True

    def maybe_retrain(self, state: MapState, n_kf: int) -> bool:
        """The vocabulary's lifecycle: once the indexed descriptors have
        doubled since training, retrain on the whole pool and re-index
        every valid keyframe. Returns True when it retrained."""
        if self.voc is None or self._descs_seen < 2 * self._descs_at_train:
            return False
        self._descs_at_train = max(self._train(state, n_kf), 1)
        kf_ok = state.kf_valid[:n_kf].cpu().numpy()
        self._index_keyframes(state, [k for k in range(n_kf) if kf_ok[k]])
        return True

    def _index_keyframes(self, state: MapState, ks) -> None:
        """Words and BoW rows of keyframes `ks`, one kernel-13 launch."""
        ks = list(ks)
        if not ks:
            return
        ids = torch.as_tensor(ks, dtype=torch.long, device=state.kf_valid.device)
        valid = state.kf_kp_valid[ids]
        words, vecs = bow.transform(self.voc, state.kf_desc[ids], valid)
        self.kf_bows[ids] = vecs
        words = words.cpu().numpy()
        for i, k in enumerate(ks):
            self.kf_words[k] = words[i]
        self._descs_seen += int(valid.sum())

    def remap_keyframes(self, perm) -> None:
        """Follow a keyframe compaction (world/compact.compact_keyframes):
        `perm` is the [K] new -> old id table (-1 padded). The BoW rows are
        gathered on their device, dead rows zeroed; the word cache, the
        consistency groups and the loop edges are renumbered on the host,
        an entry of a culled keyframe dropped."""
        perm = np.asarray(perm)
        old2new = {int(old): new for new, old in enumerate(perm) if old >= 0}
        if self.kf_bows is not None:
            p = torch.as_tensor(perm, dtype=torch.long, device=self.kf_bows.device)
            live = (p >= 0)[:, None]
            self.kf_bows = torch.where(live, self.kf_bows[p.clamp(min=0)],
                                       torch.zeros_like(self.kf_bows))
        self.kf_words = {old2new[k]: v for k, v in self.kf_words.items() if k in old2new}
        self.loop_edges = [(old2new[a], old2new[b], S) for a, b, S in self.loop_edges
                           if a in old2new and b in old2new]
        self._consistent_groups = [(set(old2new[j] for j in grp if j in old2new), n)
                                   for grp, n in self._consistent_groups]

    def add_keyframe(self, state: MapState, k: int) -> None:
        if self.voc is not None and k not in self.kf_words:
            self._index_keyframes(state, [k])

    # ------------------------------------------------------------------ #
    def detect(self, state: MapState, n_kf: int, k: int) -> List[LoopCandidate]:
        """DetectLoop: the BoW score floor from the covisible neighbours,
        the query excluding the recent window and newer keyframes, and the
        consecutive consistency-group filter."""
        if not self.ensure_vocabulary(state, n_kf):
            return []
        if k not in self.kf_words:
            self._index_keyframes(state, [k])
        C = map_store.covisibility_matrix(state).cpu().numpy()
        kf_valid = state.kf_valid.cpu().numpy()
        K = kf_valid.shape[0]
        neighbors = np.nonzero(C[k] >= self.cfg.map.covis_threshold)[0]
        # L1 scores of row k against every row (kernel 14, nothing masked)
        scores = bow.query_database(self.kf_bows[k], self.kf_bows,
                                    torch.ones(K, dtype=torch.bool, device=self.kf_bows.device),
                                    min_score=-math.inf).cpu().numpy()
        min_score = float(scores[neighbors].min()) if len(neighbors) else 0.0
        exclude = np.zeros(K, bool)
        exclude[neighbors] = True
        exclude[max(k - self.min_gap, 0):] = True
        scores = np.where(kf_valid & ~exclude & (scores >= min_score), scores, -1.0)
        best = scores.max()
        if best <= 0:
            self._consistent_groups = []
            return []
        cand_ids = np.nonzero(scores >= max(min_score, 0.75 * best))[0]
        new_groups: List[Tuple[set, int]] = []
        consistent_enough: List[LoopCandidate] = []
        for c in cand_ids:
            group = set(np.nonzero(
                C[int(c)] >= self.cfg.map.covis_threshold)[0].tolist()) | {int(c)}
            count = 0
            for prev_group, prev_count in self._consistent_groups:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count >= self.consistency_th - 1:
                consistent_enough.append(LoopCandidate(int(c), float(scores[c])))
        self._consistent_groups = new_groups
        return consistent_enough

    # ------------------------------------------------------------------ #
    def verify(self, state: MapState, k: int, cand: int):
        """ComputeSim3: BoW-gated match >= 20 -> Sim(3) RANSAC -> Sim(3)
        widening -> the inlier-gated refinement >= 20 inliers -> the loop
        pool's projection match >= 40. Returns (S_k_cand [4, 4] numpy, the
        pool matches) or None; S maps candidate-camera coords into
        keyframe k's camera."""
        for kk in (k, cand):
            if kk not in self.kf_words:
                self._index_keyframes(state, [kk])
        words_k = self.kf_words.get(k)
        words_c = self.kf_words.get(cand)
        if words_k is None or words_c is None:
            return None
        dev = state.kf_valid.device
        cfg = self.cfg
        has_k = state.kf_kp_mp[k] >= 0
        has_c = state.kf_kp_mp[cand] >= 0
        coarse = self.voc.branching ** max(self.voc.depth - cfg.bow.feature_level_up, 1)
        wk = torch.as_tensor(words_k, device=dev)
        wc = torch.as_tensor(words_c, device=dev)
        allow = (has_k[:, None] & has_c[None, :]
                 & ((wk // coarse)[:, None] == (wc // coarse)[None, :])
                 & (wk >= 0)[:, None] & (wc >= 0)[None, :])
        m = matching.masked_match(state.kf_desc[k], state.kf_desc[cand], allow,
                                  max_dist=cfg.matching.th_low, ratio=0.75)
        ok = m.valid.cpu().numpy()
        if int(ok.sum()) < 20:
            return None
        idx = m.idx.cpu().numpy()
        X_k = _cam_points(state, k)
        Xc_all = _cam_points(state, cand)
        sel = np.nonzero(ok)[0]
        sets = np.stack([self.rng.choice(sel, 3, replace=False) for _ in range(128)])
        res = sim3_solver.ransac_sim3(X_k, Xc_all[m.idx.long()], m.valid,
                                      torch.as_tensor(sets, device=dev), self.intr,
                                      min_inliers=20)
        if not bool(res.success):
            return None
        mw = _sim3_widen_matches(state, k, cand, res.S12, self.intr, cfg.matching.th_high)
        w_ok = mw.valid.cpu().numpy() & ~ok
        j_all = np.where(ok, idx, mw.idx.cpu().numpy())
        pair_ok = (ok | w_ok) & has_k.cpu().numpy() & has_c.cpu().numpy()[j_all]
        if pair_ok.sum() < 20:
            return None
        sf = cfg.frontend.scale_factor
        sig2_k = sf ** (2.0 * state.kf_octave[k].cpu().numpy())
        sig2_c = sf ** (2.0 * state.kf_octave[cand].cpu().numpy()[j_all])
        j_t = torch.as_tensor(j_all, dtype=torch.long, device=dev)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        opt = pose_graph.optimize_sim3_pair(
            res.S12, X_k, Xc_all[j_t], state.kf_xy[k], state.kf_xy[cand][j_t],
            torch.as_tensor(pair_ok, device=dev), f32(sig2_k), f32(sig2_c),
            self.intr.fx, self.intr.fy, self.intr.cx, self.intr.cy,
            n_iters_first=cfg.optim.sim3_iters)
        if int(opt.n_inliers) < 20:
            return None
        pool = _loop_pool(state, torch.as_tensor(self._group_ids(state, cand), device=dev))
        m2 = _project_pool_matches(state, k, opt.S12 @ state.kf_T_cw[cand], pool, self.intr,
                                   10.0, cfg.matching.th_low)
        total = int(m2.valid.sum())
        if total < 40:
            return None
        return opt.S12.cpu().numpy(), total

    def _group_ids(self, state: MapState, kf: int, width: int = FUSE_KFS) -> np.ndarray:
        """kf and its strongest covisible neighbours, -1 padded to `width`."""
        w = map_store.covisibility_weights(state, int(kf)).cpu().numpy()
        order = np.argsort(w)[::-1]
        nbs = [int(kf)] + [int(i) for i in order[: width - 1]
                           if w[i] >= self.cfg.map.covis_threshold]
        nbs = nbs[:width]
        return np.asarray(nbs + [-1] * (width - len(nbs)), np.int32)

    # ------------------------------------------------------------------ #
    def correct(self, state: MapState, n_kf: int, k: int, cand: int,
                S_k_cand: np.ndarray) -> MapState:
        """CorrectLoop: the essential graph (odometry chain, spanning tree,
        every strong covisibility edge, the persisted loop edges and the
        new one) optimized in Sim(3), landmarks and line endpoints
        corrected through their reference keyframes, then the loop fuse."""
        K = state.kf_valid.shape[0]
        dev = state.kf_valid.device
        T_all = state.kf_T_cw.cpu().numpy()
        kf_ok = state.kf_valid.cpu().numpy()
        C = map_store.covisibility_matrix(state).cpu().numpy()

        edge_set = set()
        edges_i, edges_j, S_meas, weights = [], [], [], []

        def add_edge(a, b, S, w=1.0):
            key = (min(a, b), max(a, b))
            if key in edge_set:
                return
            edge_set.add(key)
            edges_i.append(a)
            edges_j.append(b)
            S_meas.append(S)
            weights.append(w)

        def rel(a, b):
            return T_all[b] @ np.linalg.inv(T_all[a])

        for a in range(n_kf - 1):                       # the odometry chain
            add_edge(a, a + 1, rel(a, a + 1))
        for j in range(2, n_kf):                        # the spanning tree
            if not kf_ok[j]:
                continue
            p = int(np.argmax(C[j, :j]))
            if C[j, p] >= self.cfg.map.covis_threshold:
                add_edge(p, j, rel(p, j))
        ii, jj = np.nonzero(np.triu(C[:n_kf, :n_kf], 2) >= 100)
        for a, b in zip(ii.tolist(), jj.tolist()):      # strong covisibility
            add_edge(a, b, rel(a, b))
        for (a, b, S_ab) in self.loop_edges:            # earlier loops
            add_edge(a, b, S_ab, 5.0)
        edge_set.discard((min(cand, k), max(cand, k)))
        add_edge(cand, k, S_k_cand, 5.0)                # the new loop edge

        E = len(edges_i)
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
        prob = pose_graph.PoseGraphProblem(
            S_cw=torch.as_tensor(T_all, device=dev), kf_valid=state.kf_valid,
            kf_fixed=(torch.arange(K, device=dev) == cand) | ~state.kf_valid,
            edge_i=i32(edges_i), edge_j=i32(edges_j),
            edge_Sji=torch.as_tensor(np.stack(S_meas).astype(np.float32), device=dev),
            edge_valid=torch.ones(E, dtype=torch.bool, device=dev),
            edge_weight=torch.as_tensor(np.asarray(weights, np.float32), device=dev))
        S_opt = pose_graph.optimize_pose_graph(
            prob, n_iters=25, lam_init=self.cfg.optim.lm_lambda_essential).cpu().numpy()

        # landmarks keep their camera-frame coords in their reference
        # keyframe: X' = S_new^-1 T_old X
        Cm = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        for a in range(n_kf):
            Cm[a] = (np.linalg.inv(S_opt[a]) @ T_all[a]).astype(np.float32)
        Cm = torch.as_tensor(Cm, device=dev)

        def moved(points, ref_kf):
            Cp = Cm[torch.clamp(ref_kf, 0, K - 1).long()]
            return torch.einsum("pij,pj->pi", Cp[:, :3, :3], points) + Cp[:, :3, 3]

        xyz = state.mp_xyz
        xyz_new = torch.where(state.mp_valid[:, None], moved(xyz, state.mp_first_kf), xyz)
        eps = state.ml_endpoints
        eps_moved = torch.cat([moved(eps[:, :3], state.ml_first_kf),
                               moved(eps[:, 3:], state.ml_first_kf)], 1)
        eps_new = torch.where(state.ml_valid[:, None], eps_moved, eps)
        T_new = T_all.copy()
        for a in range(n_kf):
            T_new[a] = _sim3_to_se3(S_opt[a])
        new_state = state._replace(kf_T_cw=torch.as_tensor(T_new, device=dev),
                                   mp_xyz=xyz_new, ml_endpoints=eps_new)

        tgt = self._group_ids(new_state, k)
        pool = _loop_pool(new_state, torch.as_tensor(self._group_ids(new_state, cand),
                                                     device=dev))
        new_state = _loop_fuse(new_state, tgt, pool, self.intr, self.cfg.matching.th_low)
        self.loop_edges.append((int(cand), int(k), np.asarray(S_k_cand)))
        self.n_corrections += 1
        return new_state


def _sim3_to_se3(S: np.ndarray) -> np.ndarray:
    """[sR | t] -> [R | t/s] (the reference's correction convention)."""
    s = np.linalg.norm(S[0, :3])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = S[:3, :3] / s
    T[:3, 3] = S[:3, 3] / s
    return T


__all__ = ["LoopCloser", "LoopCandidate", "LOOP_POOL", "FUSE_KFS", "loop_merge",
           "loop_merge_plain"]
