"""System facade: the host-side state machine around the per-frame step.

Counterpart of structure_slam_pointline_tpu/models/system.py:
NO_IMAGES_YET -> NOT_INITIALIZED -> OK | LOST, the two-view
bootstrap (`track` until the map exists), then `track_sequence`, one
`slam_step` per frame with the host reactions after each. (The reference
streams 100-frame `lax.scan` chunks to amortize compilation and dispatch
and reacts at chunk ends; a Python loop gains nothing from chunking.)

A lost frame runs the reference's recovery ladder
(`_attempt_relocalization`): the reference-keyframe rung, then BoW + PnP
relocalization (models/relocalization.py), with the vocabulary and BoW
index of a lazily created `LoopCloser`. With `enable_loop_closing`, a
keyframe runs the loop closer's detect / verify / correct and global BA
(`_run_loop_closing`): `track_sequence` feeds it every keyframe inserted
since its last call (the reference's per-frame `_step_with_recovery`),
`track()` the newest keyframe only (its `_track_device`).

Pool compaction (`maybe_compact`, world/compact.py) runs after every
keyframe event of `_step`, from `track()` and `track_sequence` alike. The
reference's `track()` does the same; its `track_sequence` checks at the
end of each 100-frame scan chunk, and its per-frame remainder never
compacts. The outputs are the reference's: `save_trajectory_tum`,
`save_keyframe_trajectory_tum` (TUM text), `shutdown`.

`SLAMSystem(cfg)` runs on the CUDA device and raises if there is none;
`device="cpu"` is the explicit opt-in the tests use. `SLAMSystem(cfg,
mesh=...)` (parallel/mesh.py, parallel/distributed.py) runs the keyframe
pipeline's local BA and the loop closer's global BA landmark-sharded over
the mesh when it has more than one shard, where the reference passes its
mesh (system.py:60-65, :253, :482, :591); the mesh must lie on the
system's device.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np
import torch

from structure_slam_pointline_tpu_torch.config import SLAMConfig
from structure_slam_pointline_tpu_torch.models import local_mapping as lm
from structure_slam_pointline_tpu_torch.models import pipeline, relocalization, tracking
from structure_slam_pointline_tpu_torch.models.loop_closing import LoopCloser
from structure_slam_pointline_tpu_torch.models.tracking import Frame
from structure_slam_pointline_tpu_torch.ops import matching, twoview
from structure_slam_pointline_tpu_torch.optim import global_ba, local_ba
from structure_slam_pointline_tpu_torch.parallel import mesh as mesh_mod
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics
from structure_slam_pointline_tpu_torch.utils.metrics import Metrics
from structure_slam_pointline_tpu_torch.world import compact as wc
from structure_slam_pointline_tpu_torch.world import map_store


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclasses.dataclass
class FrameLog:
    frame_id: int
    T_cw: Optional[np.ndarray]
    n_inliers: int
    is_keyframe: bool
    state: TrackingState


def resolve_device(device=None) -> torch.device:
    """`None` -> the CUDA device; raises if CUDA is missing (never a
    silent CPU run). Pass "cpu" explicitly to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("SLAMSystem: CUDA is not available; pass "
                               "device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


class SLAMSystem:
    """Monocular point + line SLAM over a device-resident map."""

    COMPACT_FRAC = 0.75

    def __init__(self, cfg: SLAMConfig | None = None, mesh=None, device=None):
        self.cfg = cfg or SLAMConfig()
        self.device = resolve_device(device if device is not None or mesh is None
                                     else mesh.device)
        if mesh is not None and mesh.device != mesh_mod.resolve_device(self.device):
            raise ValueError(f"SLAMSystem: a mesh on {mesh.device} for a system on "
                             f"{self.device}")
        self.mesh = mesh
        self.metrics = Metrics()
        self.intr = Intrinsics.from_config(self.cfg.camera)
        self.localization_mode = False
        self.log: List[FrameLog] = []
        self.init_rng = np.random.default_rng(self.cfg.seed)
        # created at the first lost frame; reset() keeps it, as the reference does
        self._loop_closer: Optional[LoopCloser] = None
        # landmark-rate baseline (cursors and live counts of the last keyframe
        # event); None after a host-side renumbering (compaction, a loop
        # correction). reset() keeps it, as the reference does
        self._lm_base = None
        self.reset()

    # ------------------------------------------------------------------ #
    def build_frame(self, img, init_mode: bool = False) -> Frame:
        cfg = self.cfg
        if init_mode and cfg.frontend.n_keypoints_init != cfg.frontend.n_keypoints:
            cfg = cfg.replace(frontend=dataclasses.replace(
                cfg.frontend, n_keypoints=cfg.frontend.n_keypoints_init))
        return pipeline.build_frame_device(self._img(img), self.intr, cfg)

    def _img(self, img) -> torch.Tensor:
        return torch.as_tensor(np.asarray(img, np.float32) if not isinstance(
            img, torch.Tensor) else img, dtype=torch.float32, device=self.device)

    def track(self, img, frame_id: int) -> Optional[np.ndarray]:
        """Process one grayscale frame; returns T_cw (4x4) or None."""
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            return self._try_initialize(img, frame_id)
        return self._track_device(img, frame_id)

    def track_sequence(self, imgs, first_frame_id: int):
        """Stream an [N, H, W] sequence frame by frame with the reference's
        host reactions (its per-frame `_step_with_recovery`): a lost frame
        with >= 2 keyframes in the map runs the recovery ladder, and a
        recovered pose counts as tracked. Returns (T_cw [N, 4, 4], ok [N],
        n_inliers [N], is_kf [N]) as numpy; a lost frame's pose is zero."""
        if self.carry is None:
            raise RuntimeError("track_sequence needs an initialized map: call "
                               "track() until the bootstrap succeeds")
        n = len(imgs)
        ok_out = np.zeros(n, bool)
        inl_out = np.zeros(n, np.int32)
        kf_out = np.zeros(n, bool)
        Ts = []
        for j in range(n):
            out = self._step(imgs[j], first_frame_id + j)
            T_j, ok_j = out.T_cw, out.ok
            if not out.ok:
                self.sync_cursors()
                if self.cur.n_kf >= 2:
                    self.metrics.count("reloc_attempts")
                    T_rec = self._attempt_relocalization(imgs[j], first_frame_id + j)
                    if T_rec is not None:
                        self.metrics.count("reloc_success")
                        T_j, ok_j = torch.as_tensor(T_rec, device=self.device), True
            elif out.is_kf and self.cfg.enable_loop_closing:
                self._loop_close_new_keyframes()
            Ts.append(T_j)
            ok_out[j], inl_out[j], kf_out[j] = ok_j, out.n_inliers, out.ok and out.is_kf
        T_out = torch.stack(Ts).cpu().numpy()   # one device -> host copy
        T_out[~ok_out] = 0.0
        for k in range(n):
            self.state = TrackingState.OK if ok_out[k] else TrackingState.LOST
            self._log(first_frame_id + k, T_out[k] if ok_out[k] else None,
                      int(inl_out[k]), bool(kf_out[k]))
        self.sync_cursors()
        self.last_T = T_out[-1]
        return T_out, ok_out, inl_out, kf_out

    def _step(self, img, frame_id: int) -> pipeline.FrameOut:
        """One `slam_step`, its counters and the keyframe reactions (cursor
        sync, the compaction check); the caller reacts to a lost frame and
        runs loop closing, which differs between `track` and
        `track_sequence` as in the reference."""
        self.carry, out = pipeline.slam_step(self.carry, self._img(img), frame_id,
                                             self.intr, self.cfg,
                                             not self.localization_mode, mesh=self.mesh)
        self.map = self.carry.state
        self._count_frame(out)
        self._count_landmark_deltas(out)
        if out.ok and out.is_kf:
            self.sync_cursors()
            self.maybe_compact()
        return out

    def _count_frame(self, out: pipeline.FrameOut) -> None:
        self.metrics.count("frames")
        if not out.ok:
            self.metrics.count("frames_lost")
        if out.is_kf:
            self.metrics.count("keyframes")
        if out.n_dropped:
            self.metrics.count("landmarks_clipped", out.n_dropped)

    def _count_landmark_deltas(self, out: pipeline.FrameOut) -> None:
        """Landmark rate counters from the cursors and the live counts of a
        keyframe event: created = cursor delta, removed (culled or fused) =
        created - live delta (the reference's system.py:282-297)."""
        if out.n_live_mp is None:
            return
        cur = (out.n_mp, out.n_ml, out.n_live_mp, out.n_live_ml)
        base = self._lm_base
        if base is not None and cur[0] >= base[0] and cur[1] >= base[1]:
            mp_new, ml_new = cur[0] - base[0], cur[1] - base[1]
            self.metrics.count("points_created", mp_new)
            self.metrics.count("lines_created", ml_new)
            self.metrics.count("points_removed", mp_new - (cur[2] - base[2]))
            self.metrics.count("lines_removed", ml_new - (cur[3] - base[3]))
        self._lm_base = cur

    # ------------------------------------------------------------------ #
    # initialization (reference Tracking::MonocularInitialization)
    # ------------------------------------------------------------------ #
    def _try_initialize(self, img, frame_id) -> Optional[np.ndarray]:
        frame = self.build_frame(img, init_mode=True)
        n_valid = int(frame.kp_valid.sum())
        if self.ref_frame is None or n_valid < 100:
            if n_valid >= 100:
                self.ref_frame = frame
                self.ref_frame_id = frame_id
                self.state = TrackingState.NOT_INITIALIZED
            self._log(frame_id, None, 0, False)
            return None
        m, m_valid, ml = _init_match_device(self.ref_frame, frame, self.cfg)
        valid_np = m_valid.cpu().numpy()
        n_matches = int(valid_np.sum())
        if n_matches < self.cfg.init.min_matches:
            self.ref_frame = frame
            self.ref_frame_id = frame_id
            self._log(frame_id, None, 0, False)
            return None
        sets = np.stack([
            self.init_rng.choice(np.nonzero(valid_np)[0], 8, replace=False)
            for _ in range(self.cfg.init.ransac_iters)])
        out = twoview.initialize_two_view(
            self.ref_frame.xy, frame.xy[m.idx.long()], m_valid,
            torch.as_tensor(sets, device=self.device), self.intr,
            sigma=self.cfg.init.sigma, min_triangulated=self.cfg.init.min_triangulated,
            rh_threshold=self.cfg.init.rh_threshold,
            min_parallax_deg=self.cfg.init.min_parallax_deg)
        if not bool(out.success):
            self._log(frame_id, None, 0, False)
            return None
        T = self._create_initial_map(frame, frame_id, m, out, ml)
        self._log(frame_id, T, n_matches, True)
        return T

    def _create_initial_map(self, frame, frame_id, m, out, ml=None) -> np.ndarray:
        """Two keyframes + triangulated points and lines, scale-normalized
        to median point depth 1, then a BA over the initial map."""
        good = out.good_mask.cpu().numpy()
        X = out.points3d.cpu().numpy()
        med = float(np.median(X[good, 2])) if good.any() else 1.0
        X = X / med
        T0 = np.eye(4, dtype=np.float32)
        T1 = np.eye(4, dtype=np.float32)
        T1[:3, :3] = out.R.cpu().numpy()
        T1[:3, 3] = out.t.cpu().numpy() / med
        ids = np.nonzero(good)[0]
        n_new = len(ids)
        idx_np = m.idx.cpu().numpy()
        F = self.cfg.frontend.n_keypoints
        ref_frame = self.ref_frame
        if frame.xy.shape[0] != F:
            if n_new > F:
                ids = ids[:F]
                n_new = F
            ref_frame = _shrink_to_budget(ref_frame, ids, F)
            frame = _shrink_to_budget(frame, idx_np[ids], F)
            mp_of_feat0 = np.full(F, -1, np.int32)
            mp_of_feat0[:n_new] = np.arange(n_new)
            mp_of_feat1 = mp_of_feat0.copy()
        else:
            mp_of_feat0 = np.full(F, -1, np.int32)
            mp_of_feat0[ids] = np.arange(n_new)
            mp_of_feat1 = np.full(F, -1, np.int32)
            mp_of_feat1[idx_np[ids]] = np.arange(n_new)
        dev = self.device
        ang_ref = ref_frame.angle.cpu().numpy()
        ang_new = ang_ref[:n_new] if ref_frame is not self.ref_frame else ang_ref[ids]
        st = self.map
        t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731

        def head(x, v):
            x = x.clone()
            x[:n_new] = v
            return x

        st = st._replace(
            mp_xyz=head(st.mp_xyz, t(X[ids])),
            mp_valid=head(st.mp_valid, True),
            mp_angle=head(st.mp_angle, t(ang_new)),
            mp_first_kf=head(st.mp_first_kf, 0),
            mp_last_kf=head(st.mp_last_kf, 1),
            mp_visible=head(st.mp_visible, 2),
            mp_found=head(st.mp_found, 2))
        # matched lines cut by the two view planes (Initializer::LineTriangulate)
        LF = frame.line2d.shape[0]
        line_ml0 = np.full(LF, -1, np.int32)
        line_ml1 = np.full(LF, -1, np.int32)
        n_newl = 0
        if ml is not None:
            tri = twoview.triangulate_lines(ref_frame.line2d, ref_frame.line_ep,
                                            frame.line2d[ml.idx.long()], ml.valid, out.R, out.t,
                                            self.intr.K(dev))
            lids = np.nonzero(tri.good.cpu().numpy())[0]
            n_newl = len(lids)
            if n_newl:
                eps = np.concatenate([tri.start.cpu().numpy()[lids] / med,
                                      tri.end.cpu().numpy()[lids] / med], 1)

                def lhead(x, v):
                    x = x.clone()
                    x[:n_newl] = v
                    return x

                st = st._replace(ml_endpoints=lhead(st.ml_endpoints, t(eps)),
                                 ml_valid=lhead(st.ml_valid, True),
                                 ml_first_kf=lhead(st.ml_first_kf, 0),
                                 ml_last_kf=lhead(st.ml_last_kf, 1),
                                 ml_visible=lhead(st.ml_visible, 2),
                                 ml_found=lhead(st.ml_found, 2))
                line_ml0[lids] = np.arange(n_newl)
                line_ml1[ml.idx.cpu().numpy()[lids]] = np.arange(n_newl)
        st = lm.insert_keyframe(st, 0, self.ref_frame_id, t(T0), ref_frame,
                                t(mp_of_feat0, torch.int32), t(line_ml0, torch.int32), self.cfg)
        st = lm.insert_keyframe(st, 1, frame_id, t(T1), frame,
                                t(mp_of_feat1, torch.int32), t(line_ml1, torch.int32), self.cfg)
        st = st._replace(mp_obs_bits=map_store.compute_obs_bits(st))
        self.map = st
        self.cur.n_kf, self.cur.n_mp, self.cur.n_ml = 2, n_new, n_newl
        self._run_local_ba()
        self.state = TrackingState.OK
        self.last_T = self.map.kf_T_cw[1].cpu().numpy()
        self.velocity = np.eye(4, dtype=np.float32)
        self.carry = pipeline.make_carry(
            self.map, self.last_T, self.velocity, self.cur.n_kf, self.cur.n_mp,
            n_new, n_ml=n_newl, window_kf=self.cfg.map.local_window_kf,
            p_cap=self.cfg.map.local_points_cap, l_cap=self.cfg.map.local_lines_cap)
        return self.last_T

    def _run_local_ba(self) -> None:
        prob, lines, local_kf, local_mp, local_ln = lm.gather_ba_problem(
            self.map, self.cur.n_kf, self.cfg)
        result = local_ba.bundle_adjust(prob, self.intr, self.cfg.optim, lines=lines)
        self.map = lm.apply_ba_result(self.map, local_kf, local_mp, result, local_ln=local_ln)

    # ------------------------------------------------------------------ #
    def _track_device(self, img, frame_id) -> Optional[np.ndarray]:
        out = self._step(img, frame_id)
        self.state = TrackingState.OK if out.ok else TrackingState.LOST
        if out.ok:
            T = out.T_cw.cpu().numpy()
            self.last_T = T
            self._log(frame_id, T, out.n_inliers, out.is_kf)
            if out.is_kf and self.cfg.enable_loop_closing:
                self._run_loop_closing()
            return T
        self.sync_cursors()
        if self.cur.n_kf <= 5:
            # lost right after initialization: start over
            self._log(frame_id, None, out.n_inliers, False)
            self.reset()
            return None
        T_rel = self._attempt_relocalization(img, frame_id)
        self._log(frame_id, T_rel, out.n_inliers, False)
        return T_rel

    def _attempt_relocalization(self, img, frame_id) -> Optional[np.ndarray]:
        """Recovery ladder of a lost frame: (1) BoW-gated matching against
        the reference keyframe + pose LM from `last_T`, (2) BoW + PnP
        relocalization. On success the per-frame step restarts from the
        recovered pose with zero velocity and the stricter inlier gate for
        `keyframe.max_frames` frames."""
        frame = self.build_frame(img)
        lc = self._get_loop_closer()
        T = relocalization.track_reference_keyframe(self.map, self.cur.n_kf, frame, lc,
                                                    self.last_T, self.intr, self.cfg)
        if T is not None:
            self.metrics.count("reloc_ref_kf")
        else:
            T = relocalization.relocalize(self.map, self.cur.n_kf, frame, lc, self.intr,
                                          self.cfg, self.init_rng)
        if T is None:
            return None
        self.carry = self.carry._replace(
            T_last=torch.as_tensor(T, dtype=torch.float32, device=self.device),
            velocity=torch.eye(4, dtype=torch.float32, device=self.device),
            ok=True, recover_hold=self.cfg.keyframe.max_frames)
        self.last_T = np.asarray(T)
        self.state = TrackingState.OK
        return np.asarray(T)

    def _get_loop_closer(self) -> LoopCloser:
        if self._loop_closer is None:
            self._loop_closer = LoopCloser(self.cfg, self.intr, seed=self.cfg.seed)
        return self._loop_closer

    def _loop_close_new_keyframes(self) -> None:
        """Feed every keyframe inserted since the last call through the
        loop closer (its own cursor: the allocation cursors may have moved
        since)."""
        self.sync_cursors()
        for k in range(max(self._lc_processed_kf, 2), self.cur.n_kf):
            self._run_loop_closing(k)
        self._lc_processed_kf = self.cur.n_kf

    def _run_loop_closing(self, k: int | None = None) -> None:
        """Detect, verify and correct a loop at keyframe k (default: the
        newest), then global BA and the carry update: T_last keeps its pose
        relative to the newest keyframe, velocity restarts at I, the local
        sets are recomputed (the fuse invalidated merged landmarks)."""
        lc = self._get_loop_closer()
        self.sync_cursors()
        n_kf = self.cur.n_kf
        if k is None:
            k = n_kf - 1
        if lc.voc is not None and lc.maybe_retrain(self.map, n_kf):
            self.metrics.count("vocab_retrained")
        lc.add_keyframe(self.map, k)
        for cand in lc.detect(self.map, n_kf, k):
            self.metrics.count("loop_candidates")
            ver = lc.verify(self.map, k, cand.kf_id)
            if ver is None:
                continue
            self.metrics.count("loop_verified")
            new_state = lc.correct(self.map, n_kf, k, cand.kf_id, ver[0])
            self.metrics.count("loop_corrected")
            self._lm_base = None   # the fuse removed landmarks: re-baseline
            new_state = global_ba.global_bundle_adjust(new_state, n_kf, self.intr, self.cfg,
                                                       mesh=self.mesh, metrics=self.metrics)
            kl = n_kf - 1
            T_kl_old = self.map.kf_T_cw[kl].cpu().numpy()
            T_kl_new = new_state.kf_T_cw[kl].cpu().numpy()
            T_last_old = self.carry.T_last.cpu().numpy()
            T_last_new = (T_last_old @ np.linalg.inv(T_kl_old) @ T_kl_new).astype(np.float32)
            self.map = new_state
            self.carry = self.carry._replace(
                state=new_state,
                T_last=torch.as_tensor(T_last_new, device=self.device),
                velocity=torch.eye(4, dtype=torch.float32, device=self.device),
                local_sets=tracking.compute_local_sets(
                    new_state, n_kf, self.cfg.map.local_window_kf,
                    self.cfg.map.local_points_cap, self.cfg.map.local_lines_cap))
            self.last_T = T_last_new
            break

    def _log(self, frame_id, T, n_inl, is_kf):
        self.log.append(FrameLog(frame_id, T, n_inl, is_kf, self.state))

    def activate_localization_mode(self) -> None:
        self.localization_mode = True

    def deactivate_localization_mode(self) -> None:
        self.localization_mode = False

    def reset(self) -> None:
        """Clear the map and return to the uninitialized state (the frame
        log and the loop closer's vocabulary and index are kept, as in the
        reference)."""
        self.map = map_store.init_map(self.cfg, self.device)
        self.cur = map_store.MapCursors()
        self.state = TrackingState.NO_IMAGES_YET
        self.velocity = np.eye(4, dtype=np.float32)
        self.last_T = np.eye(4, dtype=np.float32)
        self.ref_frame: Optional[Frame] = None
        self.ref_frame_id = -1
        self.carry: Optional[pipeline.SLAMCarry] = None
        self._lc_processed_kf = 2   # keyframes already fed to loop closing

    def shutdown(self) -> None:
        """Wait for the device's outstanding work and sync the cursors (the
        reference's System::Shutdown; there are no threads to join)."""
        if self.carry is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.sync_cursors()

    def maybe_compact(self) -> None:
        """Reclaim culled slots when a bump cursor passes its high-water
        mark (COMPACT_FRAC of the point and line pools, K - 8 keyframes):
        live entries renumber to the front and every reference follows
        (world/compact.py). Each pass reads its live count once; the carry
        takes the new cursors and fresh local sets (the old ones hold stale
        landmark ids), the loop closer and its cursor follow the keyframe
        permutation, and the landmark-rate baseline restarts."""
        if self.carry is None:
            return
        cap = self.map.capacity
        st = self.carry.state
        n_kf, n_mp, n_ml = self.cur.n_kf, self.cur.n_mp, self.cur.n_ml
        changed = False
        if n_mp > self.COMPACT_FRAC * cap["P"]:
            st, n_live = wc.compact_points(st)
            n_mp = int(n_live)
            changed = True
            self.metrics.count("compact_points")
        if n_ml > self.COMPACT_FRAC * cap["L"]:
            st, n_live = wc.compact_lines(st)
            n_ml = int(n_live)
            changed = True
            self.metrics.count("compact_lines")
        if n_kf > cap["K"] - 8:
            st, _, perm = wc.compact_keyframes(st)
            perm_np = perm.cpu().numpy()   # the pass's one read: n_live is the live prefix
            n_kf = int((perm_np >= 0).sum())
            changed = True
            self.metrics.count("compact_keyframes")
            if self._loop_closer is not None:
                self._loop_closer.remap_keyframes(perm_np)
            self._lc_processed_kf = _remap_kf_cursor(perm_np, self._lc_processed_kf)
        if changed:
            self._lm_base = None
            self.map = st
            self.carry = self.carry._replace(
                state=st, n_kf=n_kf, n_mp=n_mp, n_ml=n_ml,
                local_sets=tracking.compute_local_sets(
                    st, n_kf, self.cfg.map.local_window_kf, self.cfg.map.local_points_cap,
                    self.cfg.map.local_lines_cap))
            self.cur.n_kf, self.cur.n_mp, self.cur.n_ml = n_kf, n_mp, n_ml

    def sync_cursors(self) -> None:
        if self.carry is not None:
            self.cur.n_kf = self.carry.n_kf
            self.cur.n_mp = self.carry.n_mp
            self.cur.n_ml = self.carry.n_ml

    def trajectory(self) -> dict:
        """frame_id -> T_cw for all tracked frames."""
        return {e.frame_id: e.T_cw for e in self.log if e.T_cw is not None}

    def save_keyframe_trajectory_tum(self, path: str, timestamps=None) -> None:
        """TUM text (`t tx ty tz qx qy qz qw` of T_wc), the valid keyframes
        below the cursor in id order; one copy of the keyframe fields."""
        self.sync_cursors()
        T_cw = self.map.kf_T_cw.cpu().numpy()
        fids = self.map.kf_frame_id.cpu().numpy()
        valid = self.map.kf_valid.cpu().numpy()
        with open(path, "w") as f:
            for k in range(self.cur.n_kf):
                if valid[k]:
                    fid = int(fids[k])
                    f.write(_tum_row(timestamps[fid] if timestamps is not None else float(fid),
                                     T_cw[k]))

    def save_trajectory_tum(self, path: str, timestamps=None) -> None:
        """TUM text of every tracked frame of the log, in log order."""
        with open(path, "w") as f:
            for e in self.log:
                if e.T_cw is not None:
                    f.write(_tum_row(timestamps[e.frame_id] if timestamps is not None
                                     else float(e.frame_id), e.T_cw))


def _tum_row(ts: float, T_cw: np.ndarray) -> str:
    """One TUM line of the camera-to-world pose of T_cw."""
    T_wc = np.linalg.inv(T_cw)
    t = T_wc[:3, 3]
    q = _rot_to_quat(T_wc[:3, :3])
    return (f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
            f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), the reference's branches."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[3] = (R[k, j] - R[j, k]) / s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    return q


def _remap_kf_cursor(perm: np.ndarray, cursor: int) -> int:
    """A 'keyframes [0, cursor) processed' cursor through a compaction
    permutation ([K] new -> old, -1 padded): the number of surviving
    keyframes whose old id was below it (so culls below the cursor do not
    make it skip unprocessed keyframes above it)."""
    live = perm[perm >= 0]
    return int((live < cursor).sum())


def _init_match_device(ref: Frame, cur: Frame, cfg: SLAMConfig):
    """Bootstrap matching, points and lines: wide-window octave-gated point
    match with the ratio test and the 30-bin rotation histogram; with
    lines, a 100 px midpoint-window LBD match with the MAD margin gate.
    Returns (point MatchResult, valid mask, line MatchResult or None)."""
    allow = matching.window_mask(ref.xy, ref.kp_valid, cur.xy, cur.kp_valid,
                                 radius=100.0, kp_octave=cur.octave,
                                 pred_octave=ref.octave, octave_slack=1)
    m = matching.masked_match(ref.desc, cur.desc, allow, max_dist=cfg.matching.th_low,
                              ratio=cfg.matching.nn_ratio_init)
    m_valid = matching.rotation_consistency(ref.angle, cur.angle, m,
                                            cfg.matching.histo_bins)
    ml = None
    if cfg.use_lines:
        mid_r = 0.5 * (ref.line_ep[:, 0:2] + ref.line_ep[:, 2:4])
        mid_c = 0.5 * (cur.line_ep[:, 0:2] + cur.line_ep[:, 2:4])
        allow_l = matching.window_mask(mid_r, ref.line_valid, mid_c, cur.line_valid, 100.0)
        ml = matching.masked_match(ref.ldesc, cur.ldesc, allow_l, max_dist=cfg.matching.th_high)
        ml = ml._replace(valid=matching.mad_margin_gate(ml, scale=cfg.matching.line_mad_ratio))
    return m, m_valid, ml


def _shrink_to_budget(frame: Frame, priority: np.ndarray, F: int) -> Frame:
    """Init-budget frame -> pool width F, `priority` features first, the
    rest in selection order; line fields pass through."""
    F2 = frame.xy.shape[0]
    rest = np.setdiff1d(np.arange(F2), priority)
    perm = np.concatenate([priority, rest])[:F].astype(np.int64)
    sel = torch.as_tensor(perm, device=frame.xy.device)
    return frame._replace(xy=frame.xy[sel], desc=frame.desc[sel],
                          octave=frame.octave[sel], angle=frame.angle[sel],
                          kp_valid=frame.kp_valid[sel])


__all__ = ["SLAMSystem", "TrackingState", "FrameLog", "resolve_device"]
