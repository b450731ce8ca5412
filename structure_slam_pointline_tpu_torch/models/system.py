"""System facade: the host-side state machine around the per-frame step.

Counterpart of structure_slam_pointline_tpu/models/system.py (points
half): NO_IMAGES_YET -> NOT_INITIALIZED -> OK | LOST, the two-view
bootstrap (`track` until the map exists), then `track_sequence`, one
`slam_step` per frame with the host reactions after each. (The reference
streams 100-frame `lax.scan` chunks to amortize compilation and dispatch
and reacts at chunk ends; a Python loop gains nothing from chunking.)

`SLAMSystem(cfg)` runs on the CUDA device and raises if there is none;
`device="cpu"` is the explicit opt-in the tests use. The host reactions
that are not ported yet raise NotImplementedError naming their ROADMAP.md
item instead of being skipped: relocalization (queue 1 item 14), loop
closing (item 15) and pool compaction (item 16).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np
import torch

from structure_slam_pointline_tpu_torch.config import SLAMConfig
from structure_slam_pointline_tpu_torch.models import local_mapping as lm
from structure_slam_pointline_tpu_torch.models import pipeline
from structure_slam_pointline_tpu_torch.models.tracking import Frame
from structure_slam_pointline_tpu_torch.ops import matching, twoview
from structure_slam_pointline_tpu_torch.optim import local_ba
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics
from structure_slam_pointline_tpu_torch.utils.metrics import Metrics
from structure_slam_pointline_tpu_torch.world import map_store

_RELOC = ("relocalization (BoW + PnP) is not ported yet: ROADMAP.md queue 1 "
          "item 14")
_LOOP = "loop closing is not ported yet: ROADMAP.md queue 1 item 15"
_COMPACT = "pool compaction is not ported yet: ROADMAP.md queue 1 item 16"


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
    """Monocular point SLAM over a device-resident map."""

    COMPACT_FRAC = 0.75

    def __init__(self, cfg: SLAMConfig | None = None, device=None):
        self.cfg = cfg or SLAMConfig()
        if self.cfg.use_lines:
            raise NotImplementedError(
                "use_lines=True needs the line slice (ROADMAP.md queue 1); "
                "this port runs SLAMConfig(use_lines=False)")
        self.device = resolve_device(device)
        self.metrics = Metrics()
        self.intr = Intrinsics.from_config(self.cfg.camera)
        self.localization_mode = False
        self.log: List[FrameLog] = []
        self.init_rng = np.random.default_rng(self.cfg.seed)
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
        host reactions. Returns (T_cw [N, 4, 4], ok [N], n_inliers [N],
        is_kf [N]) as numpy; a lost frame's pose is zero."""
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
            if not out.ok:
                self.sync_cursors()
                if self.cur.n_kf >= 2:
                    raise NotImplementedError(_RELOC)
            Ts.append(out.T_cw)
            ok_out[j], inl_out[j], kf_out[j] = out.ok, out.n_inliers, out.ok and out.is_kf
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
        sync, the compaction check, loop closing); the caller reacts to a
        lost frame."""
        self.carry, out = pipeline.slam_step(self.carry, self._img(img), frame_id,
                                             self.intr, self.cfg,
                                             not self.localization_mode)
        self.map = self.carry.state
        self._count_frame(out)
        if out.ok and out.is_kf:
            self.sync_cursors()
            self.maybe_compact()
            if self.cfg.enable_loop_closing:
                raise NotImplementedError(_LOOP)
        return out

    def _count_frame(self, out: pipeline.FrameOut) -> None:
        self.metrics.count("frames")
        if not out.ok:
            self.metrics.count("frames_lost")
        if out.is_kf:
            self.metrics.count("keyframes")
        if out.n_dropped:
            self.metrics.count("landmarks_clipped", out.n_dropped)

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
        m, m_valid = _init_match_device(self.ref_frame, frame, self.cfg)
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
        T = self._create_initial_map(frame, frame_id, m, out)
        self._log(frame_id, T, n_matches, True)
        return T

    def _create_initial_map(self, frame, frame_id, m, out) -> np.ndarray:
        """Two keyframes + triangulated points, scale-normalized to median
        depth 1, then a BA over the initial map."""
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
        LF = frame.line2d.shape[0]
        no_lines = t(np.full(LF, -1, np.int32), torch.int32)
        st = lm.insert_keyframe(st, 0, self.ref_frame_id, t(T0), ref_frame,
                                t(mp_of_feat0, torch.int32), no_lines, self.cfg)
        st = lm.insert_keyframe(st, 1, frame_id, t(T1), frame,
                                t(mp_of_feat1, torch.int32), no_lines, self.cfg)
        st = st._replace(mp_obs_bits=map_store.compute_obs_bits(st))
        self.map = st
        self.cur.n_kf, self.cur.n_mp, self.cur.n_ml = 2, n_new, 0
        self._run_local_ba()
        self.state = TrackingState.OK
        self.last_T = self.map.kf_T_cw[1].cpu().numpy()
        self.velocity = np.eye(4, dtype=np.float32)
        self.carry = pipeline.make_carry(
            self.map, self.last_T, self.velocity, self.cur.n_kf, self.cur.n_mp,
            n_new, n_ml=0, window_kf=self.cfg.map.local_window_kf,
            p_cap=self.cfg.map.local_points_cap, l_cap=self.cfg.map.local_lines_cap)
        return self.last_T

    def _run_local_ba(self) -> None:
        prob, local_kf, local_mp = lm.gather_ba_problem(self.map, self.cur.n_kf, self.cfg)
        result = local_ba.bundle_adjust(prob, self.intr, self.cfg.optim)
        self.map = lm.apply_ba_result(self.map, local_kf, local_mp, result)

    # ------------------------------------------------------------------ #
    def _track_device(self, img, frame_id) -> Optional[np.ndarray]:
        out = self._step(img, frame_id)
        self.state = TrackingState.OK if out.ok else TrackingState.LOST
        if out.ok:
            T = out.T_cw.cpu().numpy()
            self.last_T = T
            self._log(frame_id, T, out.n_inliers, out.is_kf)
            return T
        self.sync_cursors()
        if self.cur.n_kf <= 5:
            self._log(frame_id, None, out.n_inliers, False)
            self.reset()
            return None
        raise NotImplementedError(_RELOC)

    def _log(self, frame_id, T, n_inl, is_kf):
        self.log.append(FrameLog(frame_id, T, n_inl, is_kf, self.state))

    def activate_localization_mode(self) -> None:
        self.localization_mode = True

    def deactivate_localization_mode(self) -> None:
        self.localization_mode = False

    def reset(self) -> None:
        """Clear the map and return to the uninitialized state (the frame
        log is kept)."""
        self.map = map_store.init_map(self.cfg, self.device)
        self.cur = map_store.MapCursors()
        self.state = TrackingState.NO_IMAGES_YET
        self.velocity = np.eye(4, dtype=np.float32)
        self.last_T = np.eye(4, dtype=np.float32)
        self.ref_frame: Optional[Frame] = None
        self.ref_frame_id = -1
        self.carry: Optional[pipeline.SLAMCarry] = None

    def maybe_compact(self) -> None:
        """The reference reclaims culled slots when a bump cursor passes
        COMPACT_FRAC of its pool; not ported yet, so reaching that point
        raises."""
        if self.carry is None:
            return
        cap = self.map.capacity
        if (self.cur.n_mp > self.COMPACT_FRAC * cap["P"]
                or self.cur.n_ml > self.COMPACT_FRAC * cap["L"]
                or self.cur.n_kf > cap["K"] - 8):
            raise NotImplementedError(_COMPACT)

    def sync_cursors(self) -> None:
        if self.carry is not None:
            self.cur.n_kf = self.carry.n_kf
            self.cur.n_mp = self.carry.n_mp
            self.cur.n_ml = self.carry.n_ml

    def trajectory(self) -> dict:
        """frame_id -> T_cw for all tracked frames."""
        return {e.frame_id: e.T_cw for e in self.log if e.T_cw is not None}


def _init_match_device(ref: Frame, cur: Frame, cfg: SLAMConfig):
    """Wide-window octave-gated point match with the ratio test and the
    30-bin rotation histogram; returns (MatchResult, valid mask)."""
    allow = matching.window_mask(ref.xy, ref.kp_valid, cur.xy, cur.kp_valid,
                                 radius=100.0, kp_octave=cur.octave,
                                 pred_octave=ref.octave, octave_slack=1)
    m = matching.masked_match(ref.desc, cur.desc, allow, max_dist=cfg.matching.th_low,
                              ratio=cfg.matching.nn_ratio_init)
    m_valid = matching.rotation_consistency(ref.angle, cur.angle, m,
                                            cfg.matching.histo_bins)
    return m, m_valid


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
