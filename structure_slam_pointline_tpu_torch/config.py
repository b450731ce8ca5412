"""Typed configuration for the TPU point+line SLAM engine.

One dataclass covers both what the reference reads from OpenCV YAML
(camera intrinsics / distortion / fps / ORB params, reference
src/Tracking.cc:48-127) and the thresholds the reference hardcodes
(catalog: ORBmatcher.cc:37-39, Optimizer.cc:700-701/870-872,
Tracking.cc:1371-1453, LocalMapping.cc:305-361/1443).

All sizes that shape device arrays are static (fixed capacities + masks),
so every pipeline step has static shapes under jit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera with radial-tangential distortion (Tracking.cc:49-81)."""

    fx: float = 481.20
    fy: float = -480.00  # ICL-NUIM negative-fy convention (Examples/ICL.yaml:8-11)
    cx: float = 319.50
    cy: float = 239.50
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 30.0

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Feature extraction budgets (Examples/ICL.yaml:40, Tracking.cc:119-120,
    ExtractLineSegment.cpp:42)."""

    n_keypoints: int = 1024          # run-time ORB budget (ref: 1000, padded to 2^k)
    n_keypoints_init: int = 2048     # init-time ORB budget: the reference
    # DOUBLES the runtime budget during initialization (2000,
    # Tracking.cc:119-120); the initial-map creation shrinks the two
    # bootstrap frames back to the runtime pool width, triangulated
    # features first. Round 4 shipped 1024 because the doubled budget
    # collapsed fast-motion bootstraps (13/200 frames tracked); that
    # collapse was a frontend-repeatability artifact — with sub-pixel
    # keypoints + 64 rotation banks the same scenario tracks 200/200 at
    # ATE 0.0067 with the doubled budget (round 5), so the reference
    # default ships.
    n_levels: int = 8                # pyramid levels (ORBextractor.cc ctor)
    scale_factor: float = 1.2
    fast_threshold: float = 20.0     # iniThFAST (Examples/ICL.yaml:49)
    fast_min_threshold: float = 7.0  # minThFAST fallback (Examples/ICL.yaml:52)
    cell_size: int = 32              # selection grid cell (ref: 30px, ComputeKeyPointsOctTree)
    patch_radius: int = 15           # IC_Angle / BRIEF patch half-size (ORBextractor.cc:63)
    n_brief_pairs: int = 256         # 256-bit descriptor
    blur_sigma: float = 2.0          # GaussianBlur(7,7,2,2) before describe (ORBextractor.cc:1067)

    n_lines: int = 64                # line budget (ref keeps top-40, ExtractLineSegment.cpp:42-51)
    line_anchor_count: int = 256     # refinement candidates from the dense support pass
    line_walk_steps: int = 48        # refinement corridor samples each side (2 px spacing)
    line_refine_iters: int = 2       # refit passes before the final eval pass
                                     # (corridor gathers are the detector's top
                                     # device cost; below 2 refits long shallow
                                     # segments lose endpoint reach)
    line_support_downsample: int = 1  # dense anchor search at 1/ds resolution
                                      # (refinement always runs full-res); measured
                                      # SLOWER at 2 on TPU v5e: strided 2x2 box
                                      # slicing costs more than the support saves
    line_octaves: int = 2            # pyramid octaves for line detection
                                     # (ref LSDDetector runs a scale pyramid,
                                     # ExtractLineSegment.cpp:39-40); factor-2
                                     # octaves here (one 2x2-box downsample)
    line_scale_factor: float = 2.0   # per-octave scale for line sigma^2
    line_grad_threshold: float = 10.0
    line_angle_tol: float = 0.3926990816987  # 22.5 deg orientation alignment tolerance
    line_min_length: float = 24.0    # min segment length in px

    # NOTE: the reference's 64x48 feature-lookup grid (Frame.h:45-46) has no
    # equivalent here by design — windowed search is a dense [M, N] mask on
    # the Hamming matrix (ops/matching.window_mask), so there are no grid
    # shape knobs.


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    """Descriptor matching thresholds (ORBmatcher.cc:37-39, LSDmatcher.cpp:15-16)."""

    th_high: int = 100
    th_low: int = 50
    histo_bins: int = 30             # rotation-consistency histogram
    nn_ratio_tracking: float = 0.9   # SearchByProjection ratio (Tracking.cc:1221)
    nn_ratio_localmap: float = 0.8   # TrackLocalMap pass ratio: the reference
    # constructs SearchLocalPoints' matcher with 0.8 (Tracking.cc:1729)
    nn_ratio_bow: float = 0.7        # TrackReferenceKeyFrame ratio (Tracking.cc:1016)
    nn_ratio_init: float = 0.9       # SearchForInitialization (Tracking.cc:364)
    search_radius_motion: float = 15.0   # window for motion-model search (th=7..15, ORBmatcher)
    search_radius_reloc: float = 10.0
    line_mad_ratio: float = 0.5      # MAD margin gate scale: accept a line
    # match when (second - best) > scale * 1.4826 * MAD of the margins
    # (reference nn12_dist_th * 0.5, LSDmatcher.cpp:268-283; Frame.cc:190-216)


@dataclasses.dataclass(frozen=True)
class InitConfig:
    """Two-view monocular bootstrap (Initializer.cc:55-153)."""

    ransac_iters: int = 200
    sigma: float = 1.0
    min_matches: int = 100           # Tracking.cc:371
    rh_threshold: float = 0.40       # model select RH=SH/(SH+SF) (Initializer.cc:143)
    min_triangulated: int = 50
    min_parallax_deg: float = 2.0    # a 1-deg gate admitted near-degenerate
    # bootstraps on slow trajectories whose early-segment wobble dominated
    # whole-run ATE (err_max 0.075 concentrated in the first 50 frames);
    # 2 deg delays init a few frames and halves the tail


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """LM budgets + chi2 gates (Optimizer.cc:700-701, 870-872, 1475, 1522)."""

    pose_rounds: int = 4             # 4 rounds x 10 iters pose-only LM
    pose_iters: int = 6
    # pass-1 (motion-model) budget: its pose only seeds pass-2's 4 px
    # projection windows, so it converges in far fewer iterations than
    # the final pass-2 estimate needs; 2x4 vs 4x6 halves the per-frame
    # LM edge passes (the reference runs full 4x10 in both passes,
    # Optimizer.cc:700 — parity kept where it matters, pass 2)
    pose_rounds_pass1: int = 2
    pose_iters_pass1: int = 4
    chi2_mono: float = 5.991         # 2-DoF 95% gate for point edges
    chi2_line: float = 5.991         # per line-endpoint gate (Optimizer.cc:870-872 uses 2x5.991/line)
    huber_delta_point: float = 2.4477  # sqrt(5.991) (Optimizer.cc:700)
    huber_delta_line: float = 2.7955   # sqrt(7.815) (Optimizer.cc:701)
    line_pose_weight: float = 0.0    # information scale of line edges in
    # the PER-FRAME pose optimization (1.0 = reference parity,
    # Optimizer.cc:855-872 weights lines like points). Map-line endpoint
    # geometry is rougher than point geometry (endpoints slide along the
    # line in BA; the point-to-infinite-line residual barely penalizes a
    # wrong parallel match), and at full weight line edges measurably
    # BIAS the per-frame pose (wall-scene ATE 0.019 vs 0.012 with lines
    # excluded from pose opt; map/BA line edges are not the problem —
    # ablated independently). 0 disables pose-opt line edges entirely
    # while keeping line observations, matching, and BA intact.
    local_ba_iters_first: int = 5
    local_ba_iters_second: int = 15  # reference runs 5 + 10
    # (Optimizer::LocalBundleAdjustment, Optimizer.cc:1475/1522); the
    # TPU Schur solve is ~126 us/frame amortized, so 5 more second-stage
    # iterations are nearly free and measurably tighten the map
    # (40-line bench scene ATE 0.0104 -> 0.0082, A/B'd with pose_iters
    # and line ablations held fixed)
    lm_lambda_init: float = 1e-4
    lm_lambda_essential: float = 1e-16  # essential-graph solver init (Optimizer.cc:1609)
    sim3_iters: int = 5


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Fixed pool capacities for the struct-of-arrays map store."""

    max_keyframes: int = 256
    max_points: int = 32768
    max_lines: int = 2048
    # tracking local-map capacities (static problem shapes): the per-frame
    # matching matrices are [cap, F], so these are the tracking-cost
    # knobs. The reference's local map is uncapped (all points of <= 80
    # covisible KFs, Tracking.cc:1762); on exploratory trajectories whose
    # covisible set exceeds the cap, raise it (matching cost scales
    # linearly) — overflow evicts least-recently-seen landmarks.
    local_points_cap: int = 2048
    local_lines_cap: int = 256
    # NOTE: no per-landmark observation tables exist — observations live in
    # the [K, F] keyframe-major edge grid (world/map_store.py), so there is
    # no obs-capacity knob.
    local_window_kf: int = 20        # covisibility neighborhood (LocalMapping.cc:371)
    covis_threshold: int = 15        # essential covisibility weight (KeyFrame.cc:301-415)
    point_cull_found_ratio: float = 0.25  # LocalMapping.cc:305
    line_cull_found_ratio: float = 0.60   # LocalMapping.cc:351
    kf_cull_redundancy: float = 0.90      # LocalMapping.cc:1443


@dataclasses.dataclass(frozen=True)
class BoWConfig:
    """Vocabulary-tree place recognition (DBoW2-equivalent).

    A self-trained k-ary binary-descriptor tree laid out level-major so
    transform() is a fixed-depth argmin chain on device.
    """

    branching: int = 8
    depth: int = 4                   # 8^4 = 4096 leaves
    feature_level_up: int = 2        # FeatureVector node level = depth - level_up


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe decision thresholds (Tracking.cc:1380-1479)."""

    min_frames: int = 2              # reference uses 0 (Tracking.cc:136) but
    # throttles insertion through the LocalMapping-idle bit (c1b,
    # Tracking.cc:1445); our synchronous mapping has no busy state, so an
    # unthrottled 'weak' trigger inserted a keyframe EVERY frame on
    # rotating trajectories (137 KFs in 137 frames), churning the pools
    # and degenerating the local-BA window. A 2-frame floor is the
    # synchronous analog of the reference's mapping-latency throttle.
    max_frames: int = 30             # = fps
    min_tracked_ratio: float = 0.8   # thRefRatio. The reference uses 0.9
    # for mono (Tracking.cc:1450) against the ref KF's MATURED coverage
    # (TrackedMapPoints(minObs=3)); ours compares against the RUNNING
    # INLIER PEAK since the last keyframe, which includes the fresh
    # post-triangulation spike and frame noise (~+10%) the reference
    # count excludes — 0.8 x peak ~ 0.9 x mature coverage. At 0.9 the
    # peak trigger fired on per-frame noise on easy scenes (keyframe
    # every ~2.3 frames, 2.6x bench slowdown).
    min_inliers: int = 30
    min_inliers_track: int = 15      # below this the wide fallback re-track
                                     # fires (TrackReferenceKeyFrame's role,
                                     # Tracking.cc:212; ref fails motion-model
                                     # tracking under ~10 map inliers)
    min_inliers_healthy: int = 30    # TrackLocalMap health gate
                                     # (Tracking.cc:284-287: <=30 inliers -> LOST)
    min_inliers_recover: int = 50    # stricter gate on the first frame after
                                     # being lost (Tracking.cc:284: 50 right
                                     # after relocalization)
    min_matches_reloc: int = 15


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    matching: MatchingConfig = dataclasses.field(default_factory=MatchingConfig)
    init: InitConfig = dataclasses.field(default_factory=InitConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    bow: BoWConfig = dataclasses.field(default_factory=BoWConfig)
    keyframe: KeyframeConfig = dataclasses.field(default_factory=KeyframeConfig)
    seed: int = 0                    # deterministic RANSAC (ref: DUtils::Random seed 0)
    use_lines: bool = True
    enable_loop_closing: bool = False  # reference ships with the thread disabled (System.cc:98)
    # Comma-separated keyframe-pipeline stage skips for perf ATTRIBUTION
    # (scripts/bench_stages.py times scan variants and differences them);
    # not a production knob. Recognized: "nb1" (triangulate vs 1 neighbor
    # only), "no_line_tri", "no_fuse", "no_obs_bits", "no_ba", "no_cull",
    # "no_kf" (skip the entire keyframe pipeline).
    ablate: str = ""

    def replace(self, **kw) -> "SLAMConfig":
        return dataclasses.replace(self, **kw)


def icl_nuim_config() -> SLAMConfig:
    """ICL-NUIM living-room config (Examples/ICL.yaml)."""
    return SLAMConfig()


def tum3_config() -> SLAMConfig:
    """TUM freiburg3 config (Examples/TUM3.yaml)."""
    return SLAMConfig(
        camera=CameraConfig(fx=535.4, fy=539.2, cx=320.1, cy=247.6, width=640, height=480)
    )
