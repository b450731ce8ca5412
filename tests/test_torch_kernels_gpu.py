"""The twenty-six CUDA kernels of the PyTorch port against their plain
versions, on the card, at the main path's and the relocalization path's
shapes (640x480 levels, 1024
keypoints, 2048 local points x 1024 features, pose problems of 2048
points + 256 lines, line octaves of 640x480 and 320x240 with 256 / 128
anchors, 64 segments, 8-level keypoint selection at 1024 and 2048
keypoints and the LSD anchor selection, 12 x 2048 null-vector systems,
the [256, 2048] observer grid, local BA with 16 keyframes, 2048 points
and 256 lines; the BoW transform of 24 keyframes x 1024 descriptors and a
[256, 4096] database query, RANSAC PnP over 16 candidates x 256
hypotheses x 1024 points (and 3 x 100 x 1024); on the loop-closing path Sim(3) RANSAC over 128
hypotheses x 1024 pairs, the Sim(3) pair refinement over 1024 pairs, the
pose graph at the 256-keyframe capacity with 60 valid vertices, and local
BA at global BA's 64 keyframes, 16384 points and 1024 lines; the three
compaction passes of kernel 19 on random maps at the default capacities;
kernels 5, 6 and 11 also at line_support_downsample = 2, the support on
the half image, half-pixel anchors and 8 px cells; kernel 5 also on a
75 x 101 frame whose border pixels are NMS peaks; kernels 20 / 21, the 3D
duplicate searches, on pools at the default capacities with seeded
near-copies; kernel 10's eigensolver entry on 24,576 Gram matrices;
kernels 22-24, the fuses' matches, merges and finish and the covisibility
counts, on a synthetic map at the default pools with 2048 features a
keyframe, twice the main path's, so kernel 22 stages two chunks
(fuse_map), and on random merge inputs dense with colliding
writes (merge_problem)).
Marked `gpu`: they skip without a CUDA device. Kernels that share a
fixture or a problem share one test item (each check a function of its
own, each message naming its kernel and case): the suite's item count
sets pytest-xdist's schedule (ROADMAP.md, Tier-1 notes). Run
on the card:

    python -m pytest -o addopts="" -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerances: FAST/NMS maps and every Hamming output exactly equal (integer
arithmetic and bf16 roundings reproduced op for op); ORB descriptors equal
on >= 99.5% of keypoints and angles within 1e-4 rad (float32 moment sums
in another order can move atan2 by an ulp and, rarely, flip the bank);
pose within 1e-4 with inlier masks equal on >= 99.5% (float32 reductions
in another order) and n_inliers equal to the masks' sum. Line kernels:
the dense support pass (score and packed ridge plane) exactly equal (bf16
roundings, glibc's atan2f and integer support counts reproduced op for
op); the refinement's seven outputs bit-equal on every valid anchor (both
sum in sample order; cos / sin equal torch's on the card); LBD words equal on >= 99% of segments with descriptors within
1e-5 (the plain version sums in the kernel's order, so they are expected
equal; the bounds leave room for an ulp in a transcendental); atan2
bit-exact against the torch-op version on the card and on the CPU.
Keypoint selection: `valid` equal, `resp` and `xy` equal on valid slots
(the same float32 ops on the same scores). Observer bits and votes:
equal (integer adds). Null vectors: within 1e-6 (each product and sum
rounds as the plain version's op does; the bound leaves room for an ulp
of atan2f / cosf / sinf). Local BA: poses and landmarks within 1e-3
(the plain version's own bound against JAX; sums over landmarks and the
LU solve run in another order), inlier masks equal on >= 99.5% of
edges, two launches bit-identical, and no host synchronization.
Eigensolver entry: vectors within 1e-6 and values within 1e-6 relative to
max(|v|, 1) (the null vector's arithmetic). Kernels 20 / 21: best and has
equal (every product and sum rounded as the plain versions round them).
Compaction: every field bit-equal, the live counts and `perm` equal. BoW
transform: words and vectors exactly equal (integer histogram, one IEEE
division); query: scores exactly equal (the plain version sums in the
kernel's order). RANSAC PnP: the same chosen hypothesis and count on
every candidate, poses within 1e-4, per-hypothesis counts equal on >= 99%
(the kernel's float64 Jacobi null vector and the plain version's float32
SVD differ in the last bits, which can move a point across the chi2
border), and every hypothesis orthonormal. Sim(3) RANSAC: the same chosen
hypothesis and count, S12 and the scales within 1e-4, counts equal on
>= 99% (float64 Jacobi against float32 eigh, as for PnP). The pair
refinement: S12 within 1e-4, inlier masks equal on >= 99.5% (analytic
against forward-mode Jacobians, sums in another order). The pose graph:
vertices within 1e-4, invalid ones untouched, two launches bit-identical,
no host synchronization. Local BA at 64 keyframes: as at 16, and its 8
invalid slots keep their poses with no inlier point edge. Kernel 22:
idx, dist and valid equal on >= 99.9% of rows (its projections round
each op as the plain version's torch ops on the card are expected to,
but a reduction order or logf can still move a last bit at a gate;
chip_smoke.py prints each differing row with the gate's margin), and
matches found. Kernels 23 and 24: bit-equal (integer work).
"""

import dataclasses

import numpy as np
import pytest
import torch

from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.config import (CameraConfig, FrontendConfig, OptimConfig,
                                                      SLAMConfig)
from structure_slam_pointline_tpu_torch.io import synthetic
from structure_slam_pointline_tpu_torch.models import local_mapping, loop_closing
from structure_slam_pointline_tpu_torch.ops import (bow, extract, fast, hamming, lbd, lsd,
                                                   matching, orb, pnp, pyramid)
from structure_slam_pointline_tpu_torch.optim import local_ba, pose_graph, pose_opt, sim3_solver
from structure_slam_pointline_tpu_torch.utils import fmath, linalg
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics
from structure_slam_pointline_tpu_torch.world import compact, map_store

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    kernels.build_all()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def levels(cuda):
    cam = CameraConfig(fy=480.0)
    scene = synthetic.make_room_scene(350, 40, seed=0)
    pose = synthetic.circular_trajectory(610, radius=0.5)[40]
    img = torch.from_numpy(synthetic.render(scene, pose, cam, noise=2.0, seed=40))
    lv, bl = pyramid.build_blurred_pyramid(img.to(cuda).to(torch.bfloat16))
    return lv, bl


def test_point_frontend_kernels_match_plain(levels, octaves):
    """Kernel 25 (the pyramid and blur) at 640x480, 75 x 101 and on a
    [2, H, W] stack; kernels 1 (FAST + NMS) and 2 (ORB) on every level of
    one bench frame; kernel 11 on the ORB levels at 1024 and 2048
    keypoints, as the LSD anchor selection of both octaves and on
    selection_levels' edge cases."""
    _check_pyramid(octaves[0])
    _check_fast_nms(levels)
    _check_orb(levels)
    for n_kp in (1024, 2048):
        _check_kp_select(levels, n_kp)
    _check_kp_select_lsd_anchors(octaves)
    _check_kp_select_edges(levels[0][0].device)


def _check_pyramid(img):
    """Kernel 25 bit-equal to its plain version on the card: every level
    and blurred plane of a bench frame, of a 75 x 101 frame (the blur's
    halo wraps more than one tile there) and of a [2, H, W] stack, one C
    call and one device kernel (torch.profiler) per call; the one-op forms
    (resize alone, blur alone) on each level."""
    from torch.profiler import ProfilerActivity, profile

    fe = FrontendConfig()
    small = border_frame().to(img.device)
    for frame in (img, small, torch.stack([img, img.flip(1)])):
        x = frame.to(torch.bfloat16)
        pyramid.build_blurred_pyramid(x, fe.n_levels, fe.scale_factor, fe.blur_sigma)
        torch.cuda.synchronize()   # the shapes' weight tables uploaded
        before = kernels.COUNTS["pyramid"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lv_k, bl_k = pyramid.build_blurred_pyramid(x, fe.n_levels, fe.scale_factor,
                                                       fe.blur_sigma)
            torch.cuda.synchronize()
        assert kernels.COUNTS["pyramid"] == before + 1, "pyramid: launch count"
        launched = sum(e.count for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        assert launched == 1, f"pyramid at {tuple(x.shape)}: {launched} device kernels a call"
        lv_p, bl_p = pyramid.build_blurred_pyramid_plain(x, fe.n_levels, fe.scale_factor,
                                                         fe.blur_sigma)
        for lv in range(fe.n_levels):
            at = f"pyramid at {tuple(x.shape)} level {lv}"
            assert torch.equal(lv_k[lv], lv_p[lv]), f"{at}: {int((lv_k[lv] != lv_p[lv]).sum())} px"
            assert torch.equal(bl_k[lv], bl_p[lv]), f"{at} blurred: {int((bl_k[lv] != bl_p[lv]).sum())} px"
            if lv:
                shape = tuple(lv_p[lv].shape[-2:])
                assert torch.equal(pyramid.resize_bilinear(lv_p[lv - 1], shape),
                                   pyramid.resize_bilinear_plain(lv_p[lv - 1], shape)), at
            assert torch.equal(pyramid.blur(lv_p[lv], fe.blur_sigma),
                               pyramid.blur_plain(lv_p[lv], fe.blur_sigma)), at


def _check_fast_nms(levels):
    """Kernel 1 level by level and as the frame's levels entry, bit-equal
    to the plain version; one launch a call."""
    before = kernels.COUNTS["fast_nms"]
    for lv in levels[0]:
        raw_k, nms_k = fast.fast_score_nms(lv)
        raw_p, nms_p = fast.fast_score_nms_plain(lv)
        torch.cuda.synchronize()
        assert torch.equal(raw_k, raw_p)
        assert torch.equal(nms_k, nms_p)
    assert kernels.COUNTS["fast_nms"] == before + len(levels[0])
    before = kernels.COUNTS["fast_nms"]
    maps_k = fast.fast_score_nms_levels(list(levels[0]))
    assert kernels.COUNTS["fast_nms"] == before + 1, "fast_nms_levels: launches a call"
    maps_p = fast.fast_score_nms_levels_plain(list(levels[0]))
    for lv, ((raw_k, nms_k), (raw_p, nms_p)) in enumerate(zip(maps_k, maps_p)):
        assert torch.equal(raw_k, raw_p), f"fast_nms_levels level {lv}: raw"
        assert torch.equal(nms_k, nms_p), f"fast_nms_levels level {lv}: nms"


def _check_orb(levels):
    """Kernel 2 level by level and as the frame's levels entry (300
    keypoints a level): descriptors equal on >= 99.5%, angles within 1e-4,
    xy0 and octaves equal; one launch a call."""
    g = np.random.default_rng(0)
    xys = []
    for bl in levels[1]:
        h, w = bl.shape
        xy = np.stack([g.uniform(16, w - 17, 300), g.uniform(16, h - 17, 300)], 1)
        xy = torch.tensor(xy, dtype=torch.float32, device=bl.device)
        ak, dk = orb.orient_and_describe(bl, xy)
        ap, dp = orb.orient_and_describe_plain(bl, xy)
        torch.cuda.synchronize()
        assert (dk == dp).all(1).float().mean().item() >= 0.995
        assert (ak - ap).abs().max().item() <= 1e-4
        xys.append(xy)
    fe = FrontendConfig()
    scales = [float(s) for s in pyramid.level_scales(fe.n_levels, fe.scale_factor)]
    args = (list(levels[1]), torch.cat(xys), [300] * len(xys), scales, list(range(len(xys))))
    before = kernels.COUNTS["orb_describe"]
    ak, dk, xk, ok = orb.orient_and_describe_levels(*args)
    assert kernels.COUNTS["orb_describe"] == before + 1, "orb_describe_levels: launches a call"
    ap, dp, xp, op = orb.orient_and_describe_levels_plain(*args)
    assert (dk == dp).all(1).float().mean().item() >= 0.995, "orb_describe_levels"
    assert (ak - ap).abs().max().item() <= 1e-4, "orb_describe_levels"
    assert torch.equal(xk, xp) and torch.equal(ok, op), "orb_describe_levels: xy0, octave"


def _descs(g, n):
    return torch.tensor(g.integers(-2 ** 31, 2 ** 31, (n, 8)), dtype=torch.int32)


def test_tracking_kernels_match_plain(cuda):
    """Kernel 3 (Hamming best / second), kernel 22's tracking entries and
    kernel 4 (pose LM)."""
    _check_hamming_best2(cuda)
    _check_track_match(cuda)
    for line_weight in (0.0, 1.0):
        for schedule in ((4, 6), (2, 4)):
            _check_pose_lm(cuda, line_weight, schedule)
    _check_pose_lm(cuda, 0.0, (4, 6), active=0)
    _check_pose_lm(cuda, 1.0, (4, 6), active=9)
    _check_pose_lm(cuda, 0.0, (2, 4), active=9, N=1024, M=1)


def _check_hamming_best2(cuda):
    """Kernel 3 at four [M, N] shapes, then batched ([4, 1024, 1024] and
    one query set against a batch)."""
    for shape in [(2048, 1024), (2048, 2048), (5, 1), (37, 700)]:
        g = np.random.default_rng(shape[0] * 7 + shape[1])
        M, N = shape
        a = _descs(g, M)
        b = _descs(g, N)
        # near-duplicates force ties at the same distance in several columns
        b[N // 2:] = b[: N - N // 2]
        a[: M // 3] = b[torch.from_numpy(g.integers(0, N, M // 3))] ^ 1
        allow = torch.from_numpy(g.uniform(size=(M, N)) < 0.05)
        allow[:3] = False        # rows without candidates
        out_k = hamming.masked_best2(a.to(cuda), b.to(cuda), allow.to(cuda))
        out_p = hamming.masked_best2_plain(a, b, allow)
        for i, (x, y) in enumerate(zip(out_k, out_p)):
            assert torch.equal(x.cpu(), y), f"hamming_best2 at {shape}: output {i}"
    g = np.random.default_rng(3)
    a = torch.stack([_descs(g, 1024) for _ in range(4)])
    b = torch.stack([_descs(g, 1024) for _ in range(4)])
    allow = torch.from_numpy(g.uniform(size=(4, 1024, 1024)) < 0.1)
    for aa in (a, a[0]):
        out_k = hamming.masked_best2(aa.to(cuda), b.to(cuda), allow.to(cuda))
        out_p = hamming.masked_best2_plain(aa, b, allow)
        for i, (x, y) in enumerate(zip(out_k, out_p)):
            assert torch.equal(x.cpu(), y), f"hamming_best2 batched {tuple(aa.shape)}: output {i}"


def track_frame(st, k, seed=43):
    """The tracking Frame of keyframe k of a fuse_map (its features, lines
    and seeded keypoint angles) and the map with seeded landmark angles:
    the rotation deltas of true matches crowd one bin."""
    from structure_slam_pointline_tpu_torch.models.tracking import Frame

    g = np.random.default_rng(seed)
    dev = st.mp_valid.device
    P, F, LF = st.mp_valid.shape[0], st.kf_xy.shape[1], st.kf_line_ep.shape[1]
    f32 = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)  # noqa: E731
    ang = f32(g.uniform(-np.pi, np.pi, P))
    ids = st.kf_kp_mp[k].clamp(0, P - 1).long()
    kp_ang = torch.where(st.kf_kp_mp[k] >= 0, ang[ids] - 0.2 + f32(g.normal(0, 0.05, F)),
                         f32(g.uniform(-np.pi, np.pi, F)))
    fr = Frame(xy=st.kf_xy[k], desc=st.kf_desc[k], octave=st.kf_octave[k], angle=kp_ang,
               kp_valid=st.kf_kp_valid[k], line2d=torch.zeros((LF, 3), device=dev),
               line_ep=st.kf_line_ep[k], ldesc=st.kf_ldesc[k],
               loctave=torch.zeros(LF, dtype=torch.int32, device=dev),
               line_valid=st.kf_line_valid[k])
    return st._replace(mp_angle=ang), fr


def _check_track_match(cuda):
    """Kernel 22's tracking entries on fuse_map seen from keyframe 6's
    frame: pass 1's and pass 2's settings, the local sets the most recent
    2048 landmarks and 256 lines (and the same with a quarter of the ids
    -1), an empty local set, and every row invisible (the pose moved
    behind the map); idx, dist, valid and visible equal."""
    st, cfg, intr = fuse_map()
    st, fr = track_frame(st, 6)
    st, fr = _to_state(st, cuda), type(fr)(*[t.to(cuda) for t in fr])
    T = st.kf_T_cw[6].clone()
    pts = torch.arange(2048, dtype=torch.int32, device=cuda)
    lns = torch.arange(256, dtype=torch.int32, device=cuda)
    holes = lambda ids: torch.where(ids % 4 == 1, -1, ids)  # noqa: E731
    behind = T.clone()
    behind[2, 3] -= 100.0
    m = cfg.matching
    cases = [("pass 1", T, pts, lns, 15.0, True, m.nn_ratio_tracking, 30.0, 100, 5),
             ("pass 2", T, pts, lns, 4.0, False, m.nn_ratio_localmap, 15.0, 100, 5),
             ("pass 1 with holes", T, holes(pts), holes(lns), 15.0, True,
              m.nn_ratio_tracking, 30.0, 50, 3),
             ("empty local set", T, torch.full_like(pts, -1), torch.full_like(lns, -1), 15.0,
              True, m.nn_ratio_tracking, 30.0, 0, 0),
             ("all rows invisible", behind, pts, lns, 15.0, True, m.nn_ratio_tracking, 30.0,
              0, 0)]
    for what, T_, p_ids, l_ids, rs, rot, ratio, lr, least, least_l in cases:
        for name, fn, plain, args, n_min in (
                ("track_match_points", matching.track_match_points,
                 matching.track_match_points_plain, (p_ids, intr, cfg, rs, rot, ratio), least),
                ("track_match_lines", matching.track_match_lines,
                 matching.track_match_lines_plain, (l_ids, intr, cfg, lr), least_l)):
            before = kernels.COUNTS[name]
            mk, vk = fn(st, fr, T_, *args)
            assert kernels.COUNTS[name] == before + 1, f"{name}: launch count"
            mp, vp = plain(st, fr, T_, *args)
            assert torch.equal(vk, vp), f"{name} {what}: visible differs on {int((vk != vp).sum())} rows"
            _match_equal(f"{name} {what}", mk, mp, n_min)
            if n_min == 0:
                assert not mp.valid.any() and not vp.any(), f"{name} {what}: rows visible"


def pose_problem(line_weight, N=2048, M=256, active=None, keep=None):
    """Kernel 4's seeded problem: N points (the first tenth outliers) and M
    lines (masked out at line weight 0) seen from a pose 6 cm off; `active`
    keeps that many masked edges (0: none; 9: eight inliers and one outlier,
    so every gated round falls under the floor of 10 and takes the
    fallback); `keep` keeps a seeded random `keep` of the masked points (the
    main path masks ~150 of its 2048 rows). The line endpoints are column
    slices of one [M, 6] array, as the tracking passes them. Returns (args,
    intr)."""
    g = np.random.default_rng(int(line_weight) + 11)
    intr = Intrinsics.from_config(CameraConfig(fy=480.0))
    pts = np.stack([g.uniform(-3, 3, N), g.uniform(-2, 2, N), g.uniform(4, 9, N)], 1)
    sw = np.stack([g.uniform(-3, 3, M), g.uniform(-2, 2, M), g.uniform(4, 9, M)], 1)
    ew = sw + g.normal(0, 0.5, (M, 3))

    def proj(X):
        return np.stack([intr.fx * X[:, 0] / X[:, 2] + intr.cx,
                         intr.fy * X[:, 1] / X[:, 2] + intr.cy], 1)

    obs = proj(pts) + g.normal(0, 0.7, (N, 2))
    obs[: N // 10] += g.uniform(-30, 30, (N // 10, 2))   # outliers
    us, ue = proj(sw), proj(ew)
    l = np.cross(np.c_[us, np.ones(M)], np.c_[ue, np.ones(M)])
    l /= np.hypot(l[:, 0], l[:, 1])[:, None]
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, 3] = [0.03, -0.02, 0.05]
    pt_mask = g.uniform(size=N) < 0.8
    ln_mask = g.uniform(size=M) < (0.8 if line_weight else 0.0)
    if active is not None:
        keep = np.zeros(N, bool)
        keep[N // 10: N // 10 + max(active - 1, 0)] = True
        keep[0] = active > 0
        pt_mask, ln_mask = keep, np.zeros(M, bool)
    elif keep is not None:
        pt_mask[np.random.default_rng(keep).permutation(np.flatnonzero(pt_mask))[keep:]] = False
    f = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    eps = f(np.concatenate([sw, ew], 1))
    args = [f(T0), f(pts), f(obs), torch.from_numpy(pt_mask),
            f(1.2 ** (2 * g.integers(0, 8, N))), eps[:, :3], eps[:, 3:], f(l),
            torch.from_numpy(ln_mask), f(np.full(M, 1.0 / max(line_weight, 1e-9)))]
    return args, intr


def pose_to(args, dev):
    """`pose_problem`'s args on `dev`, the endpoints still slices of one array."""
    eps = torch.cat([args[5], args[6]], 1).to(dev)
    out = [a.to(dev) for a in args]
    out[5:7] = eps[:, :3], eps[:, 3:]
    return out


def _check_pose_lm(cuda, line_weight, schedule, active=None, N=2048, M=256):
    """Kernel 4 with line weight 0 (the main path) and 1 (line rows on), at
    the tracking's two schedules (rounds x iterations: pass 1's 2 x 4, pass
    2's 4 x 6), on `pose_problem`'s inputs; N 1024 with one masked-out line
    is the relocalization's shape. n_inliers must equal the two masks'
    sum."""
    args, intr = pose_problem(line_weight, N, M, active)
    cfg = dataclasses.replace(OptimConfig(), pose_rounds=schedule[0], pose_iters=schedule[1])
    what = f"pose_lm (line weight {line_weight}, {schedule}, {N} x {M}, active {active})"
    rp = pose_opt.pose_optimize_plain(*args, intr, cfg)
    args_k = pose_to(args, cuda)
    before = kernels.COUNTS["pose_lm"]
    rk = pose_opt.pose_optimize(*args_k, intr, cfg)
    assert kernels.COUNTS["pose_lm"] == before + 1, f"{what}: launch count"
    err = (rk.T_cw.cpu() - rp.T_cw).abs().max().item()
    assert err <= 1e-4, f"{what}: pose err {err}"
    same = torch.cat([rk.point_inliers.cpu() == rp.point_inliers,
                      rk.line_inliers.cpu() == rp.line_inliers]).float().mean().item()
    assert same >= 0.995, f"{what}: inliers equal {same}"
    n_masks = int(rk.point_inliers.sum()) + int(rk.line_inliers.sum())
    assert rk.n_inliers.dtype == torch.int32 and int(rk.n_inliers) == n_masks, \
        f"{what}: n_inliers {int(rk.n_inliers)}, masks {n_masks}"
    if active == 0:
        assert n_masks == 0 and torch.equal(rk.T_cw.cpu(), args[0]), f"{what}: moved"
    if active:
        assert not (rk.point_inliers.cpu() & ~args[3]).any(), f"{what}: unmasked inlier"


@pytest.fixture(scope="module")
def octaves(cuda):
    cam = CameraConfig(fy=480.0)
    scene = synthetic.make_room_scene(350, 40, seed=0)
    pose = synthetic.circular_trajectory(610, radius=0.5)[40]
    img = torch.from_numpy(synthetic.render(scene, pose, cam, noise=2.0, seed=40)).to(cuda)
    return [img, lsd.half_octave(img).contiguous()]


def test_line_kernels_match_plain(octaves):
    """Kernels 5 (LSD dense support), 6 (LSD refinement), 26 (the merges)
    and 7 (LBD) on both octaves of one bench frame; kernel 26 also on a
    chain of collinear fragments; kernel 8 (atan2)."""
    _check_lsd_support(octaves)
    _check_lsd_refine(octaves)
    _check_lsd_merge(octaves)
    _check_lbd(octaves)
    _check_atan2(octaves[0].device)


def border_frame(H=75, W=101, seed=5):
    """A frame whose border pixels are NMS peaks with support: a vertical
    step at W / 2 (and, wrapped, between columns W - 1 and 0), a
    horizontal one at H / 3 (and between rows H - 1 and 0), a slanted bar,
    noise; its shape a multiple of no tile side, H odd."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    img = np.where(xx < W // 2, 200.0, 40.0) + np.where(yy < H // 3, 60.0, 0.0)
    img += np.where(np.abs((xx - 20) - 0.6 * (yy - 10)) < 2.0, 80.0, 0.0)
    img += g.normal(0, 2.0, (H, W))
    return torch.from_numpy(img.astype(np.float32))


def _check_lsd_support(octaves):
    fe = FrontendConfig()
    before = kernels.COUNTS["lsd_support"]
    frames = octaves + [border_frame().to(octaves[0].device)]
    for ds in (1, 2):
        for img in frames:
            args = (fe.line_grad_threshold, fe.line_angle_tol, fe.line_min_length, ds)
            best_k, packed_k = lsd.lsd_support(img, *args)
            best_p, packed_p = lsd.lsd_support_plain(img, *args)
            torch.cuda.synchronize()
            at = f"at {tuple(img.shape)}, ds {ds}"
            assert best_k.shape == (img.shape[0] // ds, img.shape[1] // ds), at
            assert torch.equal(best_k, best_p), f"lsd_support score {at}"
            assert torch.equal(packed_k, packed_p), f"lsd_support plane {at}"
            assert (best_k > 0).sum().item() > 100 // ds ** 2, f"lsd_support: few scores {at}"
        edge = torch.cat([best_p[0], best_p[-1], best_p[:, 0], best_p[:, -1]])
        assert (edge > 0).sum().item() >= 20, f"lsd_support: few border peaks at ds {ds}"
    assert kernels.COUNTS["lsd_support"] == before + 2 * len(frames), "lsd_support: launch count"


def _anchors(img, K, ds):
    """detect_lines' anchors at line_support_downsample = ds: the support
    score's selection (8 px cells at ds = 2), at full-resolution (for ds =
    2 half-pixel) coordinates; (ax, ay, valid, packed ridge plane)."""
    fe = FrontendConfig()
    best, packed = lsd.lsd_support_plain(img, fe.line_grad_threshold, fe.line_angle_tol,
                                         fe.line_min_length, ds)
    axy, _, avalid = fast.select_keypoints(best, k=K, cell=16 // ds, cell_cap=1,
                                           threshold=1.0, min_threshold=1.0, border=4 // ds)
    axy = axy * ds + 0.5 * (ds - 1)
    return axy[:, 0].contiguous(), axy[:, 1].contiguous(), avalid, packed


def _check_lsd_refine(octaves):
    """Kernel 6 on both octaves' anchors at ds 1 and 2, then on the first
    anchor alone and on the first 13 (a block takes 8): every valid
    anchor's output bit-equal to the plain version's."""
    fe = FrontendConfig()
    for ds in (1, 2):
        for img, K, S in zip(octaves, (256, 128), (48, 24)):
            ax, ay, avalid, packed = _anchors(img, K, ds)
            args = (S, fe.line_refine_iters, fe.line_angle_tol, fe.line_grad_threshold)
            at = f"at {tuple(img.shape)}, ds {ds}"
            assert avalid.sum().item() > 50 // ds, f"lsd_refine: too few valid anchors {at}"
            for n in (K, 1, 13):
                before = kernels.COUNTS["lsd_refine"]
                out_k = lsd.lsd_refine(img, packed, ax[:n], ay[:n], *args)
                assert kernels.COUNTS["lsd_refine"] == before + 1, f"lsd_refine {at}: launches"
                out_p = lsd.lsd_refine_plain(img, packed, ax[:n], ay[:n], *args)
                v = avalid[:n]
                diff = (out_k[v] != out_p[v]).any(1)
                assert not diff.any(), (
                    f"lsd_refine {at}, K {n}: {int(diff.sum())} of {int(v.sum())} valid anchors "
                    f"differ, max {(out_k[v] - out_p[v]).abs().max().item()}")


def _lines_equal(what, out_k, out_p):
    """Kernel 26 against its plain version: valid and octave bit-equal,
    endpoints, response and angle bit-equal on valid slots, line
    coefficients within 1e-5 (torch.linalg.cross's product order)."""
    assert torch.equal(out_k.valid, out_p.valid), f"{what}: valid"
    assert torch.equal(out_k.octave, out_p.octave), f"{what}: octave"
    v = out_p.valid
    for f in ("endpoints", "response", "angle"):
        a, b = getattr(out_k, f)[v], getattr(out_p, f)[v]
        assert torch.equal(a, b), f"{what}: {f} differs by {(a - b).abs().max().item()}"
    err = (out_k.line2d[v] - out_p.line2d[v]).abs().max().item() if v.any() else 0.0
    assert err <= 1e-5, f"{what}: line2d err {err}"


def collinear_chain(K=256, n=40, seed=3):
    """Refined segments [K, 7] and anchor flags: a chain of n collinear
    fragments 25 px long, 3 px apart (each links only to its neighbours,
    so the chain is longer than the 16 hops of four squarings), a second
    chain at another angle, scattered segments, a few failing anchors."""
    g = np.random.default_rng(seed)
    ref = np.zeros((K, 7), np.float32)
    d = np.array([np.cos(0.3), np.sin(0.3)])
    for i in range(n):
        s = np.array([20.0, 30.0]) + d * 28.0 * i
        ref[i, :4] = [*s, *(s + 25.0 * d)]
    d2 = np.array([np.cos(-1.1), np.sin(-1.1)])
    for i in range(20):
        s = np.array([100.0, 400.0]) + d2 * 28.0 * i
        ref[n + i, :4] = [*s, *(s + 25.0 * d2)]
    m = K - n - 20
    a = g.uniform(0, np.pi, m)
    c = g.uniform([20, 20], [620, 460], (m, 2))
    ln = g.uniform(10, 60, m)
    half = 0.5 * ln[:, None] * np.stack([np.cos(a), np.sin(a)], 1)
    ref[n + 20:, :4] = np.concatenate([c - half, c + half], 1)
    ref[:, 4] = np.hypot(ref[:, 2] - ref[:, 0], ref[:, 3] - ref[:, 1])
    ref[:, 5] = g.uniform(5, 40, K)
    ref[:, 6] = ref[:, 4] * ref[:, 5]
    valid = g.uniform(size=K) < 0.95
    return torch.from_numpy(ref), torch.from_numpy(valid)


def dense_lines(K=256, n=60, seed=5):
    """Refined segments [K, 7] and anchor flags: n overlapping fragments,
    25-40 px long and 4 px apart, on each of two long lines (within 0.6 px
    and 0.02 rad of it), so each links to ~15 others directly and its
    component holds all n (rows of ~n set bits after the squarings), the
    rest scattered; a few failing anchors."""
    g = np.random.default_rng(seed)
    ref = np.zeros((K, 7), np.float32)
    for c, (o, a) in enumerate((((30.0, 60.0), 0.25), ((500.0, 40.0), 1.9))):
        for i in range(n):
            d = a + g.uniform(-0.02, 0.02)
            u = np.array([np.cos(d), np.sin(d)])
            s = np.array(o) + np.array([np.cos(a), np.sin(a)]) * 4.0 * i \
                + np.array([-np.sin(a), np.cos(a)]) * g.uniform(-0.6, 0.6)
            ref[c * n + i, :4] = [*s, *(s + g.uniform(25.0, 40.0) * u)]
    m = K - 2 * n
    a = g.uniform(0, np.pi, m)
    c = g.uniform([20, 20], [620, 460], (m, 2))
    ln = g.uniform(10, 60, m)
    half = 0.5 * ln[:, None] * np.stack([np.cos(a), np.sin(a)], 1)
    ref[2 * n:, :4] = np.concatenate([c - half, c + half], 1)
    ref[:, 4] = np.hypot(ref[:, 2] - ref[:, 0], ref[:, 3] - ref[:, 1])
    ref[:, 5] = g.uniform(5, 40, K)
    ref[:, 6] = ref[:, 4] * ref[:, 5]
    valid = g.uniform(size=K) < 0.97
    return torch.from_numpy(ref), torch.from_numpy(valid)


def _check_lsd_merge(octaves):
    """Kernel 26's lsd_merge on both octaves' refined anchors (octave 0
    also at L = K), on collinear_chain (at K = 256 and at K = 200, not a
    multiple of 32) and on dense_lines (rows of ~60 set bits); its
    lsd_octave_merge on the two octaves' lines."""
    fe = FrontendConfig()
    dev = octaves[0].device
    cases = []
    for img, K, S in zip(octaves, (256, 128), (48, 24)):
        ax, ay, avalid, packed = _anchors(img, K, 1)
        cases.append((f"octave {tuple(img.shape)}", lsd.lsd_refine_plain(
            img, packed, ax, ay, S, fe.line_refine_iters, fe.line_angle_tol,
            fe.line_grad_threshold), avalid, fe.n_lines))
    ref, valid = collinear_chain()
    cases.append(("collinear chain", ref.to(dev), valid.to(dev), fe.n_lines))
    cases.append(("octave 0, L = K", cases[0][1], cases[0][2], 256))
    ref, valid = collinear_chain(K=200)
    cases.append(("collinear chain, K = 200", ref.to(dev), valid.to(dev), fe.n_lines))
    ref, valid = dense_lines()
    cases.append(("dense links", ref.to(dev), valid.to(dev), fe.n_lines))
    outs = []
    for what, ref, avalid, L in cases:
        before = kernels.COUNTS["lsd_merge"]
        args = (ref, avalid, L, fe.line_min_length, fe.line_angle_tol)
        out_k = lsd.lsd_merge(*args)
        assert kernels.COUNTS["lsd_merge"] == before + 1, "lsd_merge: launch count"
        out_p = lsd.lsd_merge_plain(*args)
        _lines_equal(f"lsd_merge {what}", out_k, out_p)
        assert out_p.valid.sum().item() >= 8, f"lsd_merge {what}: too few lines"
        outs.append(out_p)
    for c, limit in ((2, 400.0), (4, 400.0), (5, 200.0)):
        longest = (outs[c].endpoints[:, 2:] - outs[c].endpoints[:, :2]).norm(dim=1).max().item()
        assert longest > limit, f"lsd_merge {cases[c][0]}: merged to {longest} px only"
    out_k = lsd.lsd_octave_merge(outs[0], outs[1], fe.line_angle_tol)
    out_p = lsd.lsd_octave_merge_plain(outs[0], outs[1], fe.line_angle_tol)
    _lines_equal("lsd_octave_merge", out_k, out_p)
    assert (out_p.octave[out_p.valid] == 1).any(), "lsd_octave_merge: no octave-1 line kept"


def _check_lbd(octaves):
    img = octaves[0]
    lines = lsd.detect_lines_pyramid(img, FrontendConfig())
    assert lines.valid.sum().item() >= 32, "lbd_describe: too few segments"
    wk, dk = lbd.describe_lines(img, lines.endpoints.contiguous(), lines.valid)
    wp, dp = lbd.describe_lines_plain(img, lines.endpoints, lines.valid)
    same = (wk == wp).all(1).float().mean().item()
    err = (dk - dp).abs().max().item()
    assert same >= 0.99 and err <= 1e-5, f"lbd_describe: words equal {same}, err {err}"


def _check_atan2(cuda):
    g = np.random.default_rng(9)
    y = (g.normal(size=20000) * np.exp(g.normal(size=20000) * 3)).astype(np.float32)
    x = (g.normal(size=20000) * np.exp(g.normal(size=20000) * 3)).astype(np.float32)
    y[:40], x[40:80], x[80:120], y[120:130] = 0.0, 0.0, 1.0, -0.0
    y, x = torch.from_numpy(y), torch.from_numpy(x)
    before = kernels.COUNTS["atan2_glibc"]
    out_k = fmath.atan2(y.to(cuda), x.to(cuda))
    out_p = fmath.atan2_plain(y.to(cuda), x.to(cuda))
    assert kernels.COUNTS["atan2_glibc"] == before + 1
    bits = out_k.cpu().view(torch.int32)
    assert torch.equal(bits, out_p.cpu().view(torch.int32))
    assert torch.equal(bits, fmath.atan2_plain(y, x).view(torch.int32))


def _assert_selection_equal(out_k, out_p, what):
    for lv, ((xk, rk, vk), (xp, rp, vp)) in enumerate(zip(out_k, out_p)):
        assert torch.equal(vk, vp), f"kp_select {what} level {lv}: valid"
        assert torch.equal(rk[vk], rp[vp]), f"kp_select {what} level {lv}: resp"
        assert torch.equal(xk[vk], xp[vp]), f"kp_select {what} level {lv}: xy"


def _check_kp_select(levels, n_kp):
    fe = FrontendConfig()
    ks = extract.level_budgets(n_kp, fe.n_levels, fe.scale_factor)
    score_raw = []
    for lv in levels[0]:
        raw, nms = fast.fast_score_nms(lv)
        score_raw.append((nms, raw))
    kw = dict(cell=fe.cell_size, cell_cap=8, threshold=fe.fast_threshold,
              min_threshold=fe.fast_min_threshold, border=orb.PATCH_RADIUS + 1)
    before = kernels.COUNTS["kp_select"]
    out_k = fast.select_keypoints_levels(score_raw, ks, **kw)
    out_p = fast.select_keypoints_levels_plain(score_raw, ks, **kw)
    torch.cuda.synchronize()
    assert kernels.COUNTS["kp_select"] == before + 1, "kp_select: launch count"
    assert sum(int(v.sum()) for _, _, v in out_k) > n_kp // 2, "kp_select: too few keypoints"
    _assert_selection_equal(out_k, out_p, f"ORB {n_kp}")


def selection_levels(seed=31):
    """Score and raw maps for kernel 11's edge cases, one level each:
    (a) 128 x 160 at 32 px cells, cap 8 (160 candidates): 10 scores of 80
    and 60 of exactly 50 spread over the 20 cells, so a budget of 30 takes
    the 20 tied ones of the lowest flat index (cell-major, then rank in the
    cell); (b) 96 x 96, 9 cells x 8 = 72 candidates, 27 of them scored (3
    a cell), under a budget of 100; (c) 64 x 96 with every score under the
    floor;
    (d) 120 x 200 of random scores. Returns [(nms, raw)] and the budgets."""
    g = np.random.default_rng(seed)
    a = np.zeros((128, 160), np.float32)
    ys, xs = np.mgrid[8:120:9, 8:152:13]
    spots = np.stack([ys.ravel(), xs.ravel()], 1)
    g.shuffle(spots)
    a[spots[:10, 0], spots[:10, 1]] = 80.0
    a[spots[10:70, 0], spots[10:70, 1]] = 50.0
    b = np.zeros((96, 96), np.float32)
    yb, xb = np.mgrid[0:96:32, 0:96:32]
    for dy, dx in ((6, 9), (17, 25), (26, 14)):
        b[yb + dy, xb + dx] = g.uniform(8.0, 60.0, yb.shape)
    c = g.uniform(0.0, 6.9, (64, 96)).astype(np.float32)
    d = (g.uniform(size=(120, 200)) < 0.2) * g.uniform(0.0, 90.0, (120, 200))
    maps = [a, b, c, d.astype(np.float32)]
    return ([(torch.from_numpy(m), torch.from_numpy(g.uniform(0.0, 90.0, m.shape)
                                                    .astype(np.float32))) for m in maps],
            [30, 100, 12, 40])


def _check_kp_select_edges(cuda):
    """Kernel 11 against its plain version on every slot (xy, resp, valid
    bit-equal, the invalid ones too) on selection_levels: ties straddling
    the k-th place across cells, a level with fewer candidates than its
    budget, a level all below the floor; at 32 px cells with cap 8, then
    at 8 px cells with cap 1 (phase 2f's shape), with and without raw
    maps; one launch a call."""
    score_raw, ks = selection_levels()
    pairs = [(s.to(cuda), r.to(cuda)) for s, r in score_raw]
    for cell, cap in ((32, 8), (8, 1)):
        for raw in (True, False):
            sr = [(s, r if raw else None) for s, r in pairs]
            kw = dict(cell=cell, cell_cap=cap, threshold=20.0, min_threshold=7.0, border=4)
            before = kernels.COUNTS["kp_select"]
            out_k = fast.select_keypoints_levels(sr, ks, **kw)
            assert kernels.COUNTS["kp_select"] == before + 1, "kp_select: launch count"
            out_p = fast.select_keypoints_levels_plain(sr, ks, **kw)
            for lv, (ok_, op) in enumerate(zip(out_k, out_p)):
                for name, x, y in zip(("xy", "resp", "valid"), ok_, op):
                    assert torch.equal(x, y), f"kp_select edges cell {cell} cap {cap} raw " \
                                              f"{raw} level {lv}: {name}"
            valid = [int(v.sum()) for _, _, v in out_p]
            if cap == 8:
                assert valid[0] == 30 and valid[1] == 27 and valid[2] == 0, valid
                assert (out_p[0][1] == 50.0).sum().item() == 20, "kp_select: the ties"


def _check_kp_select_lsd_anchors(octaves):
    fe = FrontendConfig()
    for ds in (1, 2):
        for img, K in zip(octaves, (256, 128)):
            best, _ = lsd.lsd_support_plain(img, fe.line_grad_threshold, fe.line_angle_tol,
                                            fe.line_min_length, ds)
            kw = dict(cell=16 // ds, cell_cap=1, threshold=1.0, min_threshold=1.0,
                      border=4 // ds)
            out_k = fast.select_keypoints(best, K, **kw)
            out_p = fast.select_keypoints_levels_plain([(best, None)], [K], **kw)[0]
            assert out_k[2].sum().item() > 50 // ds, "kp_select: too few anchors"
            _assert_selection_equal([out_k], [out_p],
                                    f"LSD anchors {tuple(img.shape)}, ds {ds}")


def _obs_grid(g, K=256, F=2048, P=32768):
    grid = g.integers(-1, P, (K, F)).astype(np.int32)
    grid[g.uniform(size=(K, F)) < 0.5] = -1
    grid[3, :40] = grid[3, 40:80]           # duplicated (keyframe, landmark) pairs
    return torch.from_numpy(grid)


def _check_obs_bits_and_votes(cuda):
    g = np.random.default_rng(5)
    kf = _obs_grid(g)
    K, P = kf.shape[0], 32768
    st = map_store.init_map(SLAMConfig(), "cpu")
    st = st._replace(kf_kp_mp=kf)
    st_c = st._replace(kf_kp_mp=kf.to(cuda), mp_valid=st.mp_valid.to(cuda))
    bits_k = map_store.compute_obs_bits(st_c)
    assert torch.equal(bits_k.cpu(), map_store.compute_obs_bits_plain(st))
    rows = bits_k[torch.from_numpy(g.integers(0, P, 2048)).to(cuda)]
    matched = torch.from_numpy(g.uniform(size=2048) < 0.5).to(cuda)
    kf_valid = torch.from_numpy(g.uniform(size=K) < 0.7).to(cuda)
    v_k = map_store.votes_from_bits(rows, matched, kf_valid)
    v_p = map_store.votes_from_bits_plain(rows, matched, kf_valid)
    assert torch.equal(v_k, v_p)
    assert v_k.sum().item() > 0


def fuse_map(seed=37, n_kf=12, n_pts=6000, n_lines=300):
    """A map at the default capacities (256 keyframes x 2048 features, 64
    lines, 32768 points, 2048 lines) seen by n_kf keyframes on an arc:
    each keyframe's features are the projections of the landmarks in its
    view (0.7 px noise, octaves 0-3, descriptors 4 bits from their
    landmark's), 60% bound to their landmark, 10% to a duplicate slot of
    it (so the fuse merges), the rest unbound (so it adds); map lines
    likewise. Returns (MapState on the CPU, config, intrinsics)."""
    cfg = SLAMConfig(camera=CameraConfig(fy=480.0), frontend=FrontendConfig(n_lines=64))
    intr = Intrinsics.from_config(cfg.camera)
    st = map_store.init_map(cfg, "cpu", n_features=2048)
    K, F = st.kf_kp_mp.shape
    LF = st.kf_line_ml.shape[1]
    P, L = st.mp_valid.shape[0], st.ml_valid.shape[0]
    g = np.random.default_rng(seed)
    f = {k: v.numpy().copy() for k, v in st._asdict().items()}
    X = g.uniform([-3, -2, 3], [3, 2, 7], (n_pts, 3)).astype(np.float32)
    dup = n_pts + np.arange(n_pts // 4)            # duplicate slots of the first quarter
    f["mp_xyz"][:n_pts], f["mp_xyz"][dup] = X, X[: len(dup)]
    desc = g.integers(-2 ** 31, 2 ** 31, (n_pts, 8), dtype=np.int64).astype(np.int32)
    f["mp_desc"][:n_pts], f["mp_desc"][dup] = desc, desc[: len(dup)]
    f["mp_valid"][: dup[-1] + 1] = True
    d = np.linalg.norm(X, axis=1)
    f["mp_dist_min"][:n_pts], f["mp_dist_max"][:n_pts] = 0.5 * d, 1.15 * d
    f["mp_normal"][:n_pts] = X / d[:, None]
    E = np.concatenate([X[:n_lines], X[:n_lines] + g.normal(size=(n_lines, 3)) * 0.4], 1)
    f["ml_endpoints"][:n_lines] = E
    ldesc = g.integers(-2 ** 31, 2 ** 31, (n_lines, 8), dtype=np.int64).astype(np.int32)
    f["ml_desc"][:n_lines] = ldesc
    f["ml_valid"][:n_lines] = True

    def proj(T, P3):
        pc = P3 @ T[:3, :3].T + T[:3, 3]
        return pc[:, :2] / pc[:, 2:3] * [intr.fx, intr.fy] + [intr.cx, intr.cy], pc[:, 2]

    def flips(n, bits=4):
        w = np.zeros((n, 8), np.int64)
        for _ in range(bits):
            b = g.integers(0, 256, n)
            w[np.arange(n), b // 32] ^= 1 << (b % 32)
        return w.astype(np.uint32).view(np.int32)

    for k in range(n_kf):
        a = 0.08 * (k - n_kf / 2)
        R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, [0.3 * np.sin(a), 0.0, 0.1 * k]
        f["kf_T_cw"][k], f["kf_valid"][k] = T, True
        uv, z = proj(T, X)
        seen = np.nonzero((z > 0.5) & (uv[:, 0] > 4) & (uv[:, 0] < 636) & (uv[:, 1] > 4)
                          & (uv[:, 1] < 476))[0][:F]
        n = len(seen)
        f["kf_xy"][k, :n] = uv[seen] + g.normal(size=(n, 2)) * 0.7
        f["kf_octave"][k, :n] = g.choice(4, n, p=[0.5, 0.25, 0.15, 0.1])
        f["kf_desc"][k, :n] = desc[seen] ^ flips(n)
        f["kf_kp_valid"][k, :n] = True
        r = g.uniform(size=n)
        bind = np.where(r < 0.6, seen, -1)
        two = (r >= 0.6) & (r < 0.7) & (seen < len(dup))
        bind[two] = dup[seen[two]]
        f["kf_kp_mp"][k, :n] = bind
        uvs, zs = proj(T, E[:, :3])
        uve, ze = proj(T, E[:, 3:])
        lseen = np.nonzero((zs > 0.5) & (ze > 0.5) & (np.abs(uvs - [320, 240]).max(1) < 300)
                           & (np.abs(uve - [320, 240]).max(1) < 300))[0][:LF]
        m = len(lseen)
        f["kf_line_ep"][k, :m] = np.concatenate([uvs[lseen], uve[lseen]], 1) \
            + g.normal(size=(m, 4)) * 0.5
        f["kf_ldesc"][k, :m] = ldesc[lseen] ^ flips(m)
        f["kf_line_valid"][k, :m] = True
        f["kf_line_ml"][k, :m] = np.where(g.uniform(size=m) < 0.7, lseen, -1)
    return map_store.MapState(**{k: torch.from_numpy(v) for k, v in f.items()}), cfg, intr


def _to_state(st, dev):
    return st._replace(**{k: v.to(dev) for k, v in st._asdict().items()})


def _match_equal(name, out_k, out_p, min_valid):
    """Kernel 22 against its plain version: idx, dist and valid equal on
    every row (the kernel sums in PyTorch's order, so no gate flips on
    these inputs; chip_smoke.py prints any row that differs on the main
    path with its margin), and matches found."""
    for what in ("idx", "dist", "valid"):
        a, b = getattr(out_k, what), getattr(out_p, what)
        assert torch.equal(a, b), f"{name}: {what} differs on {int((a != b).sum())} rows"
    assert out_p.valid.sum().item() >= min_valid, f"{name}: {int(out_p.valid.sum())} matches"


def _check_fuse_match(cuda):
    """Kernel 22's four entries on fuse_map: the fuse directions of the
    newest keyframe and its four neighbours (points and lines), the loop
    pool through eight keyframes (B = 8) and one (B = 1, radius 10), the
    Sim(3) widening between two keyframes."""
    st, cfg, intr = fuse_map()
    stc = _to_state(st, cuda)
    nb = torch.tensor([10, 9, 8, 7], device=cuda)
    a, b, pres = local_mapping._fuse_directions(stc, 11, nb)
    for name, fn, plain, least in (
            ("fuse_match_points", local_mapping.fuse_match_points,
             local_mapping.fuse_match_points_plain, 2000),
            ("fuse_match_lines", local_mapping.fuse_match_lines,
             local_mapping.fuse_match_lines_plain, 50)):
        before = kernels.COUNTS[name]
        out_k = fn(stc, a, b, pres, intr, cfg)
        assert kernels.COUNTS[name] == before + 1, f"{name}: launch count"
        _match_equal(name, out_k, plain(stc, a, b, pres, intr, cfg), least)
    pool = loop_closing._loop_pool(stc, torch.tensor([0, 1, 2, 3, -1, -1, -1, -1],
                                                     dtype=torch.int32, device=cuda))
    rows = torch.arange(4, 12, device=cuda)
    for kf, M, radius in ((rows, stc.kf_T_cw[rows], 4.0), (5, stc.kf_T_cw[5], 10.0)):
        before = kernels.COUNTS["pool_match"]
        mk = loop_closing._project_pool_matches(stc, kf, M, pool, intr, radius, 50)
        mp = loop_closing._project_pool_matches_plain(stc, kf, M, pool, intr, radius, 50)
        assert kernels.COUNTS["pool_match"] == before + 1, "pool_match: launch count"
        _match_equal("pool_match", mk, mp, 500)
    S12 = stc.kf_T_cw[9] @ torch.linalg.inv(stc.kf_T_cw[4])
    before = kernels.COUNTS["sim3_widen_match"]
    mk = loop_closing._sim3_widen_matches(stc, 9, 4, S12, intr, 100)
    assert kernels.COUNTS["sim3_widen_match"] == before + 1, "sim3_widen_match: launch count"
    _match_equal("sim3_widen_match", mk,
                 loop_closing._sim3_widen_matches_plain(stc, 9, 4, S12, intr, 100), 200)


def merge_problem(seed=41, K=256, F=2048, P=32768, D=8, pool_n=4096):
    """Random merge-walk inputs at the default capacities, dense with
    collisions: landmark ids from a narrow range (rows repeat ids, so two
    rows of a direction redirect one landmark), features drawn with
    repeats (two rows add at one feature), the new keyframe the target of
    the last D / 2 directions (each reads the row the one before left)."""
    g = np.random.default_rng(seed)
    table = np.where(g.uniform(size=(K, F)) < 0.5, g.integers(0, 3000, (K, F)), -1)
    valid = g.uniform(size=P) < 0.9
    obs = g.integers(0, 6, P)
    a_ids = np.concatenate([np.full(D // 2, 11), [10, 9, 8, 10]])
    b_ids = np.concatenate([[10, 9, 8, 10], np.full(D // 2, 11)])
    feat = g.integers(0, F, (D, F))
    hits = g.uniform(size=(D, F)) < 0.3
    pool_ids = np.where(g.uniform(size=pool_n) < 0.8, g.choice(3000, pool_n), -1)
    lrows = np.array([11, 10, 9, 8, 7, 6, 0, 0])
    present = np.array([True] * 6 + [False] * 2)
    lfeat = g.integers(0, F, (D, pool_n))
    lhits = (g.uniform(size=(D, pool_n)) < 0.2) & (pool_ids >= 0)[None, :]
    t = torch.from_numpy
    i32 = lambda a: t(np.asarray(a, np.int32))  # noqa: E731
    return (dict(table=i32(table), valid=t(valid), obs=i32(obs), a_ids=i32(a_ids),
                 b_ids=i32(b_ids), feat=i32(feat), hits=t(hits)),
            dict(rows=i32(lrows), present=t(present), pool_ids=i32(pool_ids), feat=i32(lfeat),
                 hits=t(lhits)))


def _check_fuse_merge(cuda):
    """Kernel 23 on merge_problem: the local merge walk and the finish
    (with and without clearing dead bindings) bit-equal to their plain
    versions, a redirect chain found."""
    loc, _ = merge_problem()
    c = {k: v.to(cuda) for k, v in loc.items()}
    args = (c["table"], c["valid"], c["obs"], c["a_ids"], c["b_ids"], c["feat"], c["hits"])
    before = kernels.COUNTS["fuse_merge"]
    out_k = local_mapping.fuse_merge(*args)
    out_p = local_mapping.fuse_merge_plain(*args)
    assert kernels.COUNTS["fuse_merge"] == before + 1, "fuse_merge: launch count"
    for what, x, y in zip(("table", "valid", "redirect"), out_k, out_p):
        assert torch.equal(x, y), f"fuse_merge: {what}"
    chained = out_p[2][out_p[2].long()] != out_p[2]
    assert chained.any().item(), "fuse_merge: no redirect chain"
    for clear in (True, False):
        fk = matching.fuse_finish(*out_p, clear_invalid=clear)
        assert torch.equal(fk, matching.fuse_finish_plain(*out_p, clear_invalid=clear)), \
            f"fuse_finish (clear_invalid={clear})"


def _check_loop_merge(cuda):
    """Kernel 23's loop rule on merge_problem: bit-equal, redirects found."""
    loc, lp = merge_problem()
    d = {k: v.to(cuda) for k, v in lp.items()}
    largs = (loc["table"].to(cuda), loc["valid"].to(cuda), d["rows"], d["present"],
             d["pool_ids"], d["feat"], d["hits"])
    P = largs[1].shape[0]
    before = kernels.COUNTS["loop_merge"]
    out_k = loop_closing.loop_merge(*largs)
    out_p = loop_closing.loop_merge_plain(*largs)
    assert kernels.COUNTS["loop_merge"] == before + 1, "loop_merge: launch count"
    for what, x, y in zip(("table", "valid", "redirect"), out_k, out_p):
        assert torch.equal(x, y), f"loop_merge: {what}"
    assert (out_p[2] != torch.arange(P, device=cuda)).any().item(), "loop_merge: no redirect"


def _check_covis(cuda):
    """Kernel 24 on fuse_map with repeated ids in a row and a bound
    landmark marked dead: the row of every keyframe and the matrix equal."""
    st, _, _ = fuse_map()
    st.kf_kp_mp[3, :50] = st.kf_kp_mp[3, 50:100]
    st.mp_valid[int(st.kf_kp_mp[2, 0].clamp(min=0))] = False
    st.kf_valid[6] = False
    stc = _to_state(st, cuda)
    for k in (0, 3, 6, 11):
        assert torch.equal(map_store.covisibility_weights(stc, k),
                           map_store.covisibility_weights_plain(stc, k)), f"covis_row {k}"
    C = map_store.covisibility_matrix(stc)
    assert torch.equal(C, map_store.covisibility_matrix_plain(stc)), "covis_matrix"
    assert C.sum().item() > 0


def test_map_kernels_match_plain(cuda):
    """Kernel 9 (observer bits and votes); kernel 10 and its eigensolver
    entry; kernels 20 and 21, the landmark-space duplicate searches
    (fuse3d_problem); kernel 23, the fuse merges and their finish
    (merge_problem); kernel 24, the covisibility row and matrix
    (fuse_map)."""
    _check_obs_bits_and_votes(cuda)
    _check_fuse_merge(cuda)
    _check_covis(cuda)
    g = np.random.default_rng(6)
    A = g.normal(size=(12, 2048, 4, 4)).astype(np.float32)
    A[:, :64, 3] = A[:, :64, 2] * 1.0001      # near rank-deficient systems
    A = torch.from_numpy(A).to(cuda)
    before = kernels.COUNTS["null_vector4"]
    out_k = linalg.null_vector_4(A)
    out_p = linalg.null_vector_4_plain(A)
    assert kernels.COUNTS["null_vector4"] == before + 1
    assert out_k.shape == (12, 2048, 4)
    assert (out_k - out_p).abs().max().item() <= 1e-6
    _check_jacobi_eigh(A)
    _check_fuse3d(cuda)


def _check_jacobi_eigh(A):
    """The eigensolver entry on [24576, 4, 4] Gram matrices: equal to its
    plain version (every op rounded as the plain version's), within the
    null vector's 1e-6 bound on the vectors and 1e-6 relative on the
    values."""
    M = (A.transpose(-1, -2) @ A).reshape(-1, 4, 4).contiguous()
    before = kernels.COUNTS["jacobi_eigh4"]
    vk, Vk = linalg.jacobi_eigh_4x4(M)
    vp, Vp = linalg.jacobi_eigh_4x4_plain(M)
    assert kernels.COUNTS["jacobi_eigh4"] == before + 1, "jacobi_eigh4: launch count"
    assert vk.shape == (M.shape[0], 4) and Vk.shape == M.shape
    assert (Vk - Vp).abs().max().item() <= 1e-6, "jacobi_eigh4: vectors"
    assert ((vk - vp).abs() / vp.abs().clamp(min=1.0)).max().item() <= 1e-6, "jacobi_eigh4"


def fuse3d_problem(seed=29, P=32768, L=2048, n_live=12000, n_lines=600):
    """Pools at the default capacities: live landmarks first seen at
    keyframes 0-9, and in the recent keyframes (10-11) near-copies of live
    ones (within the radius with close descriptors, beyond it, or with far
    descriptors) as fuse_duplicate_*_3d meets them."""
    g = np.random.default_rng(seed)
    xyz = np.zeros((P, 3), np.float32)
    xyz[:n_live] = g.normal(size=(n_live, 3)) * [2.0, 1.0, 1.0] + [0.0, 0.0, 4.0]
    desc = g.integers(-2 ** 31, 2 ** 31, (P, 8), dtype=np.int64).astype(np.int32)
    first = np.full(P, -1, np.int32)
    first[:n_live] = g.integers(0, 10, n_live)
    src = g.choice(n_live, 700, replace=False)
    dst = np.arange(n_live, n_live + 700)
    xyz[dst] = xyz[src] * (1 + g.normal(size=(700, 1)) * 0.008).astype(np.float32)
    desc[dst] = desc[src] ^ (g.uniform(size=(700, 8)) < 0.02).astype(np.int32)
    desc[dst[::5]] = ~desc[dst[::5]]
    first[dst] = g.integers(10, 12, 700)
    valid = first >= 0
    ends = np.zeros((L, 6), np.float32)
    c = g.normal(size=(n_lines, 3)) * [2.0, 1.0, 1.0] + [0.0, 0.0, 4.0]
    u = g.normal(size=(n_lines, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    ends[:n_lines] = np.concatenate([c - 0.5 * u, c + 0.5 * u], 1)
    ldesc = g.integers(-2 ** 31, 2 ** 31, (L, 8), dtype=np.int64).astype(np.int32)
    lfirst = np.full(L, -1, np.int32)
    lfirst[:n_lines] = g.integers(0, 10, n_lines)
    lsrc = g.choice(n_lines, 150, replace=False)
    ldst = np.arange(n_lines, n_lines + 150)
    ends[ldst] = ends[lsrc] + (g.normal(size=(150, 6)) * 0.03).astype(np.float32)
    ldesc[ldst] = ldesc[lsrc] ^ (g.uniform(size=(150, 8)) < 0.03).astype(np.int32)
    lfirst[ldst] = g.integers(10, 12, 150)
    t = torch.from_numpy
    return ((t(xyz), t(desc), t(valid), t(first)),
            (t(ends), t(ldesc), t(lfirst >= 0), t(lfirst)))


def _check_fuse3d(cuda):
    """Kernels 20 / 21 on every recent landmark of fuse3d_problem: best and
    has equal to the plain versions (every product and sum rounded as
    theirs, in the reference's order)."""
    pts, lns = fuse3d_problem()
    for name, fn, plain, pool, th, R in (
            ("fuse_points_3d", local_mapping.fuse3d_points_match,
             local_mapping.fuse3d_points_match_plain, pts, 50, 512),
            ("fuse_lines_3d", local_mapping.fuse3d_lines_match,
             local_mapping.fuse3d_lines_match_plain, lns, 100, 128)):
        pool = [a.to(cuda) for a in pool]
        rows = torch.nonzero(pool[3] >= 10)[:R, 0]
        before = kernels.COUNTS[name]
        bk, hk = fn(*pool, rows, th)
        bp, hp = plain(*pool, rows, th)
        assert kernels.COUNTS[name] == before + 1, f"{name}: launch count"
        assert torch.equal(hk, hp), f"{name}: has"
        assert torch.equal(bk, bp), f"{name}: best"
        assert hk.sum().item() >= R // 10, f"{name}: too few duplicates found"


def ba_problem(seed=7, KL=16, PL=2048, LL=256, F=2048, LF=128):
    """A local BA problem at the main path's shapes, seeded with numpy:
    KL keyframes on an arc facing a box of points and lines (the second
    half free, the first fixed), each landmark seen by 3-6 keyframes with
    pixel noise and 5% outliers, free poses and landmarks perturbed."""
    g = np.random.default_rng(seed)
    intr = Intrinsics.from_config(CameraConfig(fy=480.0))
    Ts = []
    for k in range(KL):
        a = 0.6 * (k / (KL - 1) - 0.5)
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        C = np.array([2.0 * np.sin(a), 0.1 * np.cos(3 * a), -2.0 * (1 - np.cos(a))])
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, -R @ C
        Ts.append(T)
    Ts = np.stack(Ts)
    box = lambda n: np.stack([g.uniform(-2, 2, n), g.uniform(-1.5, 1.5, n),  # noqa: E731
                              g.uniform(4, 8, n)], 1)
    pts, ls, le = box(PL), box(LL), box(LL)

    def proj(T, X):
        pc = X @ T[:3, :3].T + T[:3, 3]
        return np.stack([intr.fx * pc[:, 0] / pc[:, 2] + intr.cx,
                         intr.fy * pc[:, 1] / pc[:, 2] + intr.cy], 1)

    obs_uv = np.zeros((KL, F, 2))
    edge_mp = -np.ones((KL, F), np.int64)
    octave = g.integers(0, 4, (KL, F))
    fill = np.zeros(KL, np.int64)
    for j in range(PL):
        for k in g.choice(KL, g.integers(3, min(7, KL + 1)), replace=False):
            uv = proj(Ts[k], pts[j:j + 1])[0] + g.normal(0, 0.8, 2)
            if g.uniform() < 0.05:
                uv += g.uniform(-25, 25, 2)
            if fill[k] < F:
                edge_mp[k, fill[k]], obs_uv[k, fill[k]] = j, uv
                fill[k] += 1
    obs_l = np.zeros((KL, LF, 3))
    edge_ln = -np.ones((KL, LF), np.int64)
    lfill = np.zeros(KL, np.int64)
    for j in range(LL):
        for k in g.choice(KL, g.integers(3, min(6, KL + 1)), replace=False):
            us = proj(Ts[k], ls[j:j + 1])[0] + g.normal(0, 0.5, 2)
            ue = proj(Ts[k], le[j:j + 1])[0] + g.normal(0, 0.5, 2)
            ln = np.cross(np.r_[us, 1.0], np.r_[ue, 1.0])
            if lfill[k] < LF:
                edge_ln[k, lfill[k]] = j
                obs_l[k, lfill[k]] = ln / np.hypot(ln[0], ln[1])
                lfill[k] += 1
    free = np.arange(KL) >= KL // 2
    Tp = Ts.copy()
    for k in np.nonzero(free)[0]:
        Tp[k, :3, 3] += g.normal(0, 0.02, 3)
    f = lambda x, dt=torch.float32: torch.tensor(np.asarray(x), dtype=dt)  # noqa: E731
    prob = local_ba.BAProblem(
        kf_T_cw=f(Tp), kf_free=f(free, torch.bool), kf_valid=torch.ones(KL, dtype=torch.bool),
        obs_uv=f(obs_uv), obs_sigma2=f(1.2 ** (2 * octave)), edge_mp=f(edge_mp, torch.int32),
        edge_valid=f(edge_mp >= 0, torch.bool), mp_xyz=f(pts + g.normal(0, 0.01, pts.shape)),
        mp_valid=f(g.uniform(size=PL) < 0.97, torch.bool))
    lines = local_ba.BALineProblem(
        ln_start=f(ls + g.normal(0, 0.01, ls.shape)), ln_end=f(le + g.normal(0, 0.01, le.shape)),
        ln_valid=torch.ones(LL, dtype=torch.bool), obs_l=f(obs_l),
        obs_sigma2=f(np.full((KL, LF), 4.0)), edge_ln=f(edge_ln, torch.int32),
        edge_valid=f(edge_ln >= 0, torch.bool))
    return prob, lines, intr


def _to(t, dev):
    return type(t)(*[x.to(dev) for x in t])


def test_local_ba_matches_plain(cuda):
    """Kernel 12's one-launch form at 16 keyframes, with lines and points
    only, and at the main path's occupancy (9 valid keyframes of 16 slots,
    8 free, lines on); its dense solver alone at the window's and global
    BA's system sizes."""
    for with_lines in (True, False):
        _check_local_ba(cuda, with_lines)
    _check_local_ba(cuda, True, n_valid=9)
    _check_dense_solve(cuda, ((96, 96), (378, 378)))


def _check_dense_solve(cuda, shapes):
    """The dense solver of kernels 12 and 18 (csrc/dense_lu.cuh, the
    `dense_solve` entry) against its plain version on (n, capacity)
    systems, a damped J^T J and one with an eigenvalue near 1e-6: the same
    pivot rows, x within 1e-5 of the plain x (relative to its largest
    entry; the plain version repeats the kernel's operations in its order),
    a backward error within 10x of torch.linalg.solve's, and two launches
    bit-identical."""
    g = np.random.default_rng(37)

    def backward_error(A, b, x):
        A, b, x = A.double(), b.double(), x.double()
        return ((A @ x - b).abs().max() / (A.abs().sum(1).max() * x.abs().max()
                                           + b.abs().max())).item()

    for n, cap in shapes:
        J = g.normal(size=(2 * n, n))
        Q, _ = np.linalg.qr(g.normal(size=(n, n)))
        lam = np.geomspace(1.0, 1e3, n)
        lam[0] = 1e-6
        for A in (J.T @ J + 1e-3 * np.eye(n), (Q * lam) @ Q.T):
            b = g.normal(size=(n, 1))
            Ab = torch.from_numpy(np.concatenate([A, b], 1).astype(np.float32)).to(cuda)
            before = kernels.COUNTS["dense_solve"]
            xk, pk = linalg.dense_solve(Ab, cap)
            xk2, pk2 = linalg.dense_solve(Ab, cap)
            xp, pp = linalg.lu_solve_blocked_plain(Ab, n, linalg.dense_panel_width(cap))
            xl = torch.linalg.solve(Ab[:, :n], Ab[:, n])
            torch.cuda.synchronize()
            what = f"dense_solve n={n} capacity {cap}"
            assert kernels.COUNTS["dense_solve"] == before + 2, f"{what}: launch count"
            assert torch.equal(xk, xk2) and torch.equal(pk, pk2), f"{what}: two launches differ"
            assert torch.equal(pk, pp), f"{what}: pivot rows"
            assert (xk - xp).abs().max().item() <= 1e-5 * xp.abs().max().item(), what
            be, be_lib = (backward_error(Ab[:, :n], Ab[:, n], x) for x in (xk, xl))
            assert be <= 10 * be_lib, f"{what}: backward error {be:.2e} vs {be_lib:.2e}"


def window_slots(prob, lines, n_valid):
    """The problem as the main path's window holds it: keyframe slots
    n_valid.. invalid with no edge (the padding), the first fixed and the
    other valid ones free."""
    KL = prob.kf_valid.shape[0]
    valid = torch.arange(KL) < n_valid
    pad = ~valid[:, None]
    prob = prob._replace(kf_valid=valid, kf_free=valid & (torch.arange(KL) >= 1),
                         edge_valid=prob.edge_valid & ~pad,
                         edge_mp=torch.where(pad, -1, prob.edge_mp))
    lines = lines._replace(edge_valid=lines.edge_valid & ~pad,
                           edge_ln=torch.where(pad, -1, lines.edge_ln))
    return prob, lines


def _check_local_ba(cuda, with_lines, n_valid=None):
    what = f"local_ba ({'lines' if with_lines else 'points only'}" \
        f"{f', {n_valid} valid keyframes' if n_valid else ''})"
    prob, lines, intr = ba_problem()
    if n_valid:
        prob, lines = window_slots(prob, lines, n_valid)
    prob = _to(prob, cuda)
    lines = _to(lines, cuda) if with_lines else None
    cfg = OptimConfig()
    torch.cuda.synchronize()
    before = kernels.COUNTS["local_ba"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        rk = local_ba.bundle_adjust(prob, intr, cfg, lines=lines)
        rk2 = local_ba.bundle_adjust(prob, intr, cfg, lines=lines)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.COUNTS["local_ba"] == before + 2, f"{what}: launch count"
    rp = local_ba.bundle_adjust_plain(prob, intr, cfg, lines=lines)
    for a, b in zip(rk, rk2):
        if a is not None:
            assert torch.equal(a, b), f"{what}: two launches differ"   # deterministic reductions
    assert (rk.kf_T_cw - rp.kf_T_cw).abs().max().item() <= 1e-3, f"{what}: poses"
    assert (rk.mp_xyz - rp.mp_xyz).abs().max().item() <= 1e-3, f"{what}: points"
    assert (rk.edge_inlier == rp.edge_inlier).float().mean().item() >= 0.995, f"{what}: masks"
    assert rk.edge_inlier.sum().item() > 0.8 * prob.edge_valid.sum().item(), f"{what}: inliers"
    if with_lines:
        assert (rk.ln_start - rp.ln_start).abs().max().item() <= 1e-3, f"{what}: line starts"
        assert (rk.ln_end - rp.ln_end).abs().max().item() <= 1e-3, f"{what}: line ends"
        assert (rk.line_inlier == rp.line_inlier).float().mean().item() >= 0.995, \
            f"{what}: line masks"
    if n_valid:
        assert torch.equal(rk.kf_T_cw[n_valid:], prob.kf_T_cw[n_valid:]), f"{what}: padding"
        assert not rk.edge_inlier[n_valid:].any(), f"{what}: padding's edges"


def test_sharded_and_batched_kernels_match_plain(cuda):
    """Kernel 12's sharded form on a 4-shard mesh of the card (16
    keyframes, 2049 points and 257 lines padded to 2052 / 260, so every
    shard holds landmarks, and points only), against its sharded plain
    version and the unsharded kernel; kernels 1, 11 and 2's batch entries
    on a stack of three bench frames against the single-frame entries and
    the plain versions, and `extract_orb` of the stack against each frame's."""
    for with_lines in (True, False):
        _check_local_ba_sharded(cuda, with_lines)
    _check_batched_frontend(cuda)


def _check_local_ba_sharded(cuda, with_lines):
    from structure_slam_pointline_tpu_torch.parallel import dist_ba
    from structure_slam_pointline_tpu_torch.parallel.mesh import edge_mesh

    what = f"local_ba_shard ({'lines' if with_lines else 'points only'})"
    prob, lines, intr = ba_problem(PL=2049, LL=257)
    prob = _to(dist_ba._pad_landmarks(prob, 4), cuda)
    lines = _to(dist_ba._pad_lines(lines, 4), cuda) if with_lines else None
    mesh = edge_mesh(4, device=cuda)
    cfg = OptimConfig()
    torch.cuda.synchronize()
    before = kernels.COUNTS["local_ba_shard"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        rk = local_ba.bundle_adjust_sharded(prob, intr, cfg, lines, mesh)
        rk2 = local_ba.bundle_adjust_sharded(prob, intr, cfg, lines, mesh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.COUNTS["local_ba_shard"] == before + 2 * (4 * 65 + 20), f"{what}: launches"
    rp = local_ba.bundle_adjust_sharded_plain(prob, intr, cfg, lines, mesh)
    ru = local_ba.bundle_adjust(prob, intr, cfg, lines=lines)
    for a, b in zip(rk, rk2):
        if a is not None:
            assert torch.equal(a, b), f"{what}: two launches differ"   # fixed-order sums
    for ref, name in ((rp, "sharded plain"), (ru, "unsharded kernel")):
        for a, b in ((rk.kf_T_cw, ref.kf_T_cw), (rk.mp_xyz, ref.mp_xyz),
                     (rk.ln_start, ref.ln_start), (rk.ln_end, ref.ln_end)):
            if a is not None:
                assert (a - b).abs().max().item() <= 1e-3, f"{what} against the {name}"
        assert (rk.edge_inlier == ref.edge_inlier).float().mean().item() >= 0.995, what
        if with_lines:
            assert (rk.line_inlier == ref.line_inlier).float().mean().item() >= 0.995, what
    assert rk.edge_inlier.sum().item() > 0.8 * prob.edge_valid.sum().item(), f"{what}: inliers"


def _check_batched_frontend(cuda):
    cam = CameraConfig(fy=480.0)
    scene = synthetic.make_room_scene(350, 40, seed=0)
    poses = synthetic.circular_trajectory(610, radius=0.5)
    imgs = torch.from_numpy(np.stack([synthetic.render(scene, poses[i], cam, noise=2.0, seed=i)
                                      for i in (40, 41, 90)])).to(cuda)
    fe = FrontendConfig()
    levels, blurred = pyramid.build_blurred_pyramid(imgs.to(torch.bfloat16))
    for b in range(3):
        lv1, bl1 = pyramid.build_blurred_pyramid(imgs[b].to(torch.bfloat16))
        for x, y in zip(levels + blurred, lv1 + bl1):
            assert torch.equal(x[b], y), "the batched pyramid differs"
    score_raw = []
    before = dict(kernels.COUNTS)
    maps = fast.fast_score_nms_levels(levels)
    for lv, (raw, nms), (raw_p, nms_p) in zip(levels, maps,
                                              fast.fast_score_nms_levels_plain(levels)):
        assert torch.equal(raw, raw_p) and torch.equal(nms, nms_p), "fast_nms_batch"
        for b in range(3):
            r1, n1 = fast.fast_score_nms(lv[b])
            assert torch.equal(raw[b], r1) and torch.equal(nms[b], n1), "fast_nms_batch"
        score_raw.append((nms, raw))
    ks = extract.level_budgets(fe.n_keypoints, fe.n_levels, fe.scale_factor)
    kw = dict(cell=fe.cell_size, cell_cap=8, threshold=fe.fast_threshold,
              min_threshold=fe.fast_min_threshold, border=orb.PATCH_RADIUS + 1)
    sel = fast.select_keypoints_levels(score_raw, ks, **kw)
    sel_p = fast.select_keypoints_levels_plain(score_raw, ks, **kw)
    for b in range(3):
        one = fast.select_keypoints_levels([(n[b], r[b]) for n, r in score_raw], ks, **kw)
        for lvl, ((xk, rk, vk), (x1, r1, v1)) in enumerate(zip(sel, one)):
            assert torch.equal(xk[b], x1) and torch.equal(rk[b], r1) \
                and torch.equal(vk[b], v1), f"kp_select_batch frame {b} level {lvl}"
        _assert_selection_equal([(x[b], r[b], v[b]) for x, r, v in sel],
                                [(x[b], r[b], v[b]) for x, r, v in sel_p], f"batch frame {b}")
    scales = [float(s) for s in pyramid.level_scales(fe.n_levels, fe.scale_factor)]
    xy = torch.cat([x for x, _, _ in sel], dim=1)
    args = (blurred, xy, ks, scales, list(range(len(ks))))
    ak, dk, xk, ok = orb.orient_and_describe_levels(*args)
    ap, dp, xp, op = orb.orient_and_describe_levels_plain(*args)
    for b in range(3):
        one = orb.orient_and_describe_levels([bl[b] for bl in blurred], xy[b], *args[2:])
        assert all(torch.equal(x[b], y) for x, y in zip((ak, dk, xk, ok), one)), \
            "orb_describe_batch"
    assert (dk == dp).all(-1).float().mean().item() >= 0.995, "orb_describe_batch"
    assert (ak - ap).abs().max().item() <= 1e-4, "orb_describe_batch"
    assert torch.equal(xk, xp) and torch.equal(ok, op), "orb_describe_batch: xy0, octave"
    for name in ("fast_nms_batch", "kp_select_batch", "orb_describe_batch"):
        assert kernels.COUNTS[name] - before[name] == 1, f"{name}: launch count"
    kb = extract.extract_orb(imgs, fe)
    for b in range(3):
        k1 = extract.extract_orb(imgs[b], fe)
        for f in k1._fields:
            assert torch.equal(getattr(kb, f)[b], getattr(k1, f)), f"extract_orb of a stack: {f}"


def test_cuda_tensor_never_takes_the_plain_path(cuda, monkeypatch):
    """A CUDA tensor of the wrong dtype raises instead of falling back, and
    the wrappers of kernels 9-26 (kernels 5-6 and 26 through `detect_lines`
    at line_support_downsample = 2 and `detect_lines_pyramid`, kernels
    22-24 through the fuses, the loop closer's matches and loop fuse, the
    covisibility functions and the tracking matches, kernel 25 through
    `extract_orb` and `build_pyramid`) run on CUDA tensors with every
    plain version made to raise, and with it the [B, M, N] window mask,
    masked_match and its gates, and the [K, P + 1] dedup table."""
    with pytest.raises(TypeError):
        fast.fast_score_nms(torch.zeros((64, 64), device=cuda))
    with pytest.raises(TypeError):
        linalg.null_vector_4(torch.zeros((8, 4, 4), dtype=torch.float64, device=cuda))
    with pytest.raises(TypeError):
        fast.select_keypoints(torch.zeros((64, 64), dtype=torch.bfloat16, device=cuda), 8)
    with pytest.raises(TypeError):
        map_store.votes_from_bits(torch.zeros((4, 8), dtype=torch.int64, device=cuda),
                                  torch.ones(4, dtype=torch.bool, device=cuda),
                                  torch.ones(256, dtype=torch.bool, device=cuda))
    with pytest.raises(TypeError):
        matching.fuse_finish(torch.zeros((4, 8), dtype=torch.int64, device=cuda),
                             torch.ones(16, dtype=torch.bool, device=cuda),
                             torch.arange(16, dtype=torch.int32, device=cuda), True)
    fst, fcfg, fintr = fuse_map(n_kf=6, n_pts=1500, n_lines=60)
    fst = _to_state(fst, cuda)

    def boom(*a, **k):
        raise AssertionError("plain version reached from a CUDA tensor")

    for mod, name in ((fast, "select_keypoints_levels_plain"), (linalg, "null_vector_4_plain"),
                      (linalg, "jacobi_eigh_4x4_plain"), (lsd, "lsd_support_plain"),
                      (lsd, "lsd_refine_plain"), (local_mapping, "fuse3d_points_match_plain"),
                      (local_mapping, "fuse3d_lines_match_plain"),
                      (local_ba, "bundle_adjust_plain"),
                      (map_store, "compute_obs_bits_plain"),
                      (map_store, "votes_from_bits_plain"), (bow, "transform_plain"),
                      (bow, "query_database_plain"), (pnp, "ransac_pnp_plain"),
                      (sim3_solver, "ransac_sim3_plain"),
                      (pose_graph, "optimize_sim3_pair_plain"),
                      (pose_graph, "optimize_pose_graph_plain"),
                      (compact, "compact_points_plain"), (compact, "compact_lines_plain"),
                      (compact, "compact_keyframes_plain"),
                      (local_ba, "bundle_adjust_sharded_plain"),
                      (fast, "fast_score_nms_plain"), (orb, "orient_and_describe_plain"),
                      (fast, "fast_score_nms_levels_plain"),
                      (orb, "orient_and_describe_levels_plain"),
                      (linalg, "lu_solve_blocked_plain"),
                      (local_mapping, "fuse_match_points_plain"),
                      (local_mapping, "fuse_match_lines_plain"),
                      (local_mapping, "fuse_merge_plain"), (matching, "fuse_finish_plain"),
                      (matching, "_dedup_row_table"), (matching, "window_mask"),
                      (loop_closing, "_project_pool_matches_plain"),
                      (loop_closing, "_sim3_widen_matches_plain"),
                      (loop_closing, "loop_merge_plain"),
                      (map_store, "covisibility_weights_plain"),
                      (map_store, "covisibility_matrix_plain"),
                      (pyramid, "resize_bilinear_plain"), (pyramid, "blur_plain"),
                      (pyramid, "build_pyramid_plain"),
                      (pyramid, "build_blurred_pyramid_plain"), (lsd, "lsd_merge_plain"),
                      (lsd, "lsd_octave_merge_plain"),
                      (matching, "track_match_points_plain"),
                      (matching, "track_match_lines_plain"), (matching, "masked_match"),
                      (matching, "rotation_consistency"), (matching, "mad_margin_gate")):
        monkeypatch.setattr(mod, name, boom)
    fast.select_keypoints(torch.rand((64, 96), device=cuda) * 30, 16, cell=16, cell_cap=2)
    linalg.null_vector_4(torch.rand((3, 5, 4, 4), device=cuda))
    st = map_store.init_map(SLAMConfig(), cuda)
    map_store.votes_from_bits(map_store.compute_obs_bits(st)[:16], torch.ones(
        16, dtype=torch.bool, device=cuda), st.kf_valid)
    prob, lines, intr = ba_problem(KL=4, PL=64, LL=8, F=128, LF=16)
    local_ba.bundle_adjust(_to(prob, cuda), intr, OptimConfig(), lines=_to(lines, cuda))
    from structure_slam_pointline_tpu_torch.parallel.mesh import edge_mesh

    local_ba.bundle_adjust_sharded(_to(prob, cuda), intr, OptimConfig(), _to(lines, cuda),
                                   edge_mesh(2, device=cuda))
    extract.extract_orb(torch.rand((2, 96, 128), device=cuda) * 255, FrontendConfig(
        n_keypoints=64, n_levels=2))
    voc, desc, valid = bow_problem(n_sets=2, n=64)
    _, vec = bow.transform(voc, desc.to(cuda), valid.to(cuda))
    bow.query_database(vec[0], vec, torch.ones(2, dtype=torch.bool, device=cuda))
    pts, uv, mask, sets, _ = pnp_problem(C=2, N=64, I=8)
    pnp.ransac_pnp(pts.to(cuda), uv.to(cuda), mask.to(cuda), sets.to(cuda), PNP_INTR)
    p1, p2, smask, ssets = sim3_problem(N=64, I=8)
    sim3_solver.ransac_sim3(p1.to(cuda), p2.to(cuda), smask.to(cuda), ssets.to(cuda), PNP_INTR)
    pose_graph.optimize_sim3_pair(*[t.to(cuda) for t in sim3_pair_problem(N=64)],
                                  PNP_INTR.fx, PNP_INTR.fy, PNP_INTR.cx, PNP_INTR.cy)
    pose_graph.optimize_pose_graph(_to(pose_graph_problem(K=16, n_valid=12), cuda), n_iters=3)
    for fn in (compact.compact_points, compact.compact_lines, compact.compact_keyframes):
        fn(st)
    linalg.jacobi_eigh_4x4(torch.rand((5, 4, 4), device=cuda))
    linalg.dense_solve(torch.eye(8, 9, device=cuda) + torch.rand((8, 9), device=cuda))
    cfg = SLAMConfig()
    intr = Intrinsics.from_config(cfg.camera)
    local_mapping.fuse_duplicate_points_3d(st, 1, 2, intr, cfg)
    local_mapping.fuse_duplicate_lines_3d(st, 1, 2, intr, cfg)
    scene = synthetic.make_room_scene(350, 40, seed=0)
    img = synthetic.render(scene, synthetic.circular_trajectory(610, radius=0.5)[40],
                           CameraConfig(fy=480.0), noise=2.0, seed=40)
    lines = lsd.detect_lines(torch.from_numpy(img).to(cuda),
                             FrontendConfig(line_support_downsample=2))
    assert lines.valid.any()
    lines = lsd.detect_lines_pyramid(torch.from_numpy(img).to(cuda), FrontendConfig())
    assert lines.valid.any()
    with pytest.raises(TypeError):
        pyramid.blur(torch.zeros((64, 64), device=cuda))
    pyramid.build_pyramid(torch.rand((2, 96, 128), device=cuda).to(torch.bfloat16), 3)
    tst, tfr = track_frame(fst, 3)
    tfr = type(tfr)(*[t.to(cuda) for t in tfr])
    ids = torch.arange(2048, dtype=torch.int32, device=cuda)
    matching.track_match_points(tst, tfr, tst.kf_T_cw[3], ids, fintr, fcfg, 15.0, True, 0.9)
    matching.track_match_lines(tst, tfr, tst.kf_T_cw[3], ids[:256], fintr, fcfg, 30.0)
    nb = torch.tensor([4, 3, 2, -1], device=cuda)
    fst = local_mapping.fuse_projected_points(fst, 5, nb, fintr, fcfg)
    fst = local_mapping.fuse_projected_lines(fst, 5, nb, fintr, fcfg)
    pool = loop_closing._loop_pool(fst, torch.tensor([0, 1, -1, -1, -1, -1, -1, -1],
                                                     dtype=torch.int32, device=cuda))
    loop_closing._project_pool_matches(fst, 4, fst.kf_T_cw[4], pool, fintr, 10.0, 50)
    loop_closing._sim3_widen_matches(fst, 4, 1, fst.kf_T_cw[4] @ torch.linalg.inv(
        fst.kf_T_cw[1]), fintr, 100)
    loop_closing._loop_fuse(fst, np.array([5, 4, 3, -1, -1, -1, -1, -1]), pool, fintr, 50)
    map_store.covisibility_weights(fst, 5)
    map_store.covisibility_matrix(fst)
    torch.cuda.synchronize()


def compact_problem(seed=19, prefix_cull=False):
    """A MapState at the default capacities (256 keyframes x 1024 features x
    64 lines, 32768 points, 2048 lines) with every field random on the
    CPU: validity masks with ~half the slots live, edge grids holding live,
    culled and -1 references, stamps on live and culled keyframes; with
    `prefix_cull` the first keyframes are culled."""
    g = np.random.default_rng(seed)
    st = map_store.init_map(SLAMConfig(), "cpu")
    out = {}
    for f in st._fields:
        a = getattr(st, f)
        if a.dtype == torch.bool:
            v = g.uniform(size=a.shape) < 0.5
        elif a.dtype == torch.float32:
            v = g.normal(size=a.shape).astype(np.float32)
        else:
            v = g.integers(-2 ** 31, 2 ** 31, a.shape, dtype=np.int64).astype(np.int32)
        out[f] = torch.from_numpy(v)
    K, P, L = st.kf_valid.shape[0], st.mp_valid.shape[0], st.ml_valid.shape[0]
    out["kf_kp_mp"] = torch.from_numpy(g.integers(-1, P, st.kf_kp_mp.shape).astype(np.int32))
    out["kf_line_ml"] = torch.from_numpy(g.integers(-1, L, st.kf_line_ml.shape).astype(np.int32))
    for f, n in (("mp_first_kf", P), ("mp_last_kf", P), ("ml_first_kf", L), ("ml_last_kf", L)):
        out[f] = torch.from_numpy(g.integers(-1, K, n).astype(np.int32))
    if prefix_cull:
        out["kf_valid"][:5] = False
    return map_store.MapState(**out)


def test_compact_matches_plain(cuda):
    """Kernel 19: the three passes at the default capacities, bit-equal to
    the plain versions on every field (gathers and table lookups), the
    live counts and `perm` equal, three launches per pass."""
    for seed, prefix in ((19, False), (20, True)):
        st = compact_problem(seed, prefix)
        st_c = _to(st, cuda)
        for name in ("compact_points", "compact_lines", "compact_keyframes"):
            before = kernels.COUNTS["compact"]
            out_k = getattr(compact, name)(st_c)
            out_p = getattr(compact, name + "_plain")(st)
            torch.cuda.synchronize()
            assert kernels.COUNTS["compact"] == before + 3, f"{name}: launch count"
            for f in st._fields:
                a, b = getattr(out_k[0], f).cpu(), getattr(out_p[0], f)
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                assert torch.equal(a, b), f"{name} (seed {seed}): field {f}"
            assert int(out_k[1]) == int(out_p[1]), f"{name} (seed {seed}): live count"
            if name == "compact_keyframes":
                assert torch.equal(out_k[2].cpu(), out_p[2]), f"{name} (seed {seed}): perm"


def bow_problem(n_sets=24, n=1024, seed=11):
    """A vocabulary trained (branching 8, depth 4) on clustered descriptors
    and `n_sets` sets of `n` descriptors from the same clusters, ~10%
    invalid, seeded with numpy."""
    g = np.random.default_rng(seed)
    protos = g.integers(0, 2 ** 32, (120, 8), dtype=np.uint32)

    def draw(m):
        bits = np.unpackbits(protos[g.choice(120, m)].view(np.uint8), axis=1)
        bits ^= (g.uniform(size=bits.shape) < 0.1).astype(np.uint8)
        return np.packbits(bits, axis=1).view(np.uint32)

    voc = bow.train_vocabulary(draw(6000), 8, 4, seed=3)
    desc = torch.from_numpy(draw(n_sets * n).view(np.int32).reshape(n_sets, n, 8).copy())
    return voc, desc, torch.from_numpy(g.uniform(size=(n_sets, n)) > 0.1)


def test_bow_kernels_match_plain(cuda):
    """Kernel 13 (the BoW transform, batched and one set) and kernel 14
    (the database query, two score floors)."""
    _check_bow_transform(cuda)
    _check_bow_query(cuda)


def _check_bow_transform(cuda):
    voc, desc, valid = bow_problem()
    before = kernels.COUNTS["bow_transform"]
    for d, v in ((desc, valid), (desc[0], valid[0])):
        wk, bk = bow.transform(voc, d.to(cuda), v.to(cuda))
        wp, bp = bow.transform_plain(voc.nodes(cuda), d.to(cuda), v.to(cuda), 8, 4)
        torch.cuda.synchronize()
        assert torch.equal(wk, wp), f"bow_transform {tuple(d.shape)}: words"
        assert torch.equal(bk.view(torch.int32), bp.view(torch.int32)), \
            f"bow_transform {tuple(d.shape)}: vectors"
        assert torch.equal(wk.cpu(), bow.transform(voc, d, v)[0]), \
            f"bow_transform {tuple(d.shape)}: against the CPU"
    assert kernels.COUNTS["bow_transform"] == before + 2, "bow_transform: launch count"


def _check_bow_query(cuda):
    voc, desc, valid = bow_problem(n_sets=4)
    g = np.random.default_rng(5)
    kf_bows = torch.from_numpy(g.dirichlet(np.full(4096, 0.05), 256).astype(np.float32))
    kf_bows[:4] = bow.transform(voc, desc, valid)[1]
    kf_bows[200:] = 0.0                      # rows never indexed
    q = bow.transform(voc, desc[1], valid[1])[1]
    kf_valid = torch.from_numpy(g.uniform(size=256) > 0.2)
    for min_score in (0.0, 0.3):
        sk = bow.query_database(q.to(cuda), kf_bows.to(cuda), kf_valid.to(cuda), min_score)
        sp = bow.query_database_plain(q.to(cuda), kf_bows.to(cuda), kf_valid.to(cuda),
                                      min_score)
        torch.cuda.synchronize()
        assert torch.equal(sk, sp), f"bow_query (min score {min_score})"
    assert (sk.cpu() - bow.query_database(q, kf_bows, kf_valid, 0.3)).abs().max() <= 1e-6, \
        "bow_query against the CPU"


PNP_INTR = Intrinsics.from_config(CameraConfig(fy=480.0))


def pnp_problem(C=16, N=1024, I=256, seed=13):
    """C candidates: the same pixels, each with its own 3D points (a pose
    per candidate, 0.5 px noise, 30% outliers), ~5% masked, and I sample
    sets of six unmasked points each; seeded with numpy."""
    from structure_slam_pointline_tpu_torch.utils import lie

    g = np.random.default_rng(seed)
    intr = PNP_INTR
    uv = np.stack([g.uniform(0, 640, N), g.uniform(0, 480, N)], 1).astype(np.float32)
    pts, Ts, masks, sets = [], [], [], []
    for _ in range(C):
        T = lie.se3_exp(torch.from_numpy(g.normal(0, 0.3, 6).astype(np.float32))).numpy()
        depth = g.uniform(2, 8, N)
        pc = np.stack([(uv[:, 0] - intr.cx) / intr.fx * depth,
                       (uv[:, 1] - intr.cy) / intr.fy * depth, depth], 1)
        pc[:, :2] += g.normal(0, 0.5 / intr.fx, (N, 2)) * depth[:, None]
        out = g.uniform(size=N) < 0.3
        pc[out] += g.normal(0, 0.5, (int(out.sum()), 3))
        pts.append((pc - T[:3, 3]) @ T[:3, :3])
        Ts.append(T)
        m = g.uniform(size=N) > 0.05
        masks.append(m)
        sel = np.nonzero(m)[0]
        sets.append(np.stack([g.choice(sel, 6, replace=False) for _ in range(I)]))
    f = lambda a, dt: torch.from_numpy(np.asarray(a)).to(dt)  # noqa: E731
    return (f(np.stack(pts), torch.float32), f(uv, torch.float32), f(np.stack(masks), torch.bool),
            f(np.stack(sets), torch.int32), np.stack(Ts))


def test_ransac_pnp_matches_plain(cuda):
    """At the relocalization shape, and at 3 x 100 hypotheses: a count that
    is not a multiple of the hypotheses a block of the kernel holds."""
    for C, I in ((16, 256), (3, 100)):
        pts, uv, mask, sets, T_gt = pnp_problem(C=C, I=I)
        args = [t.to(cuda) for t in (pts, uv, mask, sets)]
        at = f"at {C} x {I}"
        before = kernels.COUNTS["ransac_pnp"]
        rk = pnp.ransac_pnp(*args, PNP_INTR, min_inliers=10)
        rp = pnp.ransac_pnp_plain(*args, PNP_INTR, min_inliers=10)
        torch.cuda.synchronize()
        assert kernels.COUNTS["ransac_pnp"] == before + 2, at
        assert torch.equal(rk.n_inliers, rp.n_inliers), at
        assert torch.equal(rk.success, rp.success) and bool(rk.success.all()), at
        assert torch.equal(torch.argmax(rk.counts, 1), torch.argmax(rp.counts, 1)), at
        assert (rk.T_cw - rp.T_cw).abs().max().item() <= 1e-4, at
        assert (rk.counts == rp.counts).float().mean().item() >= 0.99, at
        assert torch.equal(rk.inliers, pnp.inlier_masks_plain(
            rk.hyp, args[0], args[1], args[2], PNP_INTR)[torch.arange(C),
                                                         torch.argmax(rk.counts, 1)]), at
        R = rk.hyp[..., :3].double()
        eye = torch.eye(3, dtype=torch.float64, device=cuda)
        assert (R.transpose(-1, -2) @ R - eye).abs().max().item() <= 1e-5, at
        assert np.abs(rk.T_cw.cpu().numpy()[:, :3, 3] - T_gt[:, :3, 3]).max() <= 0.05, at


def _sim3(xi):
    from structure_slam_pointline_tpu_torch.utils import lie

    return lie.sim3_exp(torch.as_tensor(np.asarray(xi, np.float32)))


def sim3_problem(N=1024, I=128, seed=17):
    """N matched pairs in two camera frames related by a Sim(3) (30%
    outliers, ~25% masked) and I three-point sample sets of unmasked pairs."""
    g = np.random.default_rng(seed)
    p2 = np.stack([g.uniform(-2, 2, N), g.uniform(-1.5, 1.5, N), g.uniform(3, 8, N)], 1)
    S = _sim3([0.05, -0.1, 0.08, 0.3, 0.1, -0.4, np.log(1.1)]).numpy()
    p1 = p2 @ S[:3, :3].T + S[:3, 3]
    out = g.uniform(size=N) < 0.3
    p1[out] += g.normal(0, 0.5, (int(out.sum()), 3))
    mask = g.uniform(size=N) > 0.25
    sel = np.nonzero(mask)[0]
    sets = np.stack([g.choice(sel, 3, replace=False) for _ in range(I)])
    f = lambda a, dt: torch.from_numpy(np.asarray(a)).to(dt)  # noqa: E731
    return (f(p1, torch.float32), f(p2, torch.float32), f(mask, torch.bool),
            f(sets, torch.int32))


def sim3_pair_problem(N=1024, seed=19):
    """The arguments of optimize_sim3_pair before the camera: a perturbed
    Sim(3), N pairs with 20% wrong matches, ~10% invalid, octave
    variances."""
    g = np.random.default_rng(seed)
    X2 = np.stack([g.uniform(-2, 2, N), g.uniform(-1.5, 1.5, N), g.uniform(3, 8, N)], 1)
    S = _sim3([0.03, -0.05, 0.02, 0.2, -0.1, 0.15, np.log(1.12)]).numpy()
    X1 = X2 @ S[:3, :3].T + S[:3, 3]
    intr = PNP_INTR

    def proj(p):
        return np.stack([p[:, 0] / p[:, 2] * intr.fx + intr.cx,
                         p[:, 1] / p[:, 2] * intr.fy + intr.cy], 1)

    uv1 = proj(X1) + g.normal(0, 0.5, (N, 2))
    uv2 = proj(X2) + g.normal(0, 0.5, (N, 2))
    bad = g.choice(N, N // 5, replace=False)
    X2[bad] = X2[np.roll(bad, 3)]
    S0 = _sim3([0.02, -0.01, 0.015, 0.05, 0.05, -0.05, 0.02]).numpy() @ S
    sig1 = 1.2 ** (2 * g.integers(0, 4, N))
    sig2 = 1.2 ** (2 * g.integers(0, 4, N))
    f = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dt)  # noqa: E731
    return (f(S0), f(X1), f(X2), f(uv1), f(uv2), f(g.uniform(size=N) > 0.1, torch.bool),
            f(sig1), f(sig2))


def pose_graph_problem(K=256, n_valid=60, seed=23):
    """An essential graph at the map's capacity: n_valid keyframes on a
    drifted circle (the rest invalid), the odometry chain, covisibility
    edges to the next 2-4 keyframes, one loop edge of weight 5, vertex 0
    and the loop keyframe fixed."""
    g = np.random.default_rng(seed)
    gt = np.stack([_sim3([0.0, 2 * np.pi * k / n_valid, 0.0, np.cos(2 * np.pi * k / n_valid),
                          0.0, np.sin(2 * np.pi * k / n_valid), 0.0]).numpy()
                   for k in range(n_valid)])
    S = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    drift = np.eye(4, dtype=np.float32)
    for k in range(n_valid):
        drift = _sim3(np.concatenate([g.normal(0, 0.005, 3), g.normal(0, 0.01, 3),
                                      g.normal(0, 0.005, 1)])).numpy() @ drift
        S[k] = drift @ gt[k]
    ei, ej, w = [], [], []
    for a in range(n_valid - 1):
        for b in range(a + 1, min(a + 1 + g.integers(1, 4), n_valid)):
            ei.append(a)
            ej.append(b)
            w.append(1.0)
    ei.append(2)
    ej.append(n_valid - 1)
    w.append(5.0)
    meas = np.stack([gt[j] @ np.linalg.inv(gt[i]) for i, j in zip(ei, ej)])
    fixed = np.zeros(K, bool)
    fixed[[0, 2]] = True
    f = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dt)  # noqa: E731
    return pose_graph.PoseGraphProblem(
        S_cw=f(S), kf_valid=f(np.arange(K) < n_valid, torch.bool), kf_fixed=f(fixed, torch.bool),
        edge_i=f(ei, torch.int32), edge_j=f(ej, torch.int32), edge_Sji=f(meas),
        edge_valid=torch.ones(len(ei), dtype=torch.bool), edge_weight=f(w))


def _check_ransac_sim3(cuda):
    args = [t.to(cuda) for t in sim3_problem()]
    before = kernels.COUNTS["ransac_sim3"]
    rk = sim3_solver.ransac_sim3(*args, PNP_INTR)
    rp = sim3_solver.ransac_sim3_plain(*args, PNP_INTR)
    torch.cuda.synchronize()
    assert kernels.COUNTS["ransac_sim3"] == before + 3
    assert torch.equal(torch.argmax(rk.counts), torch.argmax(rp.counts))
    assert int(rk.n_inliers) == int(rp.n_inliers) and bool(rk.success)
    assert (rk.S12 - rp.S12).abs().max().item() <= 1e-4
    assert (rk.counts == rp.counts).float().mean().item() >= 0.99
    assert (rk.scale - rp.scale).abs().max().item() <= 1e-4


def _check_optimize_sim3_pair(cuda):
    args = [t.to(cuda) for t in sim3_pair_problem()]
    cam = (PNP_INTR.fx, PNP_INTR.fy, PNP_INTR.cx, PNP_INTR.cy)
    before = kernels.COUNTS["sim3_pair"]
    rk = pose_graph.optimize_sim3_pair(*args, *cam)
    rp = pose_graph.optimize_sim3_pair_plain(*args, *cam)
    torch.cuda.synchronize()
    assert kernels.COUNTS["sim3_pair"] == before + 1
    assert (rk.S12 - rp.S12).abs().max().item() <= 1e-4
    assert (rk.inliers == rp.inliers).float().mean().item() >= 0.995
    assert int(rk.n_inliers) >= 500       # of ~740 true pairs


def _check_optimize_pose_graph(cuda):
    prob = _to(pose_graph_problem(), cuda)
    before = kernels.COUNTS["pose_graph"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sk = pose_graph.optimize_pose_graph(prob, n_iters=25, lam_init=1e-16)
        sk2 = pose_graph.optimize_pose_graph(prob, n_iters=25, lam_init=1e-16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sp = pose_graph.optimize_pose_graph_plain(prob, n_iters=25, lam_init=1e-16)
    torch.cuda.synchronize()
    assert kernels.COUNTS["pose_graph"] == before + 2 * 25 * 5
    assert torch.equal(sk, sk2)
    valid = prob.kf_valid
    assert (sk - sp)[valid].abs().max().item() <= 1e-4
    assert torch.equal(sk[~valid], prob.S_cw[~valid])
    assert (sk - prob.S_cw)[valid].abs().max().item() > 1e-3


def _check_local_ba_64_keyframes(cuda):
    """Global BA's shape: 64 keyframes (the solve in global memory, over
    the free cameras only), 16384 points and 1024 lines; the last 8 slots
    invalid, as a window's padding is."""
    prob, lines, intr = ba_problem(KL=64, PL=16384, LL=1024, F=1024, LF=64)
    prob = prob._replace(kf_valid=torch.arange(64) < 56)
    prob, lines = _to(prob, cuda), _to(lines, cuda)
    cfg = OptimConfig()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rk = local_ba.bundle_adjust(prob, intr, cfg, lines=lines)
        rk2 = local_ba.bundle_adjust(prob, intr, cfg, lines=lines)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rp = local_ba.bundle_adjust_plain(prob, intr, cfg, lines=lines)
    for a, b in zip(rk, rk2):
        if a is not None:
            assert torch.equal(a, b)
    assert (rk.kf_T_cw - rp.kf_T_cw).abs().max().item() <= 1e-3
    for a, b in ((rk.mp_xyz, rp.mp_xyz), (rk.ln_start, rp.ln_start), (rk.ln_end, rp.ln_end)):
        assert (a - b).abs().max().item() <= 1e-3
    assert (rk.edge_inlier == rp.edge_inlier).float().mean().item() >= 0.995
    assert (rk.line_inlier == rp.line_inlier).float().mean().item() >= 0.995
    assert torch.equal(rk.kf_T_cw[56:], prob.kf_T_cw[56:])
    assert not rk.edge_inlier[56:].any()


def test_loop_closing_kernels_match_plain(cuda):
    """Kernels 16, 17 and 18 and kernel 12 at 64 keyframes, each against
    its plain version, the dense solver at the pose graph's sizes, and
    kernel 22's four entries (fuse_map) and kernel 23's loop rule
    (merge_problem) (one item: the suite's xdist schedule depends on the
    number of items, tests/test_torch_loop_closing.py)."""
    _check_ransac_sim3(cuda)
    _check_optimize_sim3_pair(cuda)
    _check_optimize_pose_graph(cuda)
    _check_local_ba_64_keyframes(cuda)
    _check_fuse_match(cuda)
    _check_loop_merge(cuda)
    # the pose graph's solve: 51 free keyframes at the 256-keyframe capacity
    # (panels of 16), and the capacity filled
    _check_dense_solve(cuda, ((357, 1792), (1792, 1792)))
