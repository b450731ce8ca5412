"""The eight CUDA kernels of the PyTorch port against their plain
versions, on the card, at the main path's shapes (640x480 levels, 1024
keypoints, 2048 local points x 1024 features, pose problems of 2048
points + 256 lines, line octaves of 640x480 and 320x240 with 256 / 128
anchors, 64 segments). Marked `gpu`: they skip without a CUDA device. Run
on the card:

    python -m pytest -o addopts="" -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerances: FAST/NMS maps and every Hamming output exactly equal (integer
arithmetic and bf16 roundings reproduced op for op); ORB descriptors equal
on >= 99.5% of keypoints and angles within 1e-4 rad (float32 moment sums
in another order can move atan2 by an ulp and, rarely, flip the bank);
pose within 1e-4 with inlier masks equal on >= 99.5% (float32 reductions
in another order). Line kernels: the dense support pass (score and
packed ridge plane) exactly equal (bf16 roundings, glibc's atan2f and
integer support counts reproduced op for op); refinement endpoints within
1e-3 px on >= 99.9% of valid anchors (both sum in sample order; the bound
leaves room for an ulp of cos / sin moving a sample across a pixel
boundary); LBD words equal on >= 99% of segments with descriptors within
1e-5 (the plain version sums in the kernel's order, so they are expected
equal; the bounds leave room for an ulp in a transcendental); atan2
bit-exact against the torch-op version on the card and on the CPU.
"""

import numpy as np
import pytest
import torch

from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.config import CameraConfig, FrontendConfig, OptimConfig
from structure_slam_pointline_tpu_torch.io import synthetic
from structure_slam_pointline_tpu_torch.ops import fast, hamming, lbd, lsd, orb, pyramid
from structure_slam_pointline_tpu_torch.optim import pose_opt
from structure_slam_pointline_tpu_torch.utils import fmath
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics

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


def test_fast_nms_matches_plain(levels):
    before = kernels.COUNTS["fast_nms"]
    for lv in levels[0]:
        raw_k, nms_k = fast.fast_score_nms(lv)
        raw_p, nms_p = fast.fast_score_nms_plain(lv)
        torch.cuda.synchronize()
        assert torch.equal(raw_k, raw_p)
        assert torch.equal(nms_k, nms_p)
    assert kernels.COUNTS["fast_nms"] == before + len(levels[0])


def test_orb_matches_plain(levels):
    g = np.random.default_rng(0)
    for bl in levels[1]:
        h, w = bl.shape
        xy = np.stack([g.uniform(16, w - 17, 300), g.uniform(16, h - 17, 300)], 1)
        xy = torch.tensor(xy, dtype=torch.float32, device=bl.device)
        ak, dk = orb.orient_and_describe(bl, xy)
        ap, dp = orb.orient_and_describe_plain(bl, xy)
        torch.cuda.synchronize()
        assert (dk == dp).all(1).float().mean().item() >= 0.995
        assert (ak - ap).abs().max().item() <= 1e-4


def _descs(g, n):
    return torch.tensor(g.integers(-2 ** 31, 2 ** 31, (n, 8)), dtype=torch.int32)


@pytest.mark.parametrize("shape", [(2048, 1024), (2048, 2048), (5, 1), (37, 700)])
def test_hamming_best2_matches_plain(cuda, shape):
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
    for x, y in zip(out_k, out_p):
        assert torch.equal(x.cpu(), y)


def test_hamming_best2_batched_matches_plain(cuda):
    g = np.random.default_rng(3)
    a = torch.stack([_descs(g, 1024) for _ in range(4)])
    b = torch.stack([_descs(g, 1024) for _ in range(4)])
    allow = torch.from_numpy(g.uniform(size=(4, 1024, 1024)) < 0.1)
    for aa in (a, a[0]):
        out_k = hamming.masked_best2(aa.to(cuda), b.to(cuda), allow.to(cuda))
        out_p = hamming.masked_best2_plain(aa, b, allow)
        for x, y in zip(out_k, out_p):
            assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("line_weight", [0.0, 1.0])
def test_pose_lm_matches_plain(cuda, line_weight):
    g = np.random.default_rng(int(line_weight) + 11)
    intr = Intrinsics.from_config(CameraConfig(fy=480.0))
    N, M = 2048, 256
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
    f = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    args = [f(T0), f(pts), f(obs), torch.from_numpy(g.uniform(size=N) < 0.8),
            f(1.2 ** (2 * g.integers(0, 8, N))), f(sw), f(ew), f(l),
            torch.from_numpy(g.uniform(size=M) < (0.8 if line_weight else 0.0)),
            f(np.full(M, 1.0 / max(line_weight, 1e-9)))]
    cfg = OptimConfig()
    rp = pose_opt.pose_optimize_plain(*args, intr, cfg)
    rk = pose_opt.pose_optimize(*[a.to(cuda) for a in args], intr, cfg)
    assert (rk.T_cw.cpu() - rp.T_cw).abs().max().item() <= 1e-4
    same = torch.cat([rk.point_inliers.cpu() == rp.point_inliers,
                      rk.line_inliers.cpu() == rp.line_inliers]).float().mean().item()
    assert same >= 0.995


@pytest.fixture(scope="module")
def octaves(cuda):
    cam = CameraConfig(fy=480.0)
    scene = synthetic.make_room_scene(350, 40, seed=0)
    pose = synthetic.circular_trajectory(610, radius=0.5)[40]
    img = torch.from_numpy(synthetic.render(scene, pose, cam, noise=2.0, seed=40)).to(cuda)
    return [img, lsd.half_octave(img).contiguous()]


def test_lsd_support_matches_plain(octaves):
    fe = FrontendConfig()
    before = kernels.COUNTS["lsd_support"]
    for img in octaves:
        args = (fe.line_grad_threshold, fe.line_angle_tol, fe.line_min_length)
        best_k, packed_k = lsd.lsd_support(img, *args)
        best_p, packed_p = lsd.lsd_support_plain(img, *args)
        torch.cuda.synchronize()
        assert torch.equal(best_k, best_p)
        assert torch.equal(packed_k, packed_p)
        assert (best_k > 0).sum().item() > 100
    assert kernels.COUNTS["lsd_support"] == before + 2


def test_lsd_refine_matches_plain(octaves):
    fe = FrontendConfig()
    for img, K, S in zip(octaves, (256, 128), (48, 24)):
        best, packed = lsd.lsd_support_plain(img, fe.line_grad_threshold, fe.line_angle_tol,
                                             fe.line_min_length)
        axy, _, avalid = fast.select_keypoints(best, k=K, cell=16, cell_cap=1,
                                               threshold=1.0, min_threshold=1.0, border=4)
        ax, ay = axy[:, 0].contiguous(), axy[:, 1].contiguous()
        args = (S, fe.line_refine_iters, fe.line_angle_tol, fe.line_grad_threshold)
        out_k = lsd.lsd_refine(img, packed, ax, ay, *args)
        out_p = lsd.lsd_refine_plain(img, packed, ax, ay, *args)
        err = (out_k[:, :4] - out_p[:, :4]).abs().amax(1)[avalid]
        assert avalid.sum().item() > 50
        assert (err <= 1e-3).float().mean().item() >= 0.999


def test_lbd_matches_plain(octaves):
    img = octaves[0]
    lines = lsd.detect_lines_pyramid(img, FrontendConfig())
    assert lines.valid.sum().item() >= 32
    wk, dk = lbd.describe_lines(img, lines.endpoints.contiguous(), lines.valid)
    wp, dp = lbd.describe_lines_plain(img, lines.endpoints, lines.valid)
    same = (wk == wp).all(1).float().mean().item()
    err = (dk - dp).abs().max().item()
    assert same >= 0.99 and err <= 1e-5, (same, err)


def test_atan2_matches_plain(cuda):
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


def test_cuda_tensor_never_takes_the_plain_path(cuda):
    """A CUDA tensor of the wrong dtype raises instead of falling back."""
    with pytest.raises(TypeError):
        fast.fast_score_nms(torch.zeros((64, 64), device=cuda))
