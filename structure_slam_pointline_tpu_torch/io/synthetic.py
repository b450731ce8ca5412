"""Synthetic scene generator + renderer for tests and benchmarks.

The environment ships no dataset images (the reference's Examples/dataset
holds only manifests), so end-to-end validation renders a known 3D scene
— textured square patches anchored at 3D points plus bright 3D line
segments — from a ground-truth trajectory, then measures ATE against that
trajectory (SURVEY.md §4: the reference's only validation is end-to-end
ATE on rendered ICL-NUIM, which is itself a synthetic dataset).

Rendering is vectorized numpy (host-side, not perf-critical).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from structure_slam_pointline_tpu_torch.config import CameraConfig


class Scene(NamedTuple):
    points: np.ndarray      # [P, 3] world points (patch anchors)
    patch_tex: np.ndarray   # [P, T, T] per-point texture (grayscale 0..255)
    patch_axes: np.ndarray  # [P, 2, 3] world-frame in-plane axes of each patch
    patch_size: float       # world-units half-extent of a patch
    lines: np.ndarray       # [L, 6] world segments (x1 y1 z1 x2 y2 z2)


def _natural_textures(g: np.random.Generator, n: int, tex: int,
                      contrast: float) -> np.ndarray:
    """Band-limited (Perlin-like) patch textures with natural image
    statistics: smooth low-frequency structure instead of binary checker
    noise, at a controllable contrast around the scene background."""
    coarse = g.normal(0.0, 1.0, size=(n, tex // 3 + 2, tex // 3 + 2))
    up = np.kron(coarse, np.ones((1, 3, 3)))[:, :tex, :tex]
    # one smoothing pass (3x3 box) kills the kron blockiness
    pad = np.pad(up, ((0, 0), (1, 1), (1, 1)), mode="edge")
    sm = sum(pad[:, dy : dy + tex, dx : dx + tex]
             for dy in range(3) for dx in range(3)) / 9.0
    sm = sm / np.abs(sm).max(axis=(1, 2), keepdims=True).clip(1e-6)
    return (110.0 + 100.0 * contrast * sm).astype(np.float32)


def make_room_scene(n_points: int = 300, n_lines: int = 24, seed: int = 0,
                    extent: float = 4.0, depth_range=(4.0, 9.0), tex: int = 9,
                    natural_tex: bool = False, contrast: float = 1.0,
                    n_occluders: int = 0) -> Scene:
    """A wall of textured patches + a grid of line segments in front of the
    camera. `natural_tex` swaps the binary checker textures for smooth
    band-limited ones at `contrast` (0..1) — the hard-mode frontend input;
    `n_occluders` adds large weakly-textured patches at near depth that
    occlude background structure as the camera moves."""
    g = np.random.default_rng(seed)
    pts = np.stack(
        [
            g.uniform(-extent, extent, n_points),
            g.uniform(-extent * 0.75, extent * 0.75, n_points),
            g.uniform(*depth_range, n_points),
        ],
        axis=1,
    ).astype(np.float32)
    if natural_tex:
        patch_tex = _natural_textures(g, n_points, tex, contrast)
    else:
        # high-contrast random textures -> strong FAST corners, distinctive BRIEF bits
        patch_tex = g.integers(0, 2, size=(n_points, tex, tex)).astype(np.float32) * 200.0 + 30.0
    # random in-plane orientation, patches face roughly toward -z (camera)
    angles = g.uniform(0, 2 * np.pi, n_points)
    ax0 = np.stack([np.cos(angles), np.sin(angles), np.zeros(n_points)], 1).astype(np.float32)
    ax1 = np.stack([-np.sin(angles), np.cos(angles), np.zeros(n_points)], 1).astype(np.float32)
    axes = np.stack([ax0, ax1], axis=1)

    lines = []
    for _ in range(n_lines):
        c = np.array(
            [g.uniform(-extent, extent), g.uniform(-extent * 0.7, extent * 0.7), g.uniform(*depth_range)]
        )
        d = g.normal(size=3)
        d[2] *= 0.15  # keep lines roughly fronto-parallel
        d /= np.linalg.norm(d)
        half = g.uniform(0.8, 2.0)
        lines.append(np.concatenate([c - half * d, c + half * d]))
    if n_occluders > 0:
        # near-depth, weakly-textured blockers (depth-sorted rendering in
        # `render` paints them over the background they hide)
        occ_pts = np.stack(
            [
                g.uniform(-extent * 0.5, extent * 0.5, n_occluders),
                g.uniform(-extent * 0.3, extent * 0.3, n_occluders),
                g.uniform(2.2, 3.2, n_occluders),
            ],
            axis=1,
        ).astype(np.float32)
        occ_tex = _natural_textures(g, n_occluders, tex, 0.15)
        occ_ang = g.uniform(0, 2 * np.pi, n_occluders)
        o0 = np.stack([np.cos(occ_ang), np.sin(occ_ang),
                       np.zeros(n_occluders)], 1).astype(np.float32)
        o1 = np.stack([-np.sin(occ_ang), np.cos(occ_ang),
                       np.zeros(n_occluders)], 1).astype(np.float32)
        # 4x axes -> ~4x patch_size footprint: genuinely large blockers
        o0, o1 = 4.0 * o0, 4.0 * o1
        pts = np.concatenate([pts, occ_pts])
        patch_tex = np.concatenate([patch_tex, occ_tex])
        axes = np.concatenate([axes, np.stack([o0, o1], axis=1)])
    return Scene(
        points=pts,
        patch_tex=patch_tex,
        patch_axes=axes,
        patch_size=0.12,
        lines=np.asarray(lines, np.float32),
    )


def make_cylinder_scene(n_points: int = 700, n_lines: int = 48, seed: int = 0,
                        radius: float = 6.0, height: float = 3.0,
                        tex: int = 9) -> Scene:
    """Landmark patches on the inside of a surrounding cylinder wall, plus
    vertical line segments on the wall: the outward-looking loop scene.
    Each view sees only a ~90 deg arc of the wall, so the trajectory start
    is invisible for most of a lap — a genuine revisit for loop closing
    (the reference's KITTI/TUM loop sequences have this structure; the
    wall scene of make_room_scene never leaves the field of view)."""
    g = np.random.default_rng(seed)
    phi = g.uniform(0, 2 * np.pi, n_points)
    y = g.uniform(-height / 2, height / 2, n_points)
    r = radius + g.uniform(-0.3, 0.3, n_points)
    pts = np.stack([r * np.cos(phi), y, r * np.sin(phi)], 1).astype(np.float32)
    patch_tex = g.integers(0, 2, size=(n_points, tex, tex)).astype(np.float32) * 200.0 + 30.0
    # patch plane spanned by the wall tangent and the vertical
    tang = np.stack([-np.sin(phi), np.zeros(n_points), np.cos(phi)], 1).astype(np.float32)
    vert = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (n_points, 1))
    # random in-plane spin so BRIEF sees varied orientations
    ang = g.uniform(0, 2 * np.pi, n_points).astype(np.float32)[:, None]
    ax0 = np.cos(ang) * tang + np.sin(ang) * vert
    ax1 = -np.sin(ang) * tang + np.cos(ang) * vert
    axes = np.stack([ax0, ax1], axis=1)

    lines = []
    for _ in range(n_lines):
        lp = g.uniform(0, 2 * np.pi)
        lr = radius - 0.15
        x, z = lr * np.cos(lp), lr * np.sin(lp)
        if g.uniform() < 0.6:  # vertical wall line
            y0 = g.uniform(-height / 2, 0.0)
            y1 = y0 + g.uniform(1.0, height / 2 - y0 + 1.0)
            lines.append([x, y0, z, x, y1, z])
        else:  # horizontal chord along the wall
            dp = g.uniform(0.15, 0.35)
            ly = g.uniform(-height / 2, height / 2)
            lines.append([x, ly, z,
                          lr * np.cos(lp + dp), ly, lr * np.sin(lp + dp)])
    return Scene(
        points=pts, patch_tex=patch_tex, patch_axes=axes, patch_size=0.12,
        lines=np.asarray(lines, np.float32),
    )


def loop_trajectory(n_frames: int, laps: float = 2.2, cam_radius: float = 2.0,
                    bob: float = 0.05) -> np.ndarray:
    """[N, 4, 4] T_wc: camera on a circle of `cam_radius`, view axis
    pointing radially outward, `laps` revolutions. Frames past one lap
    revisit earlier views — the loop-closing trajectory (odometry drift
    accumulates over the lap; the revisit is where a loop detector must
    fire). A small vertical bob keeps two-view init parallax healthy."""
    ts = np.linspace(0, 2 * np.pi * laps, n_frames)
    poses = []
    for t in ts:
        c = np.array([cam_radius * np.cos(t), bob * np.sin(3 * t),
                      cam_radius * np.sin(t)])
        fwd = np.array([np.cos(t), 0.0, np.sin(t)])    # outward view
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        T = np.eye(4)
        T[:3, :3] = np.stack([right, up, fwd], axis=1)  # columns = cam axes
        T[:3, 3] = c
        poses.append(T)
    return np.asarray(poses, np.float32)


def circular_trajectory(n_frames: int, radius: float = 0.4, yaw_amp: float = 0.06,
                        z_amp: float = 0.15, seed: int = 1) -> np.ndarray:
    """[N, 4, 4] ground-truth camera-to-world poses T_wc on a smooth arc."""
    ts = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    poses = []
    for t in ts:
        cx = radius * np.sin(t)
        cy = 0.5 * radius * np.sin(2 * t)
        cz = z_amp * np.sin(t)
        yaw = yaw_amp * np.sin(t)
        pitch = 0.5 * yaw_amp * np.cos(t)
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        cp_, sp_ = np.cos(pitch), np.sin(pitch)
        Ry = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
        Rx = np.array([[1, 0, 0], [0, cp_, -sp_], [0, sp_, cp_]])
        T = np.eye(4)
        T[:3, :3] = Ry @ Rx
        T[:3, 3] = [cx, cy, cz]
        poses.append(T)
    return np.asarray(poses, np.float32)


def sweep_trajectory(n_frames: int, x_extent: float = 2.5, yaw_amp: float = 0.10,
                     z_amp: float = 0.2) -> np.ndarray:
    """[N, 4, 4] out-and-back T_wc sweep along +x and home again: the
    camera revisits its starting view in the second half, giving loop
    closing a genuine revisit (and odometry a chance to drift first)."""
    ts = np.linspace(0, 2 * np.pi, n_frames)
    poses = []
    for t in ts:
        cx = 0.5 * x_extent * (1 - np.cos(t))      # 0 -> x_extent -> 0
        cz = z_amp * np.sin(t)
        yaw = yaw_amp * np.sin(t)
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        Ry = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
        T = np.eye(4)
        T[:3, :3] = Ry
        T[:3, 3] = [cx, 0.1 * np.sin(2 * t), cz]
        poses.append(T)
    return np.asarray(poses, np.float32)


def _project(cam: CameraConfig, p_cam: np.ndarray):
    z = p_cam[..., 2]
    u = p_cam[..., 0] / z * cam.fx + cam.cx
    v = p_cam[..., 1] / z * cam.fy + cam.cy
    return u, v, z


def render(scene: Scene, T_wc: np.ndarray, cam: CameraConfig,
           bg: float = 110.0, noise: float = 2.0, seed: int = 0,
           gain: float = 1.0, vignette: float = 0.0,
           blur_px: float = 0.0) -> np.ndarray:
    """Render grayscale [H, W] float32 for camera-to-world pose T_wc.

    Patches are rendered by inverse warping: for each visible point, the
    screen-space bounding box pixels are mapped back to patch texture
    coordinates through the patch plane. Lines are rasterized with a
    1.5 px Gaussian profile. This produces view-consistent corners,
    gradients and line segments — the front-end sees "real" image
    structure, not synthetic keypoint lists.
    """
    H, W = cam.height, cam.width
    g = np.random.default_rng(seed)
    img = np.full((H, W), bg, np.float32)
    # low-frequency background gradient so LSD sees no fake global edges
    yy, xx = np.mgrid[0:H, 0:W]
    img += 10.0 * np.sin(xx / 97.0) + 8.0 * np.cos(yy / 71.0)

    R_cw = T_wc[:3, :3].T
    t_cw = -R_cw @ T_wc[:3, 3]

    # --- patches ---
    p_cam = scene.points @ R_cw.T + t_cw
    u, v, z = _project(cam, p_cam)
    vis = (z > 0.3) & (u > -40) & (u < W + 40) & (v > -40) & (v < H + 40)
    T = scene.patch_tex.shape[1]
    # far-to-near paint order: near patches (occluders) overwrite what
    # they hide
    order = np.nonzero(vis)[0]
    order = order[np.argsort(-z[order])]
    for i in order:
        # patch plane: X(s, t) = P + s*a0 + t*a1, s,t in [-hs, hs]
        a0c = R_cw @ scene.patch_axes[i, 0]
        a1c = R_cw @ scene.patch_axes[i, 1]
        pc = p_cam[i]
        hs = scene.patch_size
        # screen bbox from the 4 corners
        corners = pc[None] + np.array(
            [[-1, -1], [-1, 1], [1, -1], [1, 1]], np.float32
        ) @ np.stack([a0c, a1c]) * hs
        cu, cv, cz = _project(cam, corners)
        if np.any(cz < 0.2):
            continue
        u0, u1 = int(np.floor(cu.min())), int(np.ceil(cu.max()))
        v0, v1 = int(np.floor(cv.min())), int(np.ceil(cv.max()))
        u0, u1 = max(u0, 0), min(u1, W - 1)
        v0, v1 = max(v0, 0), min(v1, H - 1)
        if u1 <= u0 or v1 <= v0 or (u1 - u0) * (v1 - v0) > 120000:
            continue
        pu, pv = np.meshgrid(np.arange(u0, u1 + 1), np.arange(v0, v1 + 1))
        # ray through pixel: r = K^-1 [u, v, 1]
        rx = (pu - cam.cx) / cam.fx
        ry = (pv - cam.cy) / cam.fy
        rays = np.stack([rx, ry, np.ones_like(rx)], axis=-1).astype(np.float32)
        # intersect with plane (pc, normal a0c x a1c)
        n = np.cross(a0c, a1c)
        denom = rays @ n
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        lam = (pc @ n) / denom
        hit = rays * lam[..., None] - pc
        s = hit @ a0c / (hs)
        t = hit @ a1c / (hs)
        inside = (np.abs(s) <= 1) & (np.abs(t) <= 1) & (lam > 0.2)
        ti = np.clip(((s + 1) * 0.5 * T).astype(np.int32), 0, T - 1)
        tj = np.clip(((t + 1) * 0.5 * T).astype(np.int32), 0, T - 1)
        texv = scene.patch_tex[i][tj, ti]
        sub = img[v0 : v1 + 1, u0 : u1 + 1]
        img[v0 : v1 + 1, u0 : u1 + 1] = np.where(inside, texv, sub)

    # --- lines ---
    for l6 in scene.lines:
        a = R_cw @ l6[:3] + t_cw
        b = R_cw @ l6[3:] + t_cw
        if a[2] < 0.3 or b[2] < 0.3:
            continue
        ua, va, _ = _project(cam, a)
        ub, vb, _ = _project(cam, b)
        length = np.hypot(ub - ua, vb - va)
        if length < 2:
            continue
        n_samp = int(length * 2)
        ts = np.linspace(0, 1, n_samp)
        us = ua + (ub - ua) * ts
        vs = va + (vb - va) * ts
        ok = (us >= 1) & (us < W - 1) & (vs >= 1) & (vs < H - 1)
        us, vs = us[ok], vs[ok]
        # stamp a 3x3 neighborhood with Gaussian falloff
        for du in (-1, 0, 1):
            for dv in (-1, 0, 1):
                iu = np.clip((us + du).astype(np.int32), 0, W - 1)
                iv = np.clip((vs + dv).astype(np.int32), 0, H - 1)
                wgt = np.exp(-0.5 * (du * du + dv * dv) / 0.8)
                img[iv, iu] = np.minimum(img[iv, iu] * (1 - wgt) + 245.0 * wgt, 255.0)

    if blur_px > 0:
        # mild motion blur: horizontal box average over ~2*blur_px+1 px
        r = max(int(round(blur_px)), 1)
        acc = img.copy()
        for dx_ in range(1, r + 1):
            acc += np.roll(img, dx_, axis=1) + np.roll(img, -dx_, axis=1)
        img = acc / (2 * r + 1)
    if vignette > 0:
        # radial lens falloff: corners darkened by `vignette` fraction
        r2 = (((xx - cam.cx) / cam.cx) ** 2 + ((yy - cam.cy) / cam.cy) ** 2) / 2.0
        img = img * (1.0 - vignette * r2.astype(np.float32))
    if gain != 1.0:
        # global illumination change (exposure/lighting drift across the
        # sequence): scale about black, like a real exposure change
        img = img * gain
    if noise > 0:
        img = img + g.normal(0, noise, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.float32)


def render_sequence(scene: Scene, poses_wc: np.ndarray, cam: CameraConfig,
                    noise: float = 2.0, illum_amp: float = 0.0,
                    vignette: float = 0.0, blur_px: float = 0.0):
    """Render a whole trajectory; `illum_amp` adds a slow sinusoidal
    exposure drift (gain in [1-amp, 1+amp]) across the sequence;
    `vignette`/`blur_px` add per-frame lens falloff and motion blur."""
    n = len(poses_wc)
    return np.stack([
        render(scene, T, cam, noise=noise, seed=i,
               gain=1.0 + illum_amp * np.sin(2 * np.pi * i / max(n, 1)),
               vignette=vignette, blur_px=blur_px)
        for i, T in enumerate(poses_wc)
    ])


def ate_rmse(est_Twc: np.ndarray, gt_Twc: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error with Sim3/SE3 Umeyama alignment (evo-style).

    Monocular trajectories have free scale, so alignment solves for
    similarity (like the standard TUM evaluation script).
    """
    est = est_Twc[:, :3, 3]
    gt = gt_Twc[:, :3, 3]
    finite = np.isfinite(est).all(1) & np.isfinite(gt).all(1)
    if not finite.all():  # diverged poses: score only the finite rows
        est, gt = est[finite], gt[finite]
    if len(est) == 0:
        return float("inf")
    if align and len(est) >= 3:
        mu_e, mu_g = est.mean(0), gt.mean(0)
        ec, gc = est - mu_e, gt - mu_g
        cov = gc.T @ ec / len(est)
        U, D, Vt = np.linalg.svd(cov)
        S = np.eye(3)
        if np.linalg.det(U) * np.linalg.det(Vt) < 0:
            S[2, 2] = -1
        R = U @ S @ Vt
        var_e = (ec ** 2).sum() / len(est)
        s = np.trace(np.diag(D) @ S) / max(var_e, 1e-12)
        t = mu_g - s * R @ mu_e
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


__all__ = [
    "Scene", "make_room_scene", "make_cylinder_scene", "circular_trajectory",
    "sweep_trajectory", "loop_trajectory", "render", "render_sequence",
    "ate_rmse",
]
