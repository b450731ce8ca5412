"""Binary line-band descriptors (kernel 7).

Counterpart of structure_slam_pointline_tpu/ops/lbd.py. Per segment,
24 samples along the line x 9 bands across it (2 px apart) read the
nearest pixel's quantized gradient (1/16 unit) and intensity; the four
rectified gradient channels in the line frame give per-band mean and
population std over the samples, the photometrically normalized
intensity gives two more per band, and the flip-invariant parts
u = s + mirror(s), w = |s - mirror(s)| of each block, L2-normalized per
block, are the float descriptor [100]. 256 seeded comparisons of its
entries pack into 8 words (int32 bit patterns of the reference's uint32).

`describe_lines` is the wrapper of CUDA kernel 7 (`lbd_describe`,
csrc/lbd.cu), which replaces the reference's `describe_lines`
(lbd.py:76-179) with one block per segment; the kernel computes each
sample's gradient from the image instead of packing a whole-image plane.
`describe_lines_plain` is the plain version, the reference op for op
(the plane packed as uint32 in int64, `sp >> 20` on the unsigned value,
`jnp.std` as the population std).
"""

from __future__ import annotations

import numpy as np
import torch

from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.ops.lsd import gradients
from structure_slam_pointline_tpu_torch.utils import fmath

N_SAMPLES = 24
N_BANDS = 9
HALF_BANDS = (N_BANDS + 1) // 2
BAND_SPACING = 2.0
DESC_FLOATS = 2 * (HALF_BANDS * 4 * 2 + HALF_BANDS * 2)   # 100
_SWAP = [1, 0, 3, 2]

# jnp.linspace(0, 1, 24) in float32 as JAX computes it (six entries differ
# from numpy's linspace in the last bit)
_TS = np.asarray([
    0.0, 0.043478261679410934, 0.08695652335882187, 0.1304347813129425,
    0.17391304671764374, 0.21739131212234497, 0.260869562625885, 0.30434784293174744,
    0.3478260934352875, 0.3913043439388275, 0.43478262424468994, 0.47826087474823,
    0.52173912525177, 0.5652173757553101, 0.6086956858634949, 0.6521739363670349,
    0.695652186870575, 0.739130437374115, 0.782608687877655, 0.8260869979858398,
    0.8695652484893799, 0.9130434989929199, 0.95652174949646, 1.0], np.float32)


def _pair_table(seed: int = 11) -> np.ndarray:
    """[256, 2] indices into the invariant descriptor: same-channel
    cross-band and same-band cross-channel comparisons within each u/w
    block (seeded subset of the candidate pool); the reference's table."""
    H = HALF_BANDS
    cands = []
    off = 0
    for width in (4, 4, 2, 4, 4, 2):
        for c in range(width):
            for i in range(H):
                for j in range(i + 1, H):
                    cands.append((off + i * width + c, off + j * width + c))
        for b in range(H):
            for c in range(width):
                for c2 in range(c + 1, width):
                    cands.append((off + b * width + c, off + b * width + c2))
        off += H * width
    cands = np.asarray(cands, np.int32)
    g = np.random.default_rng(seed)
    sel = g.choice(len(cands), size=256, replace=False)
    return cands[np.sort(sel)]


_PAIRS = _pair_table()
_TABLES: dict = {}


def _tables(device):
    """(pairs int32 [256, 2], ts float32 [24]) on `device`, made once."""
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = (torch.from_numpy(_PAIRS).to(device),
                        torch.from_numpy(_TS).to(device))
    return _TABLES[key]


def _frame(endpoints: torch.Tensor):
    sx, sy, ex, ey = endpoints.unbind(1)
    length = torch.clamp(fmath.hypot(ex - sx, ey - sy), min=1e-6)
    dx = (ex - sx) / length
    dy = (ey - sy) / length
    return sx, sy, ex, ey, dx, dy, -dy, dx


def _mean_std(x: torch.Tensor, dim: int):
    """(mean, jnp.std) along `dim`: the population std, ddof 0. The count
    divides as a tensor: torch on CUDA turns a division by a Python
    scalar into a product with its reciprocal, an ulp off the kernel's."""
    s = fmath.seq_sum(x, dim)
    n = torch.full_like(s, float(x.shape[dim]))
    m = s / n
    c = x - m.unsqueeze(dim)
    return m, torch.sqrt(fmath.seq_sum(c * c, dim) / n)


def describe_lines_plain(img: torch.Tensor, endpoints: torch.Tensor, valid: torch.Tensor):
    """[L, 4] segments -> (packed int32 [L, 8], float descriptor [L, 100])."""
    L = endpoints.shape[0]
    dev = endpoints.device
    gx, gy, _ = gradients(img)
    h, w = img.shape
    qgx = torch.clamp(torch.round((gx.float() + 128.0) * 16.0), 0.0, 4095.0).long()
    qgy = torch.clamp(torch.round((gy.float() + 128.0) * 16.0), 0.0, 4095.0).long()
    qi = torch.clamp(torch.round(img.float()), 0.0, 255.0).long()
    plane = ((qgx << 20) | (qgy << 8) | qi).reshape(-1)

    sx, sy, ex, ey, dx, dy, nx, ny = _frame(endpoints)
    pairs, ts = _tables(dev)
    bands = (torch.arange(N_BANDS, dtype=torch.float32, device=dev)
             - (N_BANDS - 1) / 2) * BAND_SPACING
    px = (sx[:, None, None] + (ex - sx)[:, None, None] * ts[None, :, None]
          + nx[:, None, None] * bands[None, None, :])
    py = (sy[:, None, None] + (ey - sy)[:, None, None] * ts[None, :, None]
          + ny[:, None, None] * bands[None, None, :])
    xi = torch.clamp(torch.round(px).to(torch.int32), 0, w - 1)
    yi = torch.clamp(torch.round(py).to(torch.int32), 0, h - 1)
    sp = plane[(yi * w + xi).long()]
    sgx = (sp >> 20).float() * (1.0 / 16.0) - 128.0
    sgy = ((sp >> 8) & 4095).float() * (1.0 / 16.0) - 128.0
    si = (sp & 255).float()
    g_par = sgx * dx[:, None, None] + sgy * dy[:, None, None]
    g_per = sgx * nx[:, None, None] + sgy * ny[:, None, None]
    zero = torch.zeros_like(g_par)
    stats = torch.stack([torch.maximum(g_per, zero), torch.maximum(-g_per, zero),
                         torch.maximum(g_par, zero), torch.maximum(-g_par, zero)], dim=-1)
    mean, std = _mean_std(stats, 1)                                 # [L, B, 4]
    mu, sd = _mean_std(si.reshape(L, -1), 1)
    si_n = (si - mu[:, None, None]) / torch.clamp(sd, min=1e-6)[:, None, None]
    i_mean, i_std = _mean_std(si_n, 1)                              # [L, B]

    def inv(v, swap_ch: bool):
        m = v.flip(1)
        if swap_ch:
            m = m[..., _SWAP]
        return (v + m)[:, :HALF_BANDS], torch.abs(v - m)[:, :HALF_BANDS]

    u_mean, w_mean = inv(mean, True)
    u_std, w_std = inv(std, True)
    u_int, w_int = inv(torch.stack([i_mean, i_std], dim=-1), False)

    def norm(v):
        v = v.reshape(L, -1)
        return v / torch.clamp(torch.sqrt(fmath.seq_sum(v * v, 1)), min=1e-9)[:, None]

    desc = torch.cat([norm(u_mean), norm(u_std), norm(u_int), norm(w_mean), norm(w_std),
                      norm(w_int)], dim=-1)
    bits = (desc[:, pairs[:, 0].long()] > desc[:, pairs[:, 1].long()]).long()
    shifts = torch.arange(32, device=dev)
    words = torch.sum(bits.reshape(L, 8, 32) << shifts, dim=2)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)
    return torch.where(valid[:, None], words, torch.zeros_like(words)), desc


def describe_lines(img: torch.Tensor, endpoints: torch.Tensor, valid: torch.Tensor):
    """[L, 4] float32 segments of a float32 [H, W] image -> (packed int32
    [L, 8], float32 descriptor [L, 100]).

    CPU tensors -> plain version; CUDA tensors -> kernel 7 (or raise)."""
    if endpoints.device.type == "cpu":
        return describe_lines_plain(img, endpoints, valid)
    name = "lbd_describe"
    kernels.check_dtype(name, img, torch.float32)
    kernels.check_dtype(name, endpoints, torch.float32)
    kernels.check_dtype(name, valid, torch.bool)
    if img.dim() != 2 or endpoints.dim() != 2 or endpoints.shape[1] != 4 \
            or valid.shape != endpoints.shape[:1]:
        raise ValueError(f"{name}: shapes {tuple(img.shape)}, {tuple(endpoints.shape)}, "
                         f"{tuple(valid.shape)}")
    ep, vl = endpoints.contiguous(), valid.contiguous()
    dev = kernels.check_cuda(name, img, ep, vl)
    pairs, ts = _tables(dev)
    L = ep.shape[0]
    packed = torch.empty((L, 8), dtype=torch.int32, device=dev)
    desc = torch.empty((L, DESC_FLOATS), dtype=torch.float32, device=dev)
    if L:
        h, w = img.shape
        kernels.launch(name, kernels.ptr(img), h, w, kernels.ptr(ep), kernels.ptr(vl), L,
                       kernels.ptr(pairs), kernels.ptr(ts), kernels.ptr(packed),
                       kernels.ptr(desc))
    return packed, desc


__all__ = ["describe_lines", "describe_lines_plain", "N_SAMPLES", "N_BANDS",
           "DESC_FLOATS"]
