"""Binary descriptor distance and the masked best/second search (kernel 3).

Counterpart of structure_slam_pointline_tpu/ops/hamming.py. Descriptors
are [..., 8] int32 bit patterns of the reference's packed uint32 words.

`masked_best2` is the wrapper of CUDA kernel 3 (csrc/hamming.cu), which
replaces the reference's `hamming_matrix` (hamming.py:32) plus the row
reductions of `masked_match` (matching.py:35) without writing the
[M, N] distance matrix. `masked_best2_plain` is its plain version: the
reference's +-1 matmul (exact in float32 for 256-bit codes, TF32 off),
then argmin / re-mask / argmin with first-index ties.
"""

from __future__ import annotations

import torch

from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.ops.orb import unpack_bits

DESC_BITS = 256
BIG = 1 << 20


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int32 bit patterns (int64 SWAR), same shape, int64."""
    v = x.long() & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def to_pm1(packed: torch.Tensor) -> torch.Tensor:
    """int32 [..., 8] -> float32 [..., 256] in {-1, +1}."""
    return unpack_bits(packed).float() * 2.0 - 1.0


def hamming_matrix(packed_a: torch.Tensor, packed_b: torch.Tensor) -> torch.Tensor:
    """[..., M, 8] x [..., N, 8] -> int32 Hamming distances [..., M, N]."""
    dot = to_pm1(packed_a) @ to_pm1(packed_b).transpose(-1, -2)
    return torch.round((DESC_BITS - dot) * 0.5).to(torch.int32)


def hamming_pairwise(packed_a: torch.Tensor, packed_b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming over matched rows: [..., 8] x [..., 8] -> [...]."""
    return popcount32(packed_a ^ packed_b).sum(-1).to(torch.int32)


def masked_best2_plain(desc_a, desc_b, allow):
    """(best, best_j, second, second_j) int32 [..., M] of the masked
    distances d = where(allow, hamming, 2^20), with the reference's
    semantics: best_j = first argmin, the best column re-masked by adding
    2^20, second_j = first argmin of the re-masked row."""
    d = torch.where(allow, hamming_matrix(desc_a, desc_b),
                    torch.full((), BIG, dtype=torch.int32, device=allow.device))
    best_j = torch.argmin(d, dim=-1, keepdim=True)
    best = torch.gather(d, -1, best_j)
    masked2 = d.scatter(-1, best_j, best + BIG)
    second_j = torch.argmin(masked2, dim=-1, keepdim=True)
    second = torch.gather(masked2, -1, second_j)
    return (best[..., 0], best_j[..., 0].to(torch.int32),
            second[..., 0], second_j[..., 0].to(torch.int32))


def masked_best2(desc_a: torch.Tensor, desc_b: torch.Tensor, allow: torch.Tensor):
    """Masked Hamming best/second per row.

    desc_a [M, 8] or [B, M, 8], desc_b [N, 8] or [B, N, 8] int32,
    allow [M, N] or [B, M, N] bool. CPU tensors -> plain version; CUDA
    tensors -> kernel 3 (or raise)."""
    if allow.device.type == "cpu":
        return masked_best2_plain(desc_a, desc_b, allow)
    name = "masked_best2"
    for t in (desc_a, desc_b):
        kernels.check_dtype(name, t, torch.int32)
    kernels.check_dtype(name, allow, torch.bool)
    batched = allow.dim() == 3
    B = allow.shape[0] if batched else 1
    M, N = allow.shape[-2:]
    if desc_a.shape[-2:] != (M, 8) or desc_b.shape[-2:] != (N, 8):
        raise ValueError(f"{name}: shapes {tuple(desc_a.shape)}, "
                         f"{tuple(desc_b.shape)} vs mask {tuple(allow.shape)}")
    batch_a = int(desc_a.dim() == 3)
    batch_b = int(desc_b.dim() == 3)
    if (batch_a and desc_a.shape[0] != B) or (batch_b and desc_b.shape[0] != B) \
            or (not batched and (batch_a or batch_b)) or N == 0:
        raise ValueError(f"{name}: batch mismatch or empty column set")
    a, b, m = desc_a.contiguous(), desc_b.contiguous(), allow.contiguous()
    dev = kernels.check_cuda(name, a, b, m)
    out = [torch.empty(allow.shape[:-1], dtype=torch.int32, device=dev)
           for _ in range(4)]
    if M > 0:
        kernels.launch("hamming_best2", kernels.ptr(a), kernels.ptr(b),
                       kernels.ptr(m), B, M, N, batch_a, batch_b,
                       *[kernels.ptr(o) for o in out])
    return tuple(out)


__all__ = ["DESC_BITS", "BIG", "popcount32", "to_pm1", "hamming_matrix",
           "hamming_pairwise", "masked_best2", "masked_best2_plain"]
