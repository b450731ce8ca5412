"""float32 elementwise math that rounds as the reference's does on the CPU.

XLA:CPU lowers `jnp.arctan2` to the C library's `atan2f`; glibc's is the
fdlibm algorithm (e_atan2f.c + s_atanf.c), within one ulp of the true
value but not correctly rounded, and torch's own atan2 (vectorized on the
CPU, libdevice on CUDA) differs from it in the last bit on ~16% of
arguments. Gradient-angle bins and alignment gates sit on such bits, so
`atan2_plain` here is glibc's algorithm step for step in float32 torch
ops, the same on every device (csrc/lines.cuh carries the CUDA copy), and
`atan2` is the wrapper of kernel 8 (csrc/atan2.cu, the same function in one
launch): a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises. The plain versions of kernels 5 and 6 call `atan2_plain`
on every device. `hypot` is jnp.hypot's formula. `seq_sum` adds one entry
after another, the order of a kernel thread's running sum, on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from structure_slam_pointline_tpu_torch import kernels


def _f(bits: int) -> float:
    return float(np.array([bits], np.uint32).view(np.float32)[0])


_ATAN_HI = [_f(b) for b in (0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)]
_ATAN_LO = [_f(b) for b in (0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)]
_AT = [_f(b) for b in (0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E,
                       0xBD9D8795, 0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221,
                       0x3C8569D7)]
_PI = _f(0x40490FDB)
_PI_O_2 = _f(0x3FC90FDB)
_PI_LO = _f(0xB3BBBD2E)


def _atanf_nonneg(t: torch.Tensor) -> torch.Tensor:
    """glibc atanf of t >= 0 (finite or +inf)."""
    it = t.view(torch.int32)
    one = torch.ones_like(t)
    ids = [it < 0x3EE00000, it < 0x3F300000, it < 0x3F980000, it < 0x401C0000]
    xr = torch.where(ids[0], t, torch.where(
        ids[1], (2.0 * t - one) / (2.0 + t), torch.where(
            ids[2], (t - one) / (t + one), torch.where(
                ids[3], (t - 1.5) / (one + 1.5 * t), -1.0 / t))))
    z = xr * xr
    w = z * z
    a = _AT
    s1 = z * (a[0] + w * (a[2] + w * (a[4] + w * (a[6] + w * (a[8] + w * a[10])))))
    s2 = w * (a[1] + w * (a[3] + w * (a[5] + w * (a[7] + w * a[9]))))
    xs = xr * (s1 + s2)
    small = xr - xs
    hi = torch.where(ids[1], _ATAN_HI[0], torch.where(
        ids[2], _ATAN_HI[1], torch.where(ids[3], _ATAN_HI[2], _ATAN_HI[3])))
    lo = torch.where(ids[1], _ATAN_LO[0], torch.where(
        ids[2], _ATAN_LO[1], torch.where(ids[3], _ATAN_LO[2], _ATAN_LO[3])))
    big = hi - ((xs - lo) - xr)
    out = torch.where(ids[0], small, big)
    out = torch.where(it < 0x31000000, t, out)                       # |t| < 2^-29
    return torch.where(it >= 0x4C000000, torch.full_like(t, _ATAN_HI[3] + _ATAN_LO[3]), out)


def atan2_plain(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc 2.36 atan2f, bit for bit, on float32 tensors (NaN inputs
    not handled: the callers' arguments are finite)."""
    y, x = torch.broadcast_tensors(y.float(), x.float())
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    neg_y, neg_x = hy < 0, hx < 0
    k = (iy - ix) >> 23
    z = _atanf_nonneg(torch.abs(y / torch.where(ix == 0, torch.ones_like(x), x)))
    z = torch.where(k > 60, torch.full_like(z, _PI_O_2 + 0.5 * _PI_LO), z)
    z = torch.where(neg_x & (k < -60), torch.zeros_like(z), z)
    zpl = z - _PI_LO
    out = torch.where(neg_x, torch.where(neg_y, zpl - _PI, _PI - zpl),
                      torch.where(neg_y, -z, z))
    out = torch.where(ix == 0, torch.where(neg_y, -_PI_O_2, _PI_O_2) * torch.ones_like(z), out)
    at_y0 = torch.where(neg_x, torch.where(neg_y, -_PI, _PI) * torch.ones_like(z), y)
    return torch.where(iy == 0, at_y0, out)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc 2.36 atan2f of float32 tensors (broadcast). CPU tensors ->
    plain version; CUDA tensors -> kernel 8 (or raise)."""
    if y.device.type == "cpu" and x.device.type == "cpu":
        return atan2_plain(y, x)
    name = "atan2_glibc"
    kernels.check_dtype(name, y, torch.float32)
    kernels.check_dtype(name, x, torch.float32)
    y, x = (t.contiguous() for t in torch.broadcast_tensors(y, x))
    kernels.check_cuda(name, y, x)
    out = torch.empty_like(y)
    if out.numel():
        kernels.launch(name, kernels.ptr(y), kernels.ptr(x), out.numel(), kernels.ptr(out))
    return out


def hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """jnp.hypot: max * sqrt(1 + (min / max)^2)."""
    x, y = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    r = torch.where(hi == 0, hi, hi * torch.sqrt(1 + torch.square(lo / safe)))
    return torch.where(torch.isinf(x) | torch.isinf(y), torch.full_like(r, float("inf")), r)


def seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along `dim` one entry after another (torch.sum reduces in
    another order, per device; an ulp there can move a later rounding)."""
    parts = x.unbind(dim)
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s


__all__ = ["atan2", "atan2_plain", "hypot", "seq_sum"]
