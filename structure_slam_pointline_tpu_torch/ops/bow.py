"""Bag-of-binary-words place recognition: vocabulary tree and scoring
(kernels 13 and 14).

Counterpart of structure_slam_pointline_tpu/ops/bow.py. The vocabulary
is trained on the host from the map's own descriptors (binary k-medians,
bit-majority centres): `Vocabulary`, `_kmedians_binary` and
`train_vocabulary` are numpy copies of the reference's (`:36`, `:52`,
`:74`), so the same descriptors give the same centres bit for bit. The
centres stay uint32 numpy on the host; the card sees one int32 view of
all levels' nodes concatenated (`Vocabulary.nodes`).

`transform` is the wrapper of CUDA kernel 13 (csrc/bow.cu,
`bow_transform`), which replaces the reference's `_transform_impl`
(:104) and `transform` (:118): the first-index argmin descent through
the tree, invalid descriptors as word -1 and out of the histogram, and
the word counts divided by their total. It takes [N, 8] or batched
[B, N, 8] descriptors. `query_database` is the wrapper of kernel 14
(`bow_query`), which replaces `l1_score` / `query_database` (:129-144):
s = 1 - 0.5 * sum_w |q_w - b_kw| per keyframe row, masked by `kf_valid`,
`exclude` and `min_score`. A CPU tensor takes the plain version
(`transform_plain`, `query_database_plain`); a CUDA tensor launches the
kernel or raises.

Numerics: word counts are integers below 2^24, so the histogram and its
total are exact in any order and `counts / total` is one IEEE division:
the words and the BoW vectors equal the reference's bit for bit. The L1
sum of the plain version runs in the kernel's order (256 running sums
over strided words, then a halving tree), so kernel and plain agree
exactly; against XLA's own order they differ in the last bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.ops import hamming
from structure_slam_pointline_tpu_torch.utils.fmath import seq_sum

QUERY_THREADS = 256   # kernel 14's block: running sums per thread, then a tree


@dataclasses.dataclass(eq=False)
class Vocabulary:
    """Level-major binary vocabulary tree.

    centers[lvl] has shape [B^lvl, B, 8] (uint32): the B children of each
    level-lvl node. Leaves are words, ids in [0, B^depth)."""

    centers: tuple
    branching: int
    depth: int
    _nodes: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_words(self) -> int:
        return self.branching ** self.depth

    def nodes(self, device) -> torch.Tensor:
        """All levels' node rows concatenated, [sum_l B^l, B, 8] int32 on
        `device` (level l starts at row (B^l - 1) / (B - 1)); cached."""
        device = torch.device(device)
        key = str(device)
        if key not in self._nodes:
            cat = np.concatenate([np.asarray(c, np.uint32) for c in self.centers])
            self._nodes[key] = torch.from_numpy(cat.view(np.int32).copy()).to(device)
        return self._nodes[key]


def _kmedians_binary(descs: np.ndarray, k: int, iters: int = 8, seed: int = 0) -> np.ndarray:
    """Binary k-medians: cluster 256-bit descriptors, centers by bit-majority."""
    g = np.random.default_rng(seed)
    n = len(descs)
    if n == 0:
        return np.zeros((k, 8), np.uint32)
    centers = descs[g.choice(n, size=min(k, n), replace=False)]
    if len(centers) < k:
        centers = np.concatenate([centers, g.integers(0, 2 ** 32, (k - len(centers), 8),
                                                      dtype=np.uint32)])
    bits = np.unpackbits(descs.view(np.uint8), axis=1)  # [n, 256]
    for _ in range(iters):
        cbits = np.unpackbits(centers.view(np.uint8), axis=1)
        d = (bits[:, None, :] != cbits[None, :, :]).sum(axis=2)
        assign = d.argmin(axis=1)
        for c in range(k):
            sel = bits[assign == c]
            if len(sel) > 0:
                maj = (sel.mean(axis=0) >= 0.5).astype(np.uint8)
                centers[c] = np.packbits(maj).view(np.uint32)
    return centers.astype(np.uint32)


def train_vocabulary(descs: np.ndarray, branching: int = 8, depth: int = 4,
                     seed: int = 0, max_train: int = 30000) -> Vocabulary:
    """Hierarchical binary k-medians (DBoW2 build recipe, host-side).
    `descs` are uint32 words (a view of the port's int32 descriptors)."""
    g = np.random.default_rng(seed)
    descs = np.asarray(descs, np.uint32).reshape(-1, 8)
    if len(descs) > max_train:
        descs = descs[g.choice(len(descs), max_train, replace=False)]
    levels = []
    groups = [descs]
    for lvl in range(depth):
        centers_lvl = np.zeros((len(groups), branching, 8), np.uint32)
        next_groups = []
        for gi, gdesc in enumerate(groups):
            c = _kmedians_binary(gdesc, branching, seed=seed + lvl * 131 + gi)
            centers_lvl[gi] = c
            if len(gdesc) > 0:
                bits = np.unpackbits(gdesc.view(np.uint8), axis=1)
                cbits = np.unpackbits(c.view(np.uint8), axis=1)
                d = (bits[:, None, :] != cbits[None, :, :]).sum(axis=2)
                assign = d.argmin(axis=1)
            else:
                assign = np.zeros(0, int)
            for b in range(branching):
                next_groups.append(gdesc[assign == b] if len(gdesc) else gdesc)
        levels.append(centers_lvl)
        groups = next_groups
    return Vocabulary(centers=tuple(levels), branching=branching, depth=depth)


def transform_plain(nodes: torch.Tensor, desc: torch.Tensor, valid: torch.Tensor,
                    branching: int, depth: int):
    """(words [..., N] int32, -1 where invalid; bow [..., W] float32):
    the reference's descent (first-index argmin per level) and its
    histogram divided by the clamped total."""
    W = branching ** depth
    node = torch.zeros(desc.shape[:-1], dtype=torch.long, device=desc.device)
    off = 0
    for lvl in range(depth):
        cen = nodes[off + node]                                   # [..., N, B, 8]
        d = hamming.hamming_pairwise(desc[..., None, :], cen)     # [..., N, B]
        node = node * branching + torch.argmin(d, dim=-1)
        off += branching ** lvl
    words = torch.where(valid, node, -1).to(torch.int32)
    slot = torch.where(words >= 0, words.long(), W)
    counts = torch.zeros(desc.shape[:-2] + (W + 1,), dtype=torch.float32, device=desc.device)
    counts = counts.scatter_add(-1, slot, torch.ones_like(slot, dtype=torch.float32))[..., :W]
    total = torch.clamp(counts.sum(-1, keepdim=True), min=1e-9)
    return words, counts / total


def transform(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor):
    """Descriptors [N, 8] or [B, N, 8] int32, valid [..., N] bool ->
    (word ids [..., N] int32 (-1 invalid), bow [..., W] L1-normalized).
    CPU tensors -> plain version; CUDA tensors -> kernel 13 (or raise)."""
    nodes = voc.nodes(desc.device)
    if desc.device.type == "cpu":
        return transform_plain(nodes, desc, valid, voc.branching, voc.depth)
    name = "bow_transform"
    kernels.check_dtype(name, desc, torch.int32)
    kernels.check_dtype(name, valid, torch.bool)
    if desc.shape[-1] != 8 or valid.shape != desc.shape[:-1] or desc.dim() not in (2, 3):
        raise ValueError(f"{name}: shapes {tuple(desc.shape)} / {tuple(valid.shape)}")
    d, v = desc.contiguous(), valid.contiguous()
    dev = kernels.check_cuda(name, d, v, nodes)
    B = desc.shape[0] if desc.dim() == 3 else 1
    N = desc.shape[-2]
    W = voc.n_words
    words = torch.empty(desc.shape[:-1], dtype=torch.int32, device=dev)
    bow_vec = torch.empty(desc.shape[:-2] + (W,), dtype=torch.float32, device=dev)
    kernels.launch("bow_transform", kernels.ptr(nodes), voc.branching, voc.depth,
                   kernels.ptr(d), kernels.ptr(v), B, N, kernels.ptr(words),
                   kernels.ptr(bow_vec))
    return words, bow_vec


def _masks(s, kf_valid, min_score, exclude):
    neg = torch.full((), -1.0, device=s.device)
    s = torch.where(kf_valid, s, neg)
    if exclude is not None:
        s = torch.where(exclude, neg, s)
    return torch.where(s >= min_score, s, neg)


def query_database_plain(bow_q, kf_bows, kf_valid, min_score: float = 0.0, exclude=None):
    """Scores [K], the L1 sums taken in kernel 14's order: thread t of a
    row's block adds words t, t + 256, ... one after another, then a
    halving tree adds the 256 partial sums."""
    K, W = kf_bows.shape
    T = QUERY_THREADS
    d = torch.abs(bow_q[None, :] - kf_bows)
    pad = (-W) % T
    if pad:
        d = torch.cat([d, torch.zeros((K, pad), dtype=d.dtype, device=d.device)], 1)
    x = seq_sum(d.reshape(K, -1, T), 1)
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return _masks(1.0 - 0.5 * x[:, 0], kf_valid, min_score, exclude)


def query_database(bow_q: torch.Tensor, kf_bows: torch.Tensor, kf_valid: torch.Tensor,
                   min_score: float = 0.0, exclude: torch.Tensor | None = None):
    """Score a query [W] against all keyframe rows [K, W]; returns scores
    [K] with invalid / excluded / below-min rows set to -1. Candidate
    retention (>= 0.75 * best) is the caller's policy (reference
    KeyFrameDatabase.cc:159-181). CPU tensors -> plain version; CUDA
    tensors -> kernel 14 (or raise)."""
    if kf_bows.device.type == "cpu":
        return query_database_plain(bow_q, kf_bows, kf_valid, min_score, exclude)
    name = "bow_query"
    for t in (bow_q, kf_bows):
        kernels.check_dtype(name, t, torch.float32)
    kernels.check_dtype(name, kf_valid, torch.bool)
    K, W = kf_bows.shape
    if bow_q.shape != (W,) or kf_valid.shape != (K,):
        raise ValueError(f"{name}: shapes {tuple(bow_q.shape)}, {tuple(kf_bows.shape)}, "
                         f"{tuple(kf_valid.shape)}")
    excl = (torch.zeros_like(kf_valid) if exclude is None else exclude).contiguous()
    kernels.check_dtype(name, excl, torch.bool)
    ins = [bow_q.contiguous(), kf_bows.contiguous(), kf_valid.contiguous(), excl]
    dev = kernels.check_cuda(name, *ins)
    out = torch.empty((K,), dtype=torch.float32, device=dev)
    if K:
        kernels.launch("bow_query", *[kernels.ptr(t) for t in ins], K, W,
                       float(min_score), kernels.ptr(out))
    return out


__all__ = ["Vocabulary", "train_vocabulary", "transform", "transform_plain",
           "query_database", "query_database_plain", "QUERY_THREADS"]
