"""Meshes of shards on this process's device, and across processes.

Counterpart of structure_slam_pointline_tpu/parallel/mesh.py. A JAX mesh
lists devices and XLA runs one program per device; a torch process drives
one device, so the port's `Mesh` is `n_local` shards of work on this
process's device (the card unless the caller asks for the CPU) times the
ranks of a joined `torch.distributed` group (parallel/distributed.py):
its size is n_local x world. Shard g is local shard g - rank x n_local of
rank g // n_local. On the card every local shard has its own CUDA stream;
the engines that take a mesh (optim/local_ba.py `bundle_adjust_sharded`
through parallel/dist_ba.py, parallel/batch_frontend.py) give each shard
its own workspace and run it on that stream.

`psum` and `any` are the mesh's reductions: the local shards' partials
summed (ORed) in shard order, then `all_reduce`d over the group when it
has more than one rank (NCCL on the card, gloo on the CPU). The ranks of
a group get the same sum, so replicated work stays identical on every
rank. A mesh of one shard is the unsharded case: the systems that take a
mesh run their single-device engines on it.
"""

from __future__ import annotations

import torch

EDGE_AXIS = "edge"


def resolve_device(device=None) -> torch.device:
    """None -> this process's CUDA device (raises without one: a CUDA mesh
    never falls back to the CPU); "cpu" only when the caller asks."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device; pass device='cpu' to shard "
                               "on the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"meshes run on CUDA or the CPU, not {dev}")
    return dev


class Mesh:
    """`n_local` shards on `device`, times the `world` ranks of `group`
    (None: this process alone)."""

    def __init__(self, n_local: int, device=None, axis: str = EDGE_AXIS, group=None,
                 world: int = 1, rank: int = 0):
        if n_local < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n_local}")
        self.n_local, self.axis, self.group = int(n_local), axis, group
        self.world, self.rank = int(world), int(rank)
        self.device = resolve_device(device)
        self.streams = ([torch.cuda.Stream(self.device) for _ in range(self.n_local)]
                        if self.device.type == "cuda" else [None] * self.n_local)

    @property
    def size(self) -> int:
        return self.n_local * self.world

    @property
    def local_shards(self) -> range:
        """Mesh indices of this process's shards."""
        return range(self.rank * self.n_local, (self.rank + 1) * self.n_local)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the group in place (no-op for one rank)."""
        if self.world > 1:
            import torch.distributed as dist

            dist.all_reduce(t, group=self.group)
        return t

    def psum(self, parts: list) -> torch.Tensor:
        """Sum of one partial per local shard, in shard order, then over
        the group."""
        acc = parts[0].clone()
        for p in parts[1:]:
            acc = acc + p
        return self.all_reduce(acc)

    def any(self, parts: list) -> torch.Tensor:
        """OR of one boolean tensor per local shard, then over the group (an
        integer sum > 0, as the reference's psum of int flags)."""
        acc = parts[0].clone()
        for p in parts[1:]:
            acc = acc | p
        if self.world == 1:
            return acc
        return self.all_reduce(acc.to(torch.int32)) > 0

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """Every rank's `block` (one shape on all ranks), concatenated in rank
        order along the first axis."""
        if self.world == 1:
            return block
        import torch.distributed as dist

        out = [torch.empty_like(block) for _ in range(self.world)]
        dist.all_gather(out, block.contiguous(), group=self.group)
        return torch.cat(out)

    def __repr__(self) -> str:
        return (f"Mesh({self.axis}: {self.n_local} shards on {self.device} x {self.world} "
                f"ranks, rank {self.rank})")


def edge_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A mesh of `n_devices` landmark shards (default one) on this process's
    device alone, on the distributed-BA axis: on one H100, edge_mesh(4) is
    four shards on cuda:0."""
    return Mesh(n_devices or 1, device, EDGE_AXIS)


__all__ = ["EDGE_AXIS", "Mesh", "edge_mesh", "resolve_device"]
