"""Multi-process orchestration: torch.distributed and meshes across ranks.

Counterpart of structure_slam_pointline_tpu/parallel/distributed.py
(jax.distributed). Every process:

1. calls `initialize_multihost(...)` first: it joins the process group
   (`init_method="tcp://<coordinator_address>"`, rank `process_id` of
   `num_processes`) on this process's device, the card picked by
   `local_device_ids` with the NCCL backend, or the CPU with gloo when
   the caller asks (`device="cpu"`); any other pairing raises;
2. builds `global_edge_mesh(n)`: n landmark shards spread evenly over the
   ranks, on the same axis as the single-process mesh
   (parallel/mesh.py EDGE_AXIS);
3. `SLAMSystem(cfg, mesh=global_edge_mesh())`: the keyframe pipeline's
   local BA and the loop closer's global BA sum their camera systems over
   the group (parallel/dist_ba.py).

Every rank runs the same program (the same calls in the same order), the
reference's multi-controller contract: the collectives inside the BA
must meet. The group is process-wide state (torch.distributed's own);
`shutdown_multihost` leaves it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from structure_slam_pointline_tpu_torch.parallel.mesh import EDGE_AXIS, Mesh, resolve_device

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
_device = None   # the device the joined group reduces on


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None, process_id: int | None = None,
                         local_device_ids: list[int] | None = None, device=None) -> int:
    """Join (rank 0: start) the process group; idempotent; returns this
    process's rank. `coordinator_address` is "host:port" (None: the
    MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE environment);
    `local_device_ids[0]` picks this process's card; `device="cpu"` joins
    with gloo."""
    global _device
    if dist.is_initialized():
        return dist.get_rank()
    if device is None:
        device = torch.device("cuda", local_device_ids[0]) if local_device_ids else None
    dev = resolve_device(device)
    if local_device_ids and (dev.type != "cuda" or dev.index != local_device_ids[0]):
        raise ValueError(f"local_device_ids {local_device_ids} against device {dev}")
    backend = _BACKEND[dev.type]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id))
    _device = dev
    return dist.get_rank()


def global_edge_mesh(n_devices: int | None = None) -> Mesh:
    """A mesh of n landmark shards (default: one per rank) spread evenly over
    the ranks of the joined group, on each rank's device."""
    if not dist.is_initialized():
        raise RuntimeError("global_edge_mesh: call initialize_multihost first")
    world = dist.get_world_size()
    n = n_devices or world
    if n % world:
        raise ValueError(f"{n} shards do not spread evenly over {world} ranks")
    return Mesh(n // world, _device, EDGE_AXIS, group=dist.group.WORLD, world=world,
                rank=dist.get_rank())


def shutdown_multihost() -> None:
    """Leave the process group (call at clean process exit, on every rank):
    a barrier first, so that no rank tears its connections down while
    another still uses them."""
    global _device
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    _device = None


__all__ = ["initialize_multihost", "global_edge_mesh", "shutdown_multihost"]
