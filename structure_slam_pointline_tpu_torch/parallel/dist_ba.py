"""Distributed bundle adjustment over a mesh of landmark shards.

Counterpart of structure_slam_pointline_tpu/parallel/dist_ba.py. One
engine, as in the reference: local BA's schedule (optim/local_ba.py) with
the landmark axis split over the mesh (parallel/mesh.py). Cameras and
edge tables are replicated; each shard owns the landmarks (and map-line
endpoints) of its column range, so their 3x3 blocks, inverses and
back-substitution stay on the shard; only the camera side (the Schur
product, the gradient, the camera blocks, the cost) is summed over the
shards, then over the process group, before one replicated solve.

`shard_bundle_adjust` pads the landmark axes to a multiple of the mesh
size (padded landmarks are invalid and add nothing), runs this process's
shards (`local_ba.bundle_adjust_sharded`: kernel 12's sharded form on
the card, its plain version on the CPU), gathers every rank's landmark
block into every rank's result and slices the padding off. A mesh of one
shard runs the unsharded engine (`local_ba.bundle_adjust`), as the
reference's callers do for one device.
"""

from __future__ import annotations

import torch.nn.functional as F

from structure_slam_pointline_tpu_torch.config import OptimConfig
from structure_slam_pointline_tpu_torch.optim import local_ba
from structure_slam_pointline_tpu_torch.optim.local_ba import BALineProblem, BAProblem, BAResult
from structure_slam_pointline_tpu_torch.parallel.mesh import EDGE_AXIS, Mesh
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics


def _pad_landmarks(prob: BAProblem, n: int) -> BAProblem:
    """Pad the landmark axis so it divides the mesh size."""
    pad = (-prob.mp_xyz.shape[0]) % n
    if pad == 0:
        return prob
    return prob._replace(mp_xyz=F.pad(prob.mp_xyz, (0, 0, 0, pad)),
                         mp_valid=F.pad(prob.mp_valid, (0, pad)))


def _pad_lines(lines: BALineProblem, n: int) -> BALineProblem:
    pad = (-lines.ln_start.shape[0]) % n
    if pad == 0:
        return lines
    return lines._replace(ln_start=F.pad(lines.ln_start, (0, 0, 0, pad)),
                          ln_end=F.pad(lines.ln_end, (0, 0, 0, pad)),
                          ln_valid=F.pad(lines.ln_valid, (0, pad)))


def _gather_block(mesh: Mesh, full, n_cols: int):
    """Every rank's optimized column block of `full` ([n_cols, 3], padded),
    in rank order."""
    per_rank = n_cols // mesh.world
    return mesh.gather(full[mesh.rank * per_rank:(mesh.rank + 1) * per_rank])


def shard_bundle_adjust(mesh: Mesh, prob: BAProblem, intr: Intrinsics, cfg: OptimConfig,
                        lines: BALineProblem | None = None) -> BAResult:
    """BA with the landmarks sharded over `mesh`'s shards; every rank passes
    the same problem and gets the same whole result."""
    if mesh.size == 1:
        return local_ba.bundle_adjust(prob, intr, cfg, lines=lines)
    PL = prob.mp_xyz.shape[0]
    prob = _pad_landmarks(prob, mesh.size)
    if lines is not None:
        LL = lines.ln_start.shape[0]
        lines = _pad_lines(lines, mesh.size)
    out = local_ba.bundle_adjust_sharded(prob, intr, cfg, lines, mesh)
    out = out._replace(mp_xyz=_gather_block(mesh, out.mp_xyz, prob.mp_xyz.shape[0])[:PL])
    if lines is None:
        return out
    n_ln = lines.ln_start.shape[0]
    return out._replace(ln_start=_gather_block(mesh, out.ln_start, n_ln)[:LL],
                        ln_end=_gather_block(mesh, out.ln_end, n_ln)[:LL])


def make_dist_ba(mesh: Mesh, intr: Intrinsics, cfg: OptimConfig, n_iters: int | None = None):
    """fn(prob [, lines]) -> BAResult of `shard_bundle_adjust` on `mesh`.
    `n_iters` is accepted and ignored, as in the reference: the schedule
    comes from cfg (local_ba_iters_first + the cut + local_ba_iters_second),
    the single-device engine's."""

    def run(prob: BAProblem, lines: BALineProblem | None = None) -> BAResult:
        return shard_bundle_adjust(mesh, prob, intr, cfg, lines=lines)

    return run


__all__ = ["make_dist_ba", "shard_bundle_adjust", "EDGE_AXIS"]
