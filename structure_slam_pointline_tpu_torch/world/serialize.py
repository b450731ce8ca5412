"""Map checkpoint / resume: the whole SoA map in one .npz.

Counterpart of structure_slam_pointline_tpu/world/serialize.py, in its
file layout: one `f_<field>` array per MapState field and `__cursors__`,
int64 [n_kf, n_mp, n_ml]. Descriptor and observer-bit words are written
as uint32 (the numpy view convert.py uses), so a map saved by either
package loads in the other with equal arrays.
"""

from __future__ import annotations

import numpy as np

from structure_slam_pointline_tpu_torch import convert
from structure_slam_pointline_tpu_torch.world.map_store import MapCursors, MapState


def save_map(path: str, state: MapState, cursors: MapCursors) -> None:
    """One device -> host copy per field, then np.savez_compressed."""
    arrays = {f"f_{k}": v for k, v in convert.map_state_to_numpy(state).items()}
    np.savez_compressed(
        path, __cursors__=np.asarray([cursors.n_kf, cursors.n_mp, cursors.n_ml], np.int64),
        **arrays)


def load_map(path: str, device) -> tuple[MapState, MapCursors]:
    """(MapState on `device`, MapCursors)."""
    with np.load(path) as data:
        cur = data["__cursors__"]
        fields = {name: data[f"f_{name}"] for name in MapState._fields}
    return (convert.map_state_from_numpy(fields, device),
            MapCursors(n_kf=int(cur[0]), n_mp=int(cur[1]), n_ml=int(cur[2])))


__all__ = ["save_map", "load_map"]
