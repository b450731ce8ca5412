#!/usr/bin/env python3
"""The dense solver of kernels 12 and 18 alone, on seeded systems.

    python3 tools/dense_solve_probe.py [N:CAP ...]   (default 48:48 96:96 306:306
                                                      378:378 357:1792 1792:1792)

For each system of N rows at a capacity of CAP rows (the capacity picks the
panel width, as a caller of that capacity gets it: 32, or 16 past ~1400
rows), a damped J^T J + 1e-3 I with a random right side (numpy, seed 1,
drawn in the order given) goes through `utils/linalg.py dense_solve` (the
cluster kernel, csrc/dense_lu.cuh) and its plain version
`lu_solve_blocked_plain` on the card (pivot rows and x compared, bit for
bit), then is timed beside torch.linalg.solve of the same system: on the
device (torch.profiler, chip_smoke.device_ms) and from the caller (median
of CUDA events around one call). Prints one line per system and, first,
the card's name and power limit. Needs a CUDA card.
"""

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from structure_slam_pointline_tpu_torch.utils import linalg  # noqa: E402

DEFAULT = ("48:48", "96:96", "306:306", "378:378", "357:1792", "1792:1792")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("dense_solve_probe: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    g = np.random.default_rng(1)
    for spec in argv or DEFAULT:
        n, cap = (int(v) for v in spec.split(":"))
        J = g.normal(size=(2 * n, n))
        A = J.T @ J + 1e-3 * np.eye(n)
        Ab = torch.from_numpy(np.concatenate([A, g.normal(size=(n, 1))], 1)
                              .astype(np.float32)).cuda()
        nb = linalg.dense_panel_width(cap)
        xk, pk = linalg.dense_solve(Ab, cap)
        xp, pp = linalg.lu_solve_blocked_plain(Ab, n, nb)
        torch.cuda.synchronize()
        Af, bf = Ab[:, :n].contiguous(), Ab[:, n].contiguous()
        k_dev = chip_smoke.device_ms(lambda: linalg.dense_solve(Ab, cap),
                                     expect="dense_solve_kernel")
        l_dev = chip_smoke.device_ms(lambda: torch.linalg.solve(Af, bf))
        k_call = chip_smoke.time_ms(lambda: linalg.dense_solve(Ab, cap))
        l_call = chip_smoke.time_ms(lambda: torch.linalg.solve(Af, bf))
        print(f"n={n} capacity={cap} panels of {nb}: pivots equal {torch.equal(pk, pp)}, "
              f"x bit-equal {torch.equal(xk, xp)} | device: dense_solve {k_dev:.4f} ms, "
              f"torch.linalg.solve {l_dev:.4f} ms | caller: {k_call:.4f} ms, {l_call:.4f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
