"""PyTorch/CUDA port of the point+line SLAM engine, for one NVIDIA H100.

The JAX package `structure_slam_pointline_tpu` is the reference; this
package mirrors its layout (`ops/`, `optim/`, `utils/`, `world/`,
`models/`) so every function has a counterpart of the same name. It
imports `torch` and numpy only, never `jax` or anything of the JAX
package: the host modules it needs (`config.py`, `io/synthetic.py`, the
`Metrics` registry) are copies.

The hot device formulations of the reference are hand-written CUDA C++
kernels for `sm_90a` under `csrc/`, built with `nvcc` at first use into
the git-ignored `build/` directory (`kernels.py`). Each kernel has a plain
PyTorch version beside its wrapper: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises.

Dtype policy: geometry runs in float32 with TF32 switched off for both
matmuls and cuDNN. The reference forces "highest" matmul precision for
the same reason (bf16 geometry lost tracking, ATE 0.27 vs 0.012 on its
synthetic benchmark). Image values flow in bfloat16 from the pyramid on,
as in the reference (ops/extract.py).
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from structure_slam_pointline_tpu_torch.config import SLAMConfig  # noqa: E402,F401
