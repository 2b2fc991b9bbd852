"""Public kernel entry points and launch counters (port of ``repro.kernels.ops``).

``lut_dense`` is the eval LUT-Dense forward with already-rounded bit-width
tensors: kernel B2 on a CUDA tensor, its plain version on a CPU tensor.  The
``autograd.Function`` pairing it with the recompute backward (B3) waits for
the training slice.

``launch_counts`` / ``reset_launch_counts`` read and clear the per-kernel
launch counters, so a run can show that its main path went through the
kernels and not their plain versions.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels import build
from repro_torch.kernels.lut_dense import lut_dense_fused


lut_dense = lut_dense_fused


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(build.LAUNCHES)


def reset_launch_counts() -> None:
    build.reset_launches()
