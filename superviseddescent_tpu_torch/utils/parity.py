"""The float64 parity mode.

Counterpart of ``superviseddescent_tpu/utils/parity.py``. A float32
cascade amplifies last-ulp differences between two implementations; run in
float64 on the CPU, both agree to ~1e-7, so any larger difference is a
semantic bug. In PyTorch every operation keeps its inputs' type, so the
core (``core/``), the solvers (``ops/solver.py``) and the cascade keep
float64 rows, features and weights in float64 throughout; this mode makes
float64 the type of tensors created without one, and the CPU the default
device.
"""

from __future__ import annotations

import torch


def enable_f64(platform: str = "cpu") -> None:
    """Switch this process into the float64 mode: new floating tensors
    default to float64 and, with ``platform``, to that device. Pass
    float64 inputs (and ``device="cpu"`` to the entry points that take a
    device)."""
    torch.set_default_dtype(torch.float64)
    if platform:
        torch.set_default_device(platform)
