"""P4: ``2 * x`` with each (S, S) tile written as one flat S*S row.

Replaces the probe kernel of ``scripts/probe_flatout.py``: (N, S, S) float32
tiles -> (N, S*S) float32 rows, ``out[n, r*S + c] = 2 * x[n, r, c]``. The
TPU probe asked whether its compiler lowers the (S, S) -> (1, S*S) reshape
inside a kernel at all; on this card the tile and the flat row are the same
bytes, so the kernel (``csrc/probe_flatout.cu``) is one pass of ``2 * x``
over the N*S*S floats, two 16-byte loads and stores a thread, with scalar
elements before the input's first 16-byte boundary and after the last whole
word. Bound by memory: 2 * N * S * S * 4
bytes. The plain twin is ``2 * x`` reshaped.
"""

from __future__ import annotations

import ctypes

import torch

_MAX_SIZE = 96


def probe_flatout_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the P4 kernel on any device."""
    return (x * 2.0).reshape(x.shape[0], -1)


def probe_flatout(x: torch.Tensor) -> torch.Tensor:
    """(N, S, S) float32 -> (N, S*S) float32, every value doubled. A CPU
    tensor takes the plain twin; a CUDA tensor launches the kernel."""
    if x.ndim != 3 or x.shape[1] != x.shape[2] or x.dtype != torch.float32:
        raise ValueError("x must be (N, S, S) float32")
    n, s, _ = x.shape
    if not 1 <= s <= _MAX_SIZE:
        raise ValueError(f"S must be 1..{_MAX_SIZE}, got {s}")
    if x.device.type == "cpu":
        return probe_flatout_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    from superviseddescent_tpu_torch.ops._build import load_library
    lib = load_library("probe_flatout")
    out = torch.empty((n, s * s), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    err = lib.probe_flatout_launch(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()), n, s,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(
            f"probe_flatout kernel launch failed: CUDA error {err}")
    probe_flatout.launches += 1
    return out


probe_flatout.launches = 0
