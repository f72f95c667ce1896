"""Timing.

``cuda_time_ms`` times device work with CUDA events: each run bracketed by
two events on the current stream, one synchronize after the last run, the
median of the per-run times; warm-up runs come first and are not counted.
It has no CPU fallback: a timing is a device number or nothing.

``force`` and ``measure`` are the counterparts of the JAX package's
(``superviseddescent_tpu/utils/timing.py``): a completion fence, and the
steady-state host-clock seconds per call of a function enqueued back to
back. PyTorch's ``torch.cuda.synchronize`` waits for the device, so the
fence needs no data-dependent read-back; ``force`` still returns one
element of the result, as the JAX one does.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, List, Tuple

import torch


def cuda_time_ms(fn: Callable, *args, reps: int = 20, warmup: int = 3,
                 **kwargs) -> Tuple[float, List[float]]:
    """Median milliseconds per call of ``fn(*args, **kwargs)`` on the
    current CUDA device, and every run's time."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn(*args, **kwargs)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn(*args, **kwargs)
        end.record()
    torch.cuda.synchronize()
    times = [start.elapsed_time(end) for start, end in events]
    return statistics.median(times), times


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def force(tree) -> float:
    """Wait until every tensor in ``tree`` (a tensor, or nested lists,
    tuples and dicts of them) is computed: synchronise each CUDA device
    that holds one. Returns the last element of the last non-empty tensor
    as a float, 0.0 when there is none."""
    tensors = list(_tensors(tree))
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    for t in reversed(tensors):
        if t.numel():
            return float(t.reshape(-1)[-1])
    return 0.0


def rtt(device="cuda") -> float:
    """Seconds of one synchronise with no work enqueued."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def measure(fn: Callable, *args, reps: int = 20,
            warmup: int = 1) -> Tuple[float, float]:
    """Steady-state seconds per call of ``fn(*args)`` by the host clock:
    ``reps`` calls enqueued back to back (as in serving), then one fence
    (``force``), less the fence's own time when the result lies on a CUDA
    device. Returns (seconds per call, fence seconds)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    force(out)
    devices = {t.device for t in _tensors(out) if t.device.type == "cuda"}
    fence = sum(rtt(d) for d in devices)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    force(out)
    dt = time.perf_counter() - t0
    return max(dt - fence, 1e-12) / reps, fence
