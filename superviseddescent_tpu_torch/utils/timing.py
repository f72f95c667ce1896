"""Device timing with CUDA events.

Each run is bracketed by two events on the current stream; after the last
run one synchronize, then the median of the per-run times. Warm-up runs
come first and are not counted. There is no CPU fallback: a timing is a
device number or nothing.
"""

from __future__ import annotations

import statistics
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
