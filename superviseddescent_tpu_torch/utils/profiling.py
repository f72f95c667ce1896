"""Profiling and observability.

Counterpart of ``superviseddescent_tpu/utils/profiling.py``. The
reference prints wall times per solver stage and per tracked frame; here:

  * ``timed``: wall time of one call, synchronised on the device of its
    result (CUDA work is asynchronous, so a host clock without the
    synchronise measures the enqueue);
  * ``trace``: a ``torch.profiler`` session that writes a Chrome trace;
  * ``enable_nan_checks``: after each cascade level, ``train`` and ``test``
    check that the level's rows are finite and raise ``FloatingPointError``
    naming the level. JAX's ``jax_debug_nans`` stops at the first operation
    that makes a NaN; PyTorch has no such switch for forward code, so the
    port checks the rows at the level boundary, at one device
    synchronisation per level while it is on;
  * ``LevelTimer``: a per-level callback for ``train`` / ``test`` that
    records each level's wall time.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

from superviseddescent_tpu_torch.core import cascade
from superviseddescent_tpu_torch.utils.timing import force


def timed(fn, *args, label: str = "", stream=sys.stderr, **kwargs):
    """Run ``fn(*args, **kwargs)``, print its wall time in ms, synchronised
    on its result's device, and return the result."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    force(out)
    dt = (time.perf_counter() - t0) * 1000.0
    print(f"[timed] {label or getattr(fn, '__name__', 'fn')}: {dt:.2f} ms",
          file=stream, flush=True)
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA where there is a card) and write a
    Chrome trace to ``log_dir/trace.json`` (open it in Perfetto or
    chrome://tracing). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_nan_checks(enable: bool = True) -> None:
    """Switch the per-level finiteness check of every cascade in this
    process on or off (like ``jax_debug_nans``, a process-wide switch)."""
    cascade.set_nan_checks(enable)


class LevelTimer:
    """``on_training_epoch_callback`` / ``on_regressor_iteration_callback``
    that records each level's wall time in ``times_ms``, synchronised on
    the rows' device (the time from its creation, then from the previous
    level), and prints it unless ``verbose=False``."""

    def __init__(self, stream=sys.stderr, verbose: bool = True):
        self._last = time.perf_counter()
        self.times_ms = []
        self.stream = stream
        self.verbose = verbose

    def __call__(self, current_x):
        force(current_x)
        now = time.perf_counter()
        self.times_ms.append((now - self._last) * 1000.0)
        self._last = now
        if self.verbose:
            print(f"[level {len(self.times_ms) - 1}] "
                  f"{self.times_ms[-1]:.1f} ms", file=self.stream,
                  flush=True)
