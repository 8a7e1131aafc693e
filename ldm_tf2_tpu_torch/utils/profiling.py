"""Profiling for the port: ``torch.profiler`` traces and timing that waits
for the card (counterpart of ``ldm_tf2_tpu.utils.profiling``).

``trace(logdir)`` records the host and, where CUDA is present, the device,
and writes a Chrome trace (``trace.json``, for Perfetto or
chrome://tracing) into ``logdir``; ``Timer`` and ``Timer.time_fn`` time
wall clock with ``torch.cuda.synchronize()`` where the JAX package calls
``block_until_ready``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; the trace goes to ``logdir/trace.json``
    when the block ends.  Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timer:
    """Wall-clock timer that waits for the card's queued work at both
    ends."""

    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.elapsed = time.perf_counter() - self._t0

    @staticmethod
    def time_fn(fn, *args, iters: int = 3, warmup: int = 1):
        """Median wall time of fn(*args), each call waited for."""
        for _ in range(warmup):
            fn(*args)
            _sync()
        times = []
        for _ in range(iters):
            _sync()
            t0 = time.perf_counter()
            fn(*args)
            _sync()
            times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2]
