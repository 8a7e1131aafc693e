"""Metric logging of the trainers (counterpart of
``ldm_tf2_tpu.utils.logging.MetricLogger``): every ``log_per_iterations``
steps, one line with the step, the metrics, steps/s and images/s since the
previous log line, also kept in ``records``.  Reading a metric that lives
on the card waits for the card, so a log line is also where the host meets
the device.  In a data-parallel run every rank keeps the records (of the
global-mean metrics), only rank 0 prints (``verbose``), and images/s counts
the global batch the trainer passes.
"""

from __future__ import annotations

import sys
import time
from typing import Mapping


class MetricLogger:
    def __init__(self, log_per_iterations: int = 100, verbose: bool = True):
        self._every = max(1, log_per_iterations)
        self._verbose = verbose
        self._last_time = time.perf_counter()
        self._last_step: int | None = None
        self.records: list[dict] = []

    def log(self, step: int, metrics: Mapping[str, float],
            batch_size: int | None = None) -> None:
        if step % self._every:
            return
        record = {"step": int(step)}
        record.update({k: float(v) for k, v in metrics.items()})
        now = time.perf_counter()
        record["time"] = now
        if self._last_step is not None and step > self._last_step:
            dt = now - self._last_time
            steps_per_sec = (step - self._last_step) / dt if dt > 0 else 0.0
            record["steps_per_sec"] = steps_per_sec
            if batch_size:
                record["images_per_sec"] = steps_per_sec * batch_size
        self._last_time = now
        self._last_step = int(step)
        self.records.append(record)
        if not self._verbose:
            return
        parts = [f"step {record['step']}"] + [
            f"{k}: {v:.6g}" for k, v in record.items() if k not in ("step", "time")
        ]
        print(" | ".join(parts))
        sys.stdout.flush()
