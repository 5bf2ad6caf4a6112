"""Tracing and phase timing (port of fedmse_tpu/utils/profiling.py).

  * `trace(log_dir)`  torch.profiler over the block, CPU and CUDA
                      activities, written to `log_dir` as a Chrome trace
                      (chrome://tracing or Perfetto);
  * `PhaseTimer`      seconds per named phase, accumulated across calls.
                      When enabled it synchronizes the card at the end of
                      each phase, so a phase's seconds include the device
                      work it queued; disabled it is a no-op and the
                      asynchronous queue stays intact.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

from fedmse_tpu_torch.device import DeviceLike


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile everything inside the block; the trace lands in
    `log_dir/trace.json` when the block ends."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimer:
    """Seconds per named phase; `timings()` returns them. `device` is the
    card to synchronize at the end of a phase (None or a CPU device: no
    synchronization)."""

    def __init__(self, enabled: bool = False,
                 device: Optional[DeviceLike] = None):
        self.enabled = enabled
        self.device = None if device is None else torch.device(device)
        self._acc: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._acc[name] += time.perf_counter() - t0

    def timings(self) -> Dict[str, float]:
        return dict(self._acc)

    def reset(self) -> None:
        self._acc.clear()
