"""Tracing and timing (port of ``factorized_tpu/utils/profiling.py``).

- ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA where a card is present) that writes one Chrome
  trace, ``<logdir>/<host>_<pid>.<ms>.pt.trace.json``, which TensorBoard
  (the PyTorch profiler plugin) or ``chrome://tracing`` opens. The
  hand-written kernels appear under their own names; a CUDA graph's
  replay shows its kernels as well.
- ``Throughput``: steps a second over ``start``/``stop`` intervals.
- ``time_fn``: the median seconds of a call.

Both time with CUDA events on a card and with the host clock on the CPU,
and wait for the device once a reading.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class _Clock:
    """An interval's seconds: CUDA events on a card (the device's time
    from the first mark to the second), the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def seconds(self, start, end) -> float:
        if not self.cuda:
            return end - start
        end.synchronize()
        return start.elapsed_time(end) / 1e3


class Throughput:
    """Accumulates the seconds of ``start()``..``stop(steps)`` intervals
    and their steps; ``steps_per_sec``. On a card ``stop`` waits for the
    work queued before it."""

    def __init__(self, device="cuda"):
        self.clock = _Clock(device)
        self.steps = 0
        self.seconds = 0.0
        self._t0 = None

    def start(self):
        self._t0 = self.clock.mark()

    def stop(self, steps: int):
        self.seconds += self.clock.seconds(self._t0, self.clock.mark())
        self.steps += steps

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.seconds if self.seconds else 0.0


def time_fn(fn: Callable, *args, reps: int = 5, warmup: int = 1,
            device="cuda") -> float:
    """The median seconds of ``fn(*args)`` over ``reps`` calls after
    ``warmup`` untimed ones, each call waited for."""
    clock = _Clock(device)
    for _ in range(warmup):
        t0 = clock.mark()
        fn(*args)
        clock.seconds(t0, clock.mark())
    times = []
    for _ in range(reps):
        t0 = clock.mark()
        fn(*args)
        times.append(clock.seconds(t0, clock.mark()))
    return float(np.median(times))
