"""The port's one timing helper.

Device time comes from CUDA events recorded on the current stream; host
wall time (``EngineResult.shuffle_seconds``/``gradient_seconds``, probe
timings on the CPU) comes from :class:`Stopwatch`, and timestamps (a
served query's submit and completion) from :func:`now`: the package's
host clock for intervals, an obs span's start and end included. Callers
wait for the device (``sync``) before they read, because PyTorch returns
before the card finishes. Two more clocks serve ``repro_torch.obs``:
:func:`wall`, the calendar time stamped on a snapshot or an incident, and
:func:`monotonic`, the SLO monitor's cadence.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def sync(device: torch.device) -> None:
    """Wait for every queued kernel on ``device`` (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    """Host clock in seconds (a timestamp: differences of two are wall
    time; it waits for nothing)."""
    return time.perf_counter_ns() * 1e-9


def wall() -> float:
    """Calendar time in seconds since the epoch (a record's timestamp)."""
    return time.time()


def monotonic() -> float:
    """A clock that never steps back, in seconds (a cadence's clock)."""
    return time.monotonic()


class Stopwatch:
    """Host wall clock in seconds: ``lap()`` returns the time since the
    previous lap (or since construction)."""

    def __init__(self):
        self._t = time.perf_counter_ns()

    def lap(self) -> float:
        now = time.perf_counter_ns()
        dt, self._t = (now - self._t) * 1e-9, now
        return dt


def seconds(fn: Callable[[], object], device: torch.device) -> float:
    """Elapsed seconds of one call of ``fn``: CUDA events around it on a
    card (device time, which includes the gaps where the card waits for
    the host to launch), the host clock after a sync on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3
    watch = Stopwatch()
    fn()
    return watch.lap()
