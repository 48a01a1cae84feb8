"""The traced slice: `torch.profiler` sessions (CUDA activity only, so
that the host pays little for them) around a short steady slice of the
cell's own work, after the timed window, one session per benchmark span
(the rollout, the update; the entry's steps). Each session starts and
ends on a sync, so every device operation in it belongs to its span, and
its idle time is the span's."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile


@dataclass
class Slice:
    wall_s: float = 0.0                          # the sessions on the host's clock, synced
    busy_s: float = 0.0                          # union of device operations' intervals
    kernels: dict = field(default_factory=dict)  # span -> device kernels run in it
    ops: dict = field(default_factory=dict)      # device op name -> (count, seconds)
    idle: dict = field(default_factory=dict)     # span -> seconds the device sat idle


class Tracer:
    """Profiles what runs between `start(span)` and `stop()`, one session
    at a time, and adds it to `slice`."""

    def __init__(self):
        self.cuda = torch.cuda.is_available()
        self.slice = Slice()

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self, span: str) -> None:
        self._sync()
        self.span = span
        self.prof = profile(activities=[ProfilerActivity.CUDA] if self.cuda
                            else [ProfilerActivity.CPU])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        add(self.slice, self.span, self.prof.profiler.kineto_results.events(), wall)


def add(s: Slice, span: str, events, wall: float) -> None:
    """One session's device operations: kernels, time by op, and the
    union of their intervals."""
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted((e.start_ns(), e.duration_ns(), e.name()) for e in events
                 if e.device_type() == cuda and not e.is_user_annotation())
    end, busy, kernels = None, 0, 0
    for start, dur, name in dev:
        n, sec = s.ops.get(name, (0, 0.0))
        s.ops[name] = (n + 1, sec + dur * 1e-9)
        kernels += not name.startswith(("Memcpy", "Memset"))
        if end is None or start > end:
            busy += dur
            end = start + dur
        elif start + dur > end:
            busy += start + dur - end
            end = start + dur
    s.wall_s += wall
    s.busy_s += busy * 1e-9
    s.kernels[span] = s.kernels.get(span, 0) + kernels
    s.idle[span] = s.idle.get(span, 0.0) + max(wall - busy * 1e-9, 0.0)


def breakdown(s: Slice) -> dict:
    """The device operations that took most time, and the device's idle
    time by the benchmark span it fell in."""
    ops = sorted(((name, sec) for name, (_, sec) in s.ops.items()), key=lambda x: -x[1])[:10]
    idle = sorted(s.idle.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in idle]}
