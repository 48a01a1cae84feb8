"""Spans and counters inside the port, on the profiler's clock.

    from steppingstone_tpu_torch import tracing

    with tracing.span("env.step"):
        ...

Off by default: `span(name)` then costs one flag check and returns the
shared `NULL_SPAN`, and `count(name)` returns at once. The recorder is
switched on only through its API, `RECORDER.start()`, and off by
`RECORDER.stop()`, which returns `(spans, counters)`. No environment
variable or config key turns it on.

While on, each span keeps its name, its parent (an index into the list),
the index of the call it belongs to (each top-level name counts its own
calls from `start()`; children share their top-level span's), its start
and end, the host syncs made inside it and no child, and the counters
`count` added inside it. Spans hold no tensors and never synchronize the
device. Host syncs are counted through PyTorch's sync debug mode, set to
"warn" while on: each warning is counted, put down to the innermost open
span and to its source line (`syncs@<file>:<line>` in the counters), and
swallowed; other warnings pass as before.

Stamps are taken with `time.perf_counter_ns` and converted at `stop()` to
the clock of `torch.profiler`'s events (nanoseconds since the Unix epoch),
by offsets read at `start()` and at `stop()`, so that a device interval of
a profile taken over the same calls can be put down to the span open over
it (`attribute_idle`).

The layer boundaries the port marks (PERF.md, section 3): `trainer.rollout`
> `rollout.step` > `policy`, `env.step` > `env.reset`, `physics.entry` >
`physics.launch`; `trainer.rollout` > `rollout.gae`; `trainer.update` >
`ppo.minibatch` > `ppo.forward`, `ppo.backward`, `ppo.optimizer`;
`eval.entry` > `eval.reset`, `eval.step` (> `policy`, `env.step`),
`eval.records`; `trainer.curriculum` > `curriculum.value_grid` >
`value_grid.step` (> `policy`, `env.step`, `value_grid.candidates`,
`value_grid.critic`, `value_grid.accumulate`), `curriculum.install`;
`collective.<kind>` wherever a collective runs.

The CUDA graphs (on a card, in one process for the update): a replayed
minibatch step is one `ppo.minibatch` span with no child, a replayed env
step one `env.step` span whose `env.reset`, `physics.entry` and
`physics.launch` are recorded only in the eager warm-up and at the capture
(`ppo.graph.capture`, `env.graph.capture`); the counters
`ppo.graph.captures`, `ppo.graph.replays`, `env.graph.captures` and
`env.graph.replays` count the captures and replays.
"""

from __future__ import annotations

import json
import os
import re
import time
import warnings
from array import array
from dataclasses import dataclass, field

import torch

SYNC_MESSAGE = "called a synchronizing CUDA operation"  # PyTorch's sync debug warning
_PACKAGE = os.path.dirname(os.path.abspath(__file__))


class _NullSpan:
    """What `span` returns while the recorder is off: enters and exits
    doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):  # named: `*exc` would build a tuple a call
        return False


NULL_SPAN = _NullSpan()


@dataclass(eq=False)
class Span:
    """One recorded span, as `RECORDER.stop()` returns it: stamps in
    nanoseconds on the profiler's clock."""

    name: str
    index: int = -1           # its place in the recording's list
    parent: int = -1          # index of the enclosing span in the list, -1 at the top
    call: int = 0             # index of the top-level span's call among its name's
    t0: int = 0
    t1: int = 0
    syncs: int = 0            # host syncs inside this span and no child of it
    counts: dict = field(default_factory=dict)  # counters added inside it and no child


def _epoch_offset() -> int:
    """time.time_ns() - time.perf_counter_ns(), read between two perf
    stamps as close together as three tries give."""
    best = None
    for _ in range(3):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def _site(filename: str, lineno: int) -> str:
    path = os.path.abspath(filename)
    if path.startswith(_PACKAGE + os.sep):
        path = os.path.relpath(path, _PACKAGE)
    else:
        path = os.path.basename(path)
    return f"{path}:{lineno}"


class Recorder:
    """The process's span and counter recorder (one: `RECORDER`). While on
    it is itself the context manager `span` returns, and keeps the spans in
    flat arrays of ints, so that a span allocates no object the garbage
    collector tracks (a process holding many objects would pay a collection
    for every few hundred); `stop()` makes the `Span`s."""

    def __init__(self):
        self.on = False
        self._next = None  # the name `span` hands to the `__enter__` that follows

    def start(self) -> None:
        if self.on:
            raise RuntimeError("the span recorder is already on")
        self._names, self._stack, self._calls = [], [], {}
        self._parent, self._call, self._t0, self._t1, self._syncs = (
            array("q") for _ in range(5))
        self._counts, self.counters = {}, {}
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
        self._show = warnings.showwarning
        warnings.showwarning = self._on_warning
        self._sync_mode = None
        if torch.cuda.is_available():
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        self._anchor = (time.perf_counter_ns(), _epoch_offset())
        self.on = True

    def stop(self) -> tuple[list, dict]:
        """Ends the recording (any span still open ends now) and returns
        (the spans in the order they were entered, the counters)."""
        if not self.on:
            raise RuntimeError("the span recorder is off")
        now = time.perf_counter_ns()
        for i in self._stack:
            self._t1[i] = now
        self.on = False
        if self._sync_mode is not None:
            torch.cuda.set_sync_debug_mode(self._sync_mode)
        self._warnings.__exit__(None, None, None)
        # the perf clock to the profiler's, the offset drawn linearly between
        # its readings at start and stop
        (p0, off0), (p1, off1) = self._anchor, (now, _epoch_offset())
        slope = (off1 - off0) / max(p1 - p0, 1)

        def epoch(t):
            return t + off0 + round(slope * (t - p0))

        spans = [Span(name, i, self._parent[i], self._call[i], epoch(self._t0[i]),
                      epoch(self._t1[i]), self._syncs[i], self._counts.get(i, {}))
                 for i, name in enumerate(self._names)]
        counters = self.counters
        self._names, self._stack, self._counts, self.counters = [], [], {}, {}
        return spans, counters

    def __enter__(self):
        name, i = self._next, len(self._names)
        if self._stack:
            parent = self._stack[-1]
            call = self._call[parent]
        else:
            parent, call = -1, self._calls.get(name, 0)
            self._calls[name] = call + 1
        self._names.append(name)
        self._parent.append(parent)
        self._call.append(call)
        self._t1.append(0)
        self._syncs.append(0)
        self._stack.append(i)
        self._t0.append(time.perf_counter_ns())
        return self

    def __exit__(self, exc_type, exc, tb):
        self._t1[self._stack.pop()] = time.perf_counter_ns()
        return False

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n
        if self._stack:
            counts = self._counts.setdefault(self._stack[-1], {})
            counts[name] = counts.get(name, 0) + n

    def _on_warning(self, message, category, filename, lineno, file=None, line=None):
        if not str(message).startswith(SYNC_MESSAGE):
            return self._show(message, category, filename, lineno, file, line)
        self.counters["syncs"] = self.counters.get("syncs", 0) + 1
        site = f"syncs@{_site(filename, lineno)}"
        self.counters[site] = self.counters.get(site, 0) + 1
        if self._stack:
            self._syncs[self._stack[-1]] += 1


RECORDER = Recorder()


def span(name: str):
    """A span named `name` over the `with` block it opens at once (`with
    span(name):`); the shared NULL_SPAN while the recorder is off."""
    if RECORDER.on:
        RECORDER._next = name
        return RECORDER
    return NULL_SPAN


def count(name: str, n: int = 1) -> None:
    """Adds `n` to counter `name` (and to the innermost open span's) while
    the recorder is on."""
    if RECORDER.on:
        RECORDER.count(name, n)


# ----------------------------------------------------------------------
# the arithmetic over a recording
# ----------------------------------------------------------------------

def paths(spans: list) -> list:
    """Each span's path from its top-level span, names joined by "/"."""
    out = []
    for s in spans:
        out.append(s.name if s.parent < 0 else f"{out[s.parent]}/{s.name}")
    return out


def segments(spans: list) -> list:
    """The recording's time cut into (start, end, i) pieces, in order: in
    each, span i is the innermost span open. Time outside every span is in
    no piece."""
    out, stack, cursor = [], [], 0

    def close_until(t):
        nonlocal cursor
        while stack and spans[stack[-1]].t1 <= t:
            j = stack.pop()
            if spans[j].t1 > cursor:
                out.append((cursor, spans[j].t1, j))
            cursor = max(cursor, spans[j].t1)

    for i, s in enumerate(spans):
        close_until(s.t0)
        if stack and s.t0 > cursor:
            out.append((cursor, s.t0, stack[-1]))
        cursor = max(cursor, s.t0) if stack else s.t0
        stack.append(i)
    close_until(float("inf"))
    return out


def self_ns(spans: list) -> list:
    """Each span's self time: its duration less what its children cover."""
    out = [0] * len(spans)
    for a, b, i in segments(spans):
        out[i] += b - a
    return out


def totals(spans: list) -> dict:
    """By path: n (spans), ns (summed durations), self_ns, and syncs (inside
    the span and its children)."""
    ps, own = paths(spans), self_ns(spans)
    syncs = [s.syncs for s in spans]
    for i in range(len(spans) - 1, 0, -1):  # children come after their parents
        if spans[i].parent >= 0:
            syncs[spans[i].parent] += syncs[i]
    out = {}
    for i, s in enumerate(spans):
        t = out.setdefault(ps[i], dict(n=0, ns=0, self_ns=0, syncs=0))
        t["n"] += 1
        t["ns"] += s.t1 - s.t0
        t["self_ns"] += own[i]
        t["syncs"] += syncs[i]
    return out


def idle_intervals(busy: list, lo: int, hi: int) -> list:
    """The (start, end) stretches of [lo, hi) that no interval of `busy`
    ((start, end) pairs, any order, overlapping or not) covers."""
    out, cursor = [], lo
    for a, b in sorted(busy):
        if a > cursor:
            out.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]


def attribute_idle(spans: list, busy: list, lo: int, hi: int) -> dict:
    """The device's idle time in [lo, hi) (ns, on the spans' clock), by
    the path of the innermost span open over it; "-" holds what fell
    outside every span. `busy` holds the device operations' (start, end)."""
    ps = paths(spans)
    out = {}
    pieces = segments(spans)
    k = 0
    for a, b in idle_intervals(busy, lo, hi):
        covered = 0
        while k < len(pieces) and pieces[k][1] <= a:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < b:
            s, e, i = pieces[j]
            part = min(b, e) - max(a, s)
            if part > 0:
                out[ps[i]] = out.get(ps[i], 0) + part
                covered += part
            j += 1
        if b - a > covered:
            out["-"] = out.get("-", 0) + (b - a - covered)
    return out


def innermost(spans: list, times: list) -> list:
    """The index of the innermost span open at each of `times` (sorted),
    or -1 outside every span."""
    pieces = segments(spans)
    out, k = [], 0
    for t in times:
        while k < len(pieces) and pieces[k][1] <= t:
            k += 1
        out.append(pieces[k][2] if k < len(pieces) and pieces[k][0] <= t else -1)
    return out


def add_to_chrome_trace(path: str, spans: list, track: str = "program spans") -> None:
    """Writes `spans` into the Chrome trace that `torch.profiler` exported
    at `path`, as a process of their own named `track`, on the trace's
    clock (its `baseTimeNanoseconds`, where it has one)."""
    with open(path) as f:
        text = f.read()
    base = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', text)
    base = int(base.group(1)) if base else 0
    key = re.search(r'"traceEvents"\s*:\s*\[', text)
    if key is None:
        raise ValueError(f"{path}: no traceEvents list")
    ps = paths(spans)
    events = [dict(ph="M", name="process_name", pid=track, tid=0, args=dict(name=track))]
    for p, s in zip(ps, spans):
        args = dict(path=p, call=s.call, syncs=s.syncs, **s.counts)
        events.append(dict(ph="X", cat="program", name=s.name, pid=track, tid=0,
                           ts=(s.t0 - base) / 1e3, dur=(s.t1 - s.t0) / 1e3, args=args))
    rest = text[key.end():]
    sep = "," if rest.lstrip()[:1] not in ("]", "") else ""
    with open(path, "w") as f:
        f.write(text[:key.end()] + ",".join(json.dumps(e) for e in events) + sep + rest)
