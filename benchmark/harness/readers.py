"""The arithmetic the per-layer readers share. A reader returns None
where its run has nothing to read; the harness then leaves the metric
out of the line."""

from __future__ import annotations

from benchmark.harness.record import Record

KERNEL = "control_step_warp"  # the control-step kernels' name in the trace


def kernels_per_step(run: Record, kind: str, span: str, steps_attr: str):
    if run.kind != kind or run.slice is None:
        return None
    steps = getattr(run, steps_attr)
    n = run.slice.kernels.get(span)
    return n / steps if n and steps else None


def roofline(run: Record, kind: str):
    """The control-step kernels' share of their roofline: the least time
    of a launch over the mean device time of the launches in the slice."""
    if run.kind != kind or run.slice is None:
        return None
    hits = [(n, s) for name, (n, s) in run.slice.ops.items() if KERNEL in name]
    count, seconds = sum(n for n, _ in hits), sum(s for _, s in hits)
    if not count or seconds <= 0:
        return None
    return 100.0 * run.bound_s / (seconds / count)


def mfu(run: Record, kind: str):
    if run.kind != kind or run.window_s <= 0 or run.flops <= 0:
        return None
    return 100.0 * run.flops / run.window_s / run.peak_flops


def idle_share(run: Record, kind: str):
    if run.kind != kind or run.slice is None or run.slice.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.wall_s)
