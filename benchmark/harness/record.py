"""What a run hands the per-layer readers (metrics/<name>.py): the
window's spans and work, and the traced slice."""

from __future__ import annotations

from dataclasses import dataclass, field

from benchmark.harness.trace import Slice


@dataclass
class Record:
    kind: str                      # the traffic's kind: "train" or "eval"
    window_s: float = 0.0          # the timed window, host clock, ended on a sync
    env_steps: int = 0             # env-steps completed in the window
    units: int = 0                 # iterations or entries completed in the window
    spans: dict = field(default_factory=dict)  # span -> seconds of each, in the window
    minibatch_steps: int = 0       # PPO minibatch steps an update takes
    control_steps: int = 0         # control steps an iteration or entry takes
    flops: float = 0.0             # FLOPs of the window, counted from shapes
    peak_flops: float = 0.0        # the chip's peak at the precision the run computes in
    bound_s: float = 0.0           # least time of one control-step launch (roofline)
    slice: Slice | None = None     # the traced slice, with --trace 1
    slice_control_steps: int = 0
    slice_minibatch_steps: int = 0
