"""What every kind of traffic shares: the run's context, the count of
control-step launches, the work counts of a window, and the loading of a
kind's driver by name.

A traffic mix (traffic/<traffic>.json) names its `kind`; the kind's
driver is kinds/<kind>.py, whose `run(ctx)` drives set-up, the timed
window, the traced slice and the check, and returns an `Outcome`."""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field

import torch

from benchmark.harness import counts, tree
from benchmark.harness.record import Record


class Context:
    """What a run is given: the cell, its seed and window, whether to
    trace, the device, the system to drive (None: the port) and the
    clock's start (process start)."""

    def __init__(self, cell, seed: int, seconds: float, trace_on: bool, device, t0: float,
                 make_system=None):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace_on
        self.device, self.t0, self.make_system = torch.device(device), t0, make_system
        self.config, self.traffic, self.limits = cell.config, cell.traffic, cell.limits
        self.port = make_system is None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclass
class Outcome:
    """What a kind's driver hands back to run.py."""
    record: Record                 # for the per-layer readers
    setup_s: float
    memory_peak_bytes: int
    attempted: int                 # iterations or entries in the window
    failed: int                    # of those, the ones whose outputs are not finite
    numbers: dict                  # the numbers compared, by name (limits/<cell>.json)
    end_to_end: dict               # end-to-end metric -> value, reported as given
    detail: dict = field(default_factory=dict)


def driver(kind: str):
    """kinds/<kind>.py's `run(ctx) -> Outcome`."""
    return importlib.import_module(f"benchmark.kinds.{kind}").run


def launches():
    from steppingstone_tpu_torch.physics.step_kernel import CONTROL_STEP
    return dict(CONTROL_STEP.launches)


def check_launches(ctx: Context, before: dict, control_steps: int) -> None:
    """The port on the card launches the cell's variant once per control
    step and nothing else (on the CPU it runs the plain step: no launch)."""
    if not ctx.port:
        return
    after = launches()
    got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    want = {ctx.config["variant"]: control_steps} if ctx.device.type == "cuda" else {}
    if got != want:
        raise RuntimeError(f"control-step launches {got}, expected {want}")


def bound_s(config: dict, env, n_envs: int) -> tuple:
    """(least seconds of one launch at `n_envs`, FLOPs an env's control step needs)."""
    model = env.cfg.model
    pd = env.cfg.actuation == "pd"
    hy = env.cfg.plank_hy if env.cfg.support == "plank" else None
    flops = counts.control_step_flops(model, env.cfg.n_stones, config["substeps"], pd, hy,
                                      rot=model.joint_rot is not None)
    nbytes = counts.control_step_bytes(model, env.cfg.n_stones, pd)
    return max(flops * n_envs / counts.PEAK_FP32, nbytes * n_envs / counts.PEAK_BYTES), flops


def peak_flops() -> float:
    """fp32 outside the tensor cores, unless a TF32 flag is on."""
    tf32 = torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
    return counts.PEAK_TF32 if tf32 else counts.PEAK_FP32


def lr_at(config: dict, update: int) -> float:
    """The learning rate of the run's `update`-th update (from 0): the
    reference trainer's exponential decay (train.py:213-220)."""
    if config["lr_decay_type"] != "exponential":
        raise ValueError(f"lr_decay_type {config['lr_decay_type']!r}")
    return max(config["lr"] * config["lr_decay_rate"] ** update, config["lr_final"])


def host(x):
    return tree.to(x, "cpu")
