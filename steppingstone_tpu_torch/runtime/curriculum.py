"""Curriculum controllers: the fixed levels and the specialist schedule
(port of steppingstone_tpu/runtime/curriculum.py `FixedCurriculum` and
`SpecialistSchedule`; the value-based `AdaptiveSampling` and
`ThresholdSampling` are ROADMAP item 12).

Host-side bookkeeping that installs its state on the batched env state
through the VecEnv's fan-outs:

- fixed 6-level curriculum: advance when mean episode reward > bar
  (reference `playground/train.py:115-118,503-506`, bar 1000)
- specialist schedule: save a specialist policy and harden the env each
  time mean reward crosses 1000 (`train.py:119-122,542-549`)
"""

from __future__ import annotations


class FixedCurriculum:
    """Reference fixed 6-level curriculum (`train.py:115-118,503-506`),
    with an optional refinement: instead of stepping the level at once,
    the installed level ramps linearly from the old to the new integer
    level over `ramp_updates` updates (ramp_updates=0 reproduces the
    reference's step change).

    The advance RULE is unchanged: target level += 1 when mean episode
    reward > bar, at most to 5, and never while a ramp is in flight.

    assist_only=True turns this into the grid-mode ASSIST ladder: install
    and tick touch only the support-geometry assist (venv.update_assist)."""

    def __init__(self, venv, ramp_updates: int = 0, assist_only: bool = False,
                 bar: float = 1000.0):
        self.venv = venv
        self.level = 0            # integer target level
        self.frac = 0.0           # currently installed (possibly fractional)
        self.ramp_updates = max(int(ramp_updates), 0)
        self.assist_only = assist_only
        self.bar = float(bar)

    def install(self, env_state):
        if self.assist_only:
            return self.venv.update_assist(env_state, self.frac)
        return self.venv.update_curriculum(env_state, self.frac)

    def tick(self, env_state):
        """Per-update ramp step toward the target level."""
        if self.frac < self.level:
            step = 1.0 / self.ramp_updates if self.ramp_updates else float("inf")
            self.frac = min(self.frac + step, float(self.level))
            env_state = self.install(env_state)
        return env_state

    def post_update(self, env_state, mean_rew: float):
        """Returns (env_state, advanced): advanced is True on the update
        where the target level increments (the training loop re-inflates
        exploration noise then)."""
        if mean_rew > self.bar and self.level <= 4 and self.frac >= self.level:
            self.level += 1
            print("assist" if self.assist_only else "curriculum", self.level, flush=True)
            return self.tick(env_state), True
        return env_state, False


class SpecialistSchedule:
    """Reference specialist curriculum (`train.py:119-122,542-549`)."""

    def __init__(self, venv):
        self.venv = venv
        self.specialist = 0

    def install(self, env_state):
        return self.venv.update_specialist(env_state, self.specialist)

    def post_update(self, env_state, mean_rew: float, save_fn=None):
        if mean_rew > 1000 and self.specialist <= 4:
            if save_fn is not None:
                save_fn(self.specialist)
            self.specialist += 1
            env_state = self.venv.update_specialist(env_state, self.specialist)
        return env_state
