"""Curriculum controllers: fixed levels, adaptive sampling, threshold
sampling, specialist schedule (port of
steppingstone_tpu/runtime/curriculum.py).

Host-side bookkeeping that installs its state on the batched env state
through the VecEnv's fan-outs:

- fixed 6-level curriculum: advance when mean episode reward > bar
  (reference `playground/train.py:115-118,503-506`, bar 1000)
- adaptive sampling: score all 11 x 11 candidate stones with the critic
  ensemble over a deterministic eval rollout, install
  probs = softmax(-scale * normalized V) (`train.py:320-361`)
- threshold sampling: the same grid, probs = softmax(-scale * |V - 0.85|),
  alternating with uniform rounds (`train.py:123-132,224-273,473-482`)
- specialist schedule: save a specialist policy and harden the env each
  time mean reward crosses 1000 (`train.py:119-122,542-549`)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from steppingstone_tpu_torch.envs import terrain as terr
from steppingstone_tpu_torch.envs.stepper import ResetDraws, StepperEnv
from steppingstone_tpu_torch.envs.vector import VecEnv
from steppingstone_tpu_torch.tracing import count as trace_count
from steppingstone_tpu_torch.tracing import span

EVAL_ENVS = 16        # the eval fleet's envs
EVAL_STEPS = 160      # control steps of the eval rollout


class ValueGridDraws(NamedTuple):
    """Random draws of one value-grid evaluation."""

    reset: ResetDraws   # the eval fleet's reset at level 0
    steps: list         # max_steps EnvStepDraws (hits' resampling, auto-resets)


class ValueGrid:
    """The candidate value grid: a deterministic rollout of an eval fleet of
    `n_envs` envs (its own VecEnv over `env`, so each step is one launch of
    the control-step kernel at n_envs) for `max_steps` control steps, reset
    at level 0. At every step all 121 candidate placements of each env's
    next-next stone are scored by the critic ensemble's mean in one batched
    call, and the rows of envs that moved to a new stone that step are
    summed. The reference instead steps one env until 5 hit events
    (`train.py:234-259`); a fleet gives many more events in fewer
    sequential steps. The fleet's draws come from its VecEnv's generator
    unless given."""

    def __init__(self, env: StepperEnv, max_steps: int = EVAL_STEPS, n_envs: int = EVAL_ENVS,
                 seed: int = 0):
        self.venv = VecEnv(env, n_envs, device=env.device, seed=seed)
        self.max_steps = max_steps
        self.last_count = None   # events of the last call

    @torch.no_grad()
    def __call__(self, policy, draws: ValueGridDraws | None = None):
        """(grid (GRID, GRID) normalized by max |grid| (+1e-8), count of
        events (a 0-dim long tensor)). Spans: `curriculum.value_grid` >
        `value_grid.step` (each control step) > `policy`, `env.step`,
        `value_grid.candidates`, `value_grid.critic`,
        `value_grid.accumulate`; counters `value_grid.candidate_rows` (the
        candidate observations of a step) and `value_grid.events`."""
        venv = self.venv
        with span("curriculum.value_grid"):
            cur = terr.default_curriculum(0, batch=venv.num_envs, device=venv.device)
            state, obs = venv.reset(cur, None if draws is None else draws.reset)
            grid = torch.zeros(terr.GRID * terr.GRID, device=venv.device)
            count = torch.zeros((), dtype=torch.long, device=venv.device)
            rows = venv.num_envs * terr.GRID * terr.GRID
            for t in range(self.max_steps):
                with span("value_grid.step"):
                    with span("policy"):
                        action = policy.action_mean(obs)
                    state, out = venv.step(state, action,
                                           None if draws is None else draws.steps[t])
                    with span("value_grid.candidates"):
                        temp = venv.create_temp_states(state)
                    trace_count("value_grid.candidate_rows", rows)
                    with span("value_grid.critic"):
                        vals = policy.ensemble_values(temp).mean(dim=-1)  # (E, 121)
                    with span("value_grid.accumulate"):
                        event = state.update_terrain
                        grid = grid + torch.where(event[:, None], vals, 0.0).sum(dim=0)
                        count = count + event.sum()
                    obs = out.obs
            # normalize like the reference: metric /= max |metric| (train.py:354)
            norm = grid / (grid.abs().max() + 1e-8)
            self.last_count = int(count)
            trace_count("value_grid.events", self.last_count)
        return norm.reshape(terr.GRID, terr.GRID), count


def make_value_grid_fn(env: StepperEnv, max_steps: int = EVAL_STEPS, n_envs: int = EVAL_ENVS,
                       seed: int = 0) -> ValueGrid:
    """The value-grid evaluation of `env`: call it as fn(policy, draws=None)."""
    return ValueGrid(env, max_steps, n_envs, seed)


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


class AdaptiveSampling:
    """Reference adaptive value-based sampling (`train.py:320-361`)."""

    def __init__(self, venv, env: StepperEnv, scale: float = 10.0,
                 value_grid: ValueGrid | None = None):
        self.venv = venv
        self.value_grid = make_value_grid_fn(env) if value_grid is None else value_grid
        self.scale = scale
        self.last_probs = None
        self.last_grid = None   # normalized V-bar grid (instrumentation)

    def pre_update(self, env_state, policy, draws: ValueGridDraws | None = None):
        grid, _ = self.value_grid(policy, draws)
        with span("curriculum.install"):
            probs = torch.softmax(-self.scale * grid.reshape(-1), dim=0).reshape(grid.shape)
            self.last_grid = grid.cpu().numpy()
            self.last_probs = probs.cpu().numpy()
            return self.venv.update_sample_prob(env_state, probs)


class ThresholdSampling:
    """Reference threshold sampling (`train.py:123-132,224-273,473-482`):
    target stones whose normalized value sits near `threshold`, with
    periodic uniform rounds. `scale` is the softmax sharpness (the
    reference's active code hardcodes 10; the config's sampling_scale is
    150)."""

    def __init__(self, venv, env: StepperEnv, threshold: float = 0.85,
                 uniform_every: int = 500000, scale: float = 10.0,
                 value_grid: ValueGrid | None = None):
        self.venv = venv
        self.value_grid = make_value_grid_fn(env) if value_grid is None else value_grid
        self.scale = scale
        self.threshold = threshold
        self.uniform_every = uniform_every
        self.uniform_counter = 1
        self.uniform_sampling = True   # first round is uniform (train.py:125)
        self.last_probs = None
        self.last_grid = None   # normalized V-bar grid (instrumentation)

    def pre_update(self, env_state, policy, assist=None, draws: ValueGridDraws | None = None):
        if self.uniform_sampling:
            # full-range uniform round (train.py:273-274,481): clear the
            # instrumentation so the training loop does not log the previous
            # round's arrays again, and keep the assist ladder's support
            # geometry when one is given
            self.last_probs = None
            self.last_grid = None
            with span("curriculum.install"):
                return self.venv.update_curriculum(env_state, terr.N_LEVELS - 1, assist=assist)
        grid, _ = self.value_grid(policy, draws)
        with span("curriculum.install"):
            probs = torch.softmax(-self.scale * torch.abs(grid.reshape(-1) - self.threshold),
                                  dim=0).reshape(grid.shape)
            self.last_grid = grid.cpu().numpy()
            self.last_probs = probs.cpu().numpy()
            return self.venv.update_sample_prob(env_state, probs)

    def post_test(self):
        """Uniform-round bookkeeping after the test rollout (train.py:473-482)."""
        if self.uniform_counter % self.uniform_every == 0:
            self.uniform_sampling = True
            self.uniform_counter = 0
        else:
            self.uniform_sampling = False
        self.uniform_counter += 1


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
