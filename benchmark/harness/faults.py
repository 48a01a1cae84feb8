"""Faults planted in the port underneath a run, to show that the check
sees them (benchmark/tests) and to read them at a cell's own size on the
card (benchmark/control.py). Each is a context manager that patches the
port and restores it.

- "unchanged_update": the PPO update returns the state it was given.
- "half_batch": each minibatch's first half stands for it (that half
  twice over: the mean over the rest).
- "unchanged_step": the env step returns the state it was given.
- "altered": one env step's answers altered where they are produced
  (every env's reward + 1, on one call in each `every`).
- "obs_after_step": the rollout's batch stores each step's observation
  after the step in place of the one the step acted on."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _update_patch(wrap):
    from steppingstone_tpu_torch.runtime import train as port_train
    return _patched(port_train, "ppo_update", wrap(port_train.ppo_update))


def unchanged_update():
    def wrap(original):
        def update(policy, opt_state, cfg, batch, lr, **kw):
            before = [p.detach().clone() for p in policy.parameters()]
            _, metrics = original(policy, opt_state, cfg, batch, lr, **kw)
            with torch.no_grad():
                for p, b in zip(policy.parameters(), before):
                    p.copy_(b)
            return opt_state, metrics
        return update
    return _update_patch(wrap)


def half_batch():
    def wrap(original):
        def update(policy, opt_state, cfg, batch, lr, perms=None, **kw):
            mbs = perms.shape[1] // cfg.num_mini_batch
            half = perms.view(perms.shape[0], cfg.num_mini_batch, mbs)[..., :mbs // 2]
            perms = torch.cat([half, half], dim=-1).reshape(perms.shape[0], -1)
            return original(policy, opt_state, cfg, batch, lr, perms=perms, **kw)
        return update
    return _update_patch(wrap)


def _step_patch(kind: str, every: int):
    from steppingstone_tpu_torch.envs.vector import VecEnv
    original, calls = VecEnv.step, [0]

    def step(self, state, actions, draws=None):
        new_state, out = original(self, state, actions, draws)
        calls[0] += 1
        if kind == "unchanged":
            return state, out
        if calls[0] % every == 3 % every:
            out = out._replace(reward=out.reward + 1.0)
        return new_state, out
    return _patched(VecEnv, "step", step)


def unchanged_step(every: int = 0):
    return _step_patch("unchanged", 1)


def altered(every: int):
    return _step_patch("altered", every)


def obs_after_step():
    from steppingstone_tpu_torch.runtime.train import Trainer
    original = Trainer.rollout

    def rollout(self, *args, **kw):
        env_state, obs, stats, batch, aux = original(self, *args, **kw)
        n = obs.shape[0]
        batch = dict(batch, obs=torch.cat([batch["obs"][n:], obs]))
        return env_state, obs, stats, batch, aux
    return _patched(Trainer, "rollout", rollout)


FAULTS = {"unchanged_update": lambda every: unchanged_update(),
          "half_batch": lambda every: half_batch(),
          "unchanged_step": unchanged_step, "altered": altered,
          "obs_after_step": lambda every: obs_after_step()}
TRAIN = ("unchanged_update", "half_batch", "unchanged_step", "altered", "obs_after_step")
EVAL = ("unchanged_step", "altered")
