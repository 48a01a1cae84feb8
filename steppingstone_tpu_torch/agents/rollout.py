"""Rollout collection (port of steppingstone_tpu/agents/rollout.py).

A Python loop over control steps: policy forward, env step (one launch of
kernel K1 on the card), storage insert, each step a `rollout.step` span
(tracing.py) holding a `policy` span and the env's `env.step`. Episode
bookkeeping keeps a per-env "last completed episode" slot.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from steppingstone_tpu_torch.agents import distributions as dist
from steppingstone_tpu_torch.agents.networks import ActorCritic, clamped_logstd
from steppingstone_tpu_torch.tracing import span


class Transition(NamedTuple):
    """Rollout storage, leading axes (T, N)."""

    obs: torch.Tensor        # (T, N, D) obs at t (input to the policy)
    actions: torch.Tensor    # (T, N, A)
    log_probs: torch.Tensor  # (T, N, 1)
    values: torch.Tensor     # (T, N, 1)
    rewards: torch.Tensor    # (T, N)
    masks: torch.Tensor      # (T, N) 0 if the episode ended at t+1
    bad_masks: torch.Tensor  # (T, N) 0 if that end was a time limit


class EpisodeStats(NamedTuple):
    """Per-env last-completed-episode slots."""

    ret: torch.Tensor     # (N,) return of the most recent completed episode
    length: torch.Tensor  # (N,)
    valid: torch.Tensor   # (N,) bool: the env has completed >= 1 episode

    @staticmethod
    def init(n: int, device=None) -> "EpisodeStats":
        return EpisodeStats(
            ret=torch.zeros(n, device=device),
            length=torch.zeros(n, dtype=torch.long, device=device),
            valid=torch.zeros(n, dtype=torch.bool, device=device),
        )

    def update(self, done, ep_return, ep_len) -> "EpisodeStats":
        return EpisodeStats(
            ret=torch.where(done, ep_return, self.ret),
            length=torch.where(done, ep_len, self.length),
            valid=self.valid | done,
        )


def policy_action(policy: ActorCritic, obs, deterministic: bool,
                  generator: torch.Generator | None = None, noise=None):
    """(action, log_prob); `noise` (N, A) replaces the generator's draw."""
    mean = policy.action_mean(obs)
    logstd = clamped_logstd(policy).expand_as(mean)
    if deterministic:
        action = mean
    else:
        action = dist.sample(mean, logstd, generator, noise)
    return action, dist.log_prob(mean, logstd, action)


@torch.no_grad()
def collect_rollout(venv, policy: ActorCritic, env_state, obs, stats: EpisodeStats,
                    num_steps: int, deterministic: bool = False,
                    action_noise=None, env_draws=None):
    """Run T control steps. Returns
    (env_state, last_obs, stats, Transition stacked over T, aux).

    Randomness comes from `venv.generator`, drawn at the global batch of
    `venv.mesh` and cut to this rank's rows; `action_noise` (T, N, A) and
    `env_draws` (a length-T sequence of EnvStepDraws), this rank's rows,
    replace its draws."""
    mesh = venv.mesh
    rows = []
    for t in range(num_steps):
        with span("rollout.step"):
            if action_noise is not None:
                noise = action_noise[t]
            elif deterministic:
                noise = None
            else:
                noise = mesh.local(torch.randn((mesh.world * obs.shape[0], venv.action_dim),
                                               generator=venv.generator, device=obs.device))
            with span("policy"):
                action, log_p = policy_action(policy, obs, deterministic, venv.generator, noise)
                value = policy.value(obs)
            env_state, out = venv.step(env_state, action,
                                       None if env_draws is None else env_draws[t])
            stats = stats.update(out.done, out.ep_return, out.ep_len)
            rows.append((
                Transition(obs=obs, actions=action, log_probs=log_p, values=value,
                           rewards=out.reward, masks=1.0 - out.done.to(torch.float32),
                           bad_masks=1.0 - out.timeout.to(torch.float32)),
                out.hit, out.done, out.ep_return, out.ep_len,
            ))
            obs = out.obs
    traj = Transition(*(torch.stack(x) for x in zip(*(r[0] for r in rows))))
    hits, ep_done, ep_return, ep_len = (torch.stack(x) for x in zip(*(r[1:] for r in rows)))
    aux = dict(hits=hits.sum(), ep_done=ep_done, ep_return=ep_return, ep_len=ep_len)
    return env_state, obs, stats, traj, aux


def evaluate(venv, policy: ActorCritic, env_state, obs, num_steps: int):
    """Deterministic test-fleet rollout: stats over the episodes that
    completed within `num_steps`."""
    stats = EpisodeStats.init(obs.shape[0], obs.device)
    env_state, obs, stats, _, _ = collect_rollout(
        venv, policy, env_state, obs, stats, num_steps, deterministic=True)
    return env_state, obs, stats
