"""The reference's drivers: a training iteration's rollout and batch (the
plain counterpart of the port's `collect_rollout` and
`Trainer.rollout`), a behavior-evaluation entry (of `evaluate_entry`),
and the teacher-forced step the check runs over many recorded steps at
once."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import distributions as dist
from .gae import compute_gae, normalize_advantages
from .networks import ActorCritic, clamped_logstd

RECORDS = ("reward", "hit", "done", "timeout", "ep_return", "ep_len", "ns_pre")


class PolicyOut(NamedTuple):
    action: torch.Tensor    # (N, A)
    log_prob: torch.Tensor  # (N, 1)
    value: torch.Tensor     # (N, 1)


@torch.no_grad()
def act(policy: ActorCritic, obs, noise=None) -> PolicyOut:
    """The action (the mean where `noise` is None, else mean + std x
    noise), its log-prob and the ensemble's mean value."""
    mean = policy.action_mean(obs)
    logstd = clamped_logstd(policy).expand_as(mean)
    action = mean if noise is None else dist.sample(mean, logstd, None, noise)
    return PolicyOut(action, dist.log_prob(mean, logstd, action), policy.value(obs))


def make_batch(obs, out: PolicyOut, reward, done, timeout, last_value, gamma: float,
               lam: float) -> dict:
    """A PPO batch from T steps of N envs: obs (T, N, D), the policy's
    outputs (T, N, .), rewards and end flags (T, N), the bootstrap value
    (N, 1); GAE with time-limit bad_masks, normalized advantages."""
    T, N = reward.shape
    masks = 1.0 - done.to(torch.float32)
    bad_masks = 1.0 - timeout.to(torch.float32)
    values = torch.cat([out.value[..., 0], last_value.T], dim=0)
    ones = torch.ones_like(masks[:1])
    returns, adv = compute_gae(reward, values, torch.cat([ones, masks]),
                               torch.cat([ones, bad_masks]), gamma, lam)
    adv = normalize_advantages(adv)
    flat = lambda x: x.reshape(T * N, *x.shape[2:])
    return dict(obs=flat(obs), actions=flat(out.action), log_probs=flat(out.log_prob),
                values=flat(out.value), returns=flat(returns[..., None]),
                adv=flat(adv[..., None]))


@torch.no_grad()
def rollout(env, policy: ActorCritic, state, obs, noise, draws: list, gamma: float,
            lam: float):
    """T control steps of the fleet, free-running, then the batch. Returns
    (state, obs, batch, rewards (T, N))."""
    rows = []
    for t, d in enumerate(draws):
        out = act(policy, obs, noise[t])
        state, step = env.step(state, out.action, draws=d)
        rows.append((obs, out, step.reward, step.done, step.timeout))
        obs = step.obs
    obs_t = torch.stack([r[0] for r in rows])
    outs = PolicyOut(*(torch.stack(x) for x in zip(*(r[1] for r in rows))))
    reward, done, timeout = (torch.stack([r[i] for r in rows]) for i in (2, 3, 4))
    last = policy.value(obs)
    return state, obs, make_batch(obs_t, outs, reward, done, timeout, last, gamma, lam), reward


@torch.no_grad()
def evaluate_entry(env, policy: ActorCritic, cur, steps: int, reset_draws, step_draws):
    """Reset the fleet with `cur`, then `steps` steps of the mean action;
    ({name: (T, N) host array} for each of RECORDS, final state).
    `step_draws` is called before each step with the done flags of the
    step before (None before the first)."""
    state, obs = env.reset(cur, draws=reset_draws)
    rows, done = [], None
    for _ in range(steps):
        ns_pre = state.next_step_index.clone()
        state, out = env.step(state, policy.action_mean(obs), draws=step_draws(done))
        obs, done = out.obs, out.done
        rows.append((out.reward, out.hit, out.done, out.timeout, out.ep_return, out.ep_len,
                     ns_pre))
    cols = [torch.stack(c).cpu().numpy() for c in zip(*rows)]
    return dict(zip(RECORDS, cols)), state
