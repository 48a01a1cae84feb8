"""Generalized Advantage Estimation (port of steppingstone_tpu/agents/gae.py).

The reference recurrence (`algorithms/storage.py:59-71`) as a backward loop
over time, including the `bad_masks` time-limit bootstrapping: on a
timeout boundary the accumulated GAE is zeroed, so return[t] collapses to
V[t]. Shapes use the reference layout: T steps, leading time axis.
"""

from __future__ import annotations

import torch



def compute_gae(
    rewards: torch.Tensor,    # (T, N)
    values: torch.Tensor,     # (T+1, N) V of obs[0..T]
    masks: torch.Tensor,      # (T+1, N) 0 where an episode ended before obs[t]
    bad_masks: torch.Tensor,  # (T+1, N) 0 where that end was a time limit
    gamma: float,
    lam: float,
):
    """Returns (returns (T, N), advantages (T, N)); the advantages are the
    raw `returns - values[:-1]`."""
    T = rewards.shape[0]
    returns = torch.empty_like(rewards)
    gae = torch.zeros_like(rewards[0])
    for t in reversed(range(T)):
        delta = rewards[t] + gamma * values[t + 1] * masks[t + 1] - values[t]
        gae = delta + gamma * lam * masks[t + 1] * gae
        gae = gae * bad_masks[t + 1]
        returns[t] = gae + values[t]
    return returns, returns - values[:-1]


def normalize_advantages(adv: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mean/std normalization (reference `ppo.py:41-42`), with the
    population std: the mean first, then the squared deviations from it
    (two passes)."""
    count = adv.numel()
    mean = adv.sum().reshape(1) / count
    var = torch.square(adv - mean).sum().reshape(1) / count
    return (adv - mean[0]) / (torch.sqrt(var)[0] + eps)
