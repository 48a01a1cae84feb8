"""Policy / value networks (port of steppingstone_tpu/agents/networks.py).

- actor: obs -> 256 x5 -> act, softsign x3 + relu x2 + tanh out,
  torch-default (fan-in uniform) init
- critic: obs -> 256 x4 -> 1, relu, orthogonal(sqrt 2) weights, zero bias;
  an ensemble `c0..cN` whose mean is the value
- a state-independent diagonal Gaussian with a learned logstd, init -1.5;
  the helpers below clamp and project it in place
"""

from __future__ import annotations

import math
import torch
from torch import nn
from torch.nn import functional as F


HIDDEN = 256
LOGSTD_MIN = -3.0  # exploration floor applied by `clamped_logstd`


def _mlp(dims, generator, orthogonal: bool) -> nn.ModuleList:
    layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
    with torch.no_grad():
        for layer in layers:
            if orthogonal:
                nn.init.orthogonal_(layer.weight, gain=math.sqrt(2.0), generator=generator)
                nn.init.zeros_(layer.bias)
            else:
                bound = 1.0 / math.sqrt(layer.in_features)
                nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
                nn.init.uniform_(layer.bias, -bound, bound, generator=generator)
    return layers


class SoftsignActor(nn.Module):
    """6-layer 256-wide MLP: softsign x3, relu x2, tanh out."""

    def __init__(self, obs_dim: int, action_dim: int, generator=None):
        super().__init__()
        self.layers = _mlp([obs_dim] + [HIDDEN] * 5 + [action_dim], generator, False)

    def forward(self, x):
        for i, layer in enumerate(self.layers[:-1]):
            x = F.softsign(layer(x)) if i < 3 else F.relu(layer(x))
        return torch.tanh(self.layers[-1](x))


class Critic(nn.Module):
    """5-layer 256-wide relu MLP -> 1."""

    def __init__(self, obs_dim: int, generator=None):
        super().__init__()
        self.layers = _mlp([obs_dim] + [HIDDEN] * 4 + [1], generator, True)

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


class ActorCritic(nn.Module):
    """Actor + critic ensemble + state-independent logstd, built on
    `device` (None means the card)."""

    def __init__(self, obs_dim: int, action_dim: int, num_ensembles: int = 1,
                 logstd_init: float = -1.5, device=None, generator=None):
        super().__init__()
        self.actor = SoftsignActor(obs_dim, action_dim, generator)
        self.critics = nn.ModuleList(Critic(obs_dim, generator) for _ in range(num_ensembles))
        self.logstd = nn.Parameter(torch.full((action_dim,), logstd_init))
        self.to(torch.device("cpu" if device is None else device))

    def forward(self, obs):
        """(mean, logstd, value)."""
        return self.action_mean(obs), self.logstd, self.value(obs)

    def action_mean(self, obs):
        return self.actor(obs)

    def ensemble_values(self, obs):
        """(..., num_ensembles)."""
        return torch.cat([c(obs) for c in self.critics], dim=-1)

    def value(self, obs):
        """(..., 1) ensemble mean."""
        return torch.mean(self.ensemble_values(obs), dim=-1, keepdim=True)


def clamped_logstd(policy: ActorCritic) -> torch.Tensor:
    """logstd floored at LOGSTD_MIN in value, with the gradient passed
    straight through (so a parameter below the floor can still recover)."""
    raw = policy.logstd
    return raw + (torch.clamp(raw, min=LOGSTD_MIN) - raw).detach()


@torch.no_grad()
def project_logstd(policy: ActorCritic) -> ActorCritic:
    """Clip the raw logstd parameter to >= LOGSTD_MIN in place (after each
    optimizer step, so it cannot sink arbitrarily far while clamped)."""
    policy.logstd.clamp_(min=LOGSTD_MIN)
    return policy


