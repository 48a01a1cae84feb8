"""Diagonal Gaussian policy distribution (port of
steppingstone_tpu/agents/distributions.py): log-probs sum over the action
axis (keepdim), entropy sums over the action axis, mode = mean."""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def sample(mean, logstd, generator: torch.Generator | None = None,
           noise: torch.Tensor | None = None):
    """mean + exp(logstd) * noise; `noise` (standard normals shaped like
    mean) is drawn from `generator` unless given."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                            device=mean.device)
    return mean + torch.exp(logstd) * noise


def log_prob(mean, logstd, actions):
    var = torch.exp(2.0 * logstd)
    lp = -0.5 * ((actions - mean) ** 2 / var + 2.0 * logstd + LOG_2PI)
    return torch.sum(lp, dim=-1, keepdim=True)


def entropy(logstd):
    return torch.sum(logstd + 0.5 * (LOG_2PI + 1.0), dim=-1)


def mode(mean):
    return mean
