"""Shared test helper: a policy pickled in the reference's layout (a whole
module saved with `torch.save`, as `playground/train.py:557` saves it), built
from numpy draws of a seed. Its classes are made under a `common.` module
name for the save and removed from `sys.modules` afterwards, so that, as
with the reference's own files, nothing can import them at load time."""

from __future__ import annotations

import sys
import types

import numpy as np
import torch
from torch import nn

HIDDEN = 256
MODULE = "common.controller"


def _classes():
    class AddBias(nn.Module):
        def __init__(self, action_dim):
            super().__init__()
            self._bias = nn.Parameter(torch.zeros(action_dim, 1))

    class DiagGaussian(nn.Module):
        def __init__(self, action_dim):
            super().__init__()
            self.logstd = AddBias(action_dim)

    class SoftsignActor(nn.Module):
        def __init__(self, obs_dim, action_dim):
            super().__init__()
            dims = [obs_dim] + [HIDDEN] * 5
            for i in range(5):
                setattr(self, f"fc{i + 1}", nn.Linear(dims[i], dims[i + 1]))
            self.out = nn.Linear(HIDDEN, action_dim)

    class Policy(nn.Module):
        def __init__(self, obs_dim, action_dim, n_critics, legacy):
            super().__init__()
            self.actor = SoftsignActor(obs_dim, action_dim)
            dims = [obs_dim] + [HIDDEN] * 4

            def critic():
                layers = []
                for a, b in zip(dims[:-1], dims[1:]):
                    layers += [nn.Linear(a, b), nn.ReLU()]
                return nn.Sequential(*layers, nn.Linear(HIDDEN, 1))

            if legacy:
                self.critic = critic()
            for i in range(0 if legacy else n_critics):
                setattr(self, f"c{i}", critic())
            self.dist = DiagGaussian(action_dim)

    return AddBias, DiagGaussian, SoftsignActor, Policy


def reference_keys(n_critics: int, legacy: bool = False) -> dict:
    """The port's `ActorCritic` state-dict key of each reference key."""
    keys = {"dist.logstd._bias": "logstd"}
    for k, layer in enumerate(("fc1", "fc2", "fc3", "fc4", "fc5", "out")):
        for p in ("weight", "bias"):
            keys[f"actor.{layer}.{p}"] = f"actor.layers.{k}.{p}"
    for i in range(n_critics):
        for k in range(5):
            for p in ("weight", "bias"):
                keys[f"{'critic' if legacy else f'c{i}'}.{2 * k}.{p}"] = f"critics.{i}.layers.{k}.{p}"
    return keys


def write_reference_policy(path, obs_dim: int, action_dim: int, n_critics: int = 1,
                           legacy: bool = False, seed: int = 0, state: dict | None = None) -> dict:
    """Pickle a reference-layout policy with `n_critics` critics `c0..`
    (or, `legacy`, one `critic`) to `path`, its weights drawn from `seed`
    or copied from `state` (a state dict of the port's `ActorCritic`);
    returns its state dict."""
    pkg, mod = types.ModuleType("common"), types.ModuleType(MODULE)
    classes = _classes()
    for cls in classes:
        cls.__module__, cls.__qualname__ = MODULE, cls.__name__
        setattr(mod, cls.__name__, cls)
    policy = classes[-1](obs_dim, action_dim, n_critics, legacy)
    rng = np.random.default_rng(seed)
    keys = reference_keys(n_critics, legacy)
    with torch.no_grad():
        for name, p in policy.named_parameters():
            if state is not None:
                p.copy_(state[keys[name]].reshape(p.shape))
                continue
            scale = 0.3 if name.startswith("dist") else 1.0 / np.sqrt(p.shape[-1])
            p.copy_(torch.as_tensor(rng.normal(0.0, scale, p.shape).astype(np.float32)))
        if state is None:
            policy.dist.logstd._bias -= 1.5
    sys.modules["common"], sys.modules[MODULE] = pkg, mod
    try:
        torch.save(policy, path)
    finally:
        del sys.modules[MODULE], sys.modules["common"]
    return {k: v.detach().clone() for k, v in policy.state_dict().items()}
