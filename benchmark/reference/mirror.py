"""Mirror-symmetry batch augmentation (port of
steppingstone_tpu/agents/mirror.py).

The reference's `get_mirror_function` (`common/envs_utils.py:687-740`):
negate the sign-flipping indices, swap the left/right index blocks, and
stack the mirrored copies onto the minibatch (observations and actions
mirrored; everything else repeated).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class MirrorSpec(NamedTuple):
    neg_obs: np.ndarray
    right_obs: np.ndarray
    left_obs: np.ndarray
    neg_act: np.ndarray
    right_act: np.ndarray
    left_act: np.ndarray

    @staticmethod
    def from_env(env) -> "MirrorSpec":
        return MirrorSpec(*env.get_mirror_indices())


def _mirror_array(x: torch.Tensor, neg, right, left) -> torch.Tensor:
    """Sign flips + left/right swap along the last axis."""
    sign = np.ones(x.shape[-1], dtype=np.float32)
    sign[neg] = -1.0
    perm = np.arange(x.shape[-1])
    perm[np.concatenate([right, left])] = perm[np.concatenate([left, right])]
    return x[..., torch.as_tensor(perm, device=x.device)] * torch.as_tensor(sign, device=x.device)


def mirror_obs(spec: MirrorSpec, obs: torch.Tensor) -> torch.Tensor:
    return _mirror_array(obs, spec.neg_obs, spec.right_obs, spec.left_obs)


def mirror_act(spec: MirrorSpec, act: torch.Tensor) -> torch.Tensor:
    return _mirror_array(act, spec.neg_act, spec.right_act, spec.left_act)


def mirror_minibatch(spec: MirrorSpec, mb: dict) -> dict:
    """Double a PPO minibatch with its mirror image: obs and actions
    mirrored, the other fields repeated."""
    out = {}
    for k, v in mb.items():
        if k == "obs":
            out[k] = torch.cat([v, mirror_obs(spec, v)], dim=0)
        elif k == "actions":
            out[k] = torch.cat([v, mirror_act(spec, v)], dim=0)
        else:
            out[k] = torch.cat([v, v], dim=0)
    return out
