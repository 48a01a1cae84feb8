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


_CONSTANTS: dict = {}  # (indices, width, device) -> (perm, sign) on that device


def _constants(neg, right, left, width: int, device: torch.device) -> tuple:
    """The gather order and the signs of a mirror over `width` features, as
    tensors on `device`: made on the first call for a spec, width and
    device, then the same tensors (no copy to the device a call)."""
    key = (tuple(map(int, neg)), tuple(map(int, right)), tuple(map(int, left)), width, device)
    got = _CONSTANTS.get(key)
    if got is None:
        sign = np.ones(width, dtype=np.float32)
        sign[neg] = -1.0
        perm = np.arange(width)
        perm[np.concatenate([right, left])] = perm[np.concatenate([left, right])]
        got = _CONSTANTS[key] = (torch.as_tensor(perm, device=device),
                                 torch.as_tensor(sign, device=device))
    return got


def _mirror_array(x: torch.Tensor, neg, right, left) -> torch.Tensor:
    """Sign flips + left/right swap along the last axis."""
    perm, sign = _constants(neg, right, left, x.shape[-1], x.device)
    return x[..., perm] * sign


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
