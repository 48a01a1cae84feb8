"""Env registry (port of steppingstone_tpu/envs/registry.py): reference env
IDs -> constructors; `mocca_envs:<Name>` prefixes are accepted and stripped."""

from __future__ import annotations

from steppingstone_tpu_torch.envs.stepper import (
    StepperEnv,
    cassie_stepper,
    mike_stepper,
    walker3d_stepper,
)

_CONSTRUCTORS = {
    "Walker3DStepperEnv-v0": walker3d_stepper,
    "MikeStepperEnv-v0": mike_stepper,
    "CassieStepper-v1": cassie_stepper,
    # historical alias
    "Walker3DMocapStepperEnv-v0": walker3d_stepper,
}

ENV_IDS = tuple(_CONSTRUCTORS)


def make_env(env_id: str, device=None, **kwargs) -> StepperEnv:
    """device=None means the card; kwargs are StepperConfig overrides or
    `plank_class` (Pillar, Plank, LargePlank)."""
    name = env_id.split(":", 1)[-1]
    if name not in _CONSTRUCTORS:
        raise KeyError(f"unknown env id {env_id!r}; known: {ENV_IDS}")
    return _CONSTRUCTORS[name](device=device, **kwargs)
