"""One forward step of the flagship model as a unit (counterpart of
`__graft_entry__.py` `entry`): the Walker3DStepper policy and value and one
batched env step of a 128-env fleet on discs, whose physics is one launch of
kernel K1 on the card.

    forward_step, (policy, env_state, obs) = entry()
    env_state, obs, reward, value, log_p = forward_step(policy, env_state, obs)

The step's draws (the action noise and the env step's draws) are an
optional input, `ForwardDraws`; without them they come from the fleet's
seeded `torch.Generator`. The counterpart of `__graft_entry__.py`
`dryrun_multichip` is `steppingstone_tpu_torch/parallel/dryrun.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from steppingstone_tpu_torch.agents.networks import ActorCritic
from steppingstone_tpu_torch.agents.rollout import policy_action
from steppingstone_tpu_torch.device import resolve_device
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.envs.stepper import EnvStepDraws, StepperEnv
from steppingstone_tpu_torch.envs.vector import VecEnv

ENV_NAME = "Walker3DStepperEnv-v0"
NUM_ENVS = 128
SEED = 0  # the JAX entry's PRNGKey(0)


class ForwardDraws(NamedTuple):
    """The random draws of one forward step."""

    action_noise: torch.Tensor  # (N, A) standard normals
    env: EnvStepDraws


def draw_forward(env: StepperEnv, env_state, generator: torch.Generator) -> ForwardDraws:
    """A forward step's draws for the envs of `env_state`, from `generator`
    (on the state's device): the action noise, then the env step's."""
    n = env_state.phys.q.shape[0]
    noise = torch.randn((n, env.action_dim), generator=generator, device=env_state.phys.q.device)
    return ForwardDraws(noise, env.draw_step(env_state.cur, generator))


def entry(device=None):
    """(forward_step, example_args) on `device` (None means the card):
    `forward_step(policy, env_state, obs, draws=None)` returns (env_state,
    obs, reward, value, log_p), the JAX entry's order, and
    `example_args` is (policy, env_state, obs): an `ActorCritic` with one
    critic initialised from SEED and a fresh fleet of NUM_ENVS envs reset
    from the fleet's generator, seeded with SEED."""
    dev = resolve_device(device)
    env = make_env(ENV_NAME, device=dev)
    venv = VecEnv(env, NUM_ENVS, device=dev, seed=SEED)
    policy = ActorCritic(env.observation_dim, env.action_dim, num_ensembles=1, device=dev,
                         generator=torch.Generator().manual_seed(SEED))
    env_state, obs = venv.reset()

    @torch.no_grad()
    def forward_step(policy: ActorCritic, env_state, obs, draws: ForwardDraws | None = None):
        if draws is None:
            draws = draw_forward(env, env_state, venv.generator)
        action, log_p = policy_action(policy, obs, False, noise=draws.action_noise)
        value = policy.value(obs)
        env_state, out = venv.step(env_state, action, draws.env)
        return env_state, out.obs, out.reward, value, log_p

    return forward_step, (policy, env_state, obs)
