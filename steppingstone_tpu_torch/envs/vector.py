"""Batched env API (port of steppingstone_tpu/envs/vector.py).

The whole fleet is one `EnvState` with a leading env axis on one device;
stepping N envs is one batched call into the env, whose physics is one
launch of kernel K1 on the card. The fleet's randomness comes from a
`torch.Generator` that the VecEnv owns, seeded at construction.

With a `mesh` of several ranks (parallel/mesh.py) a VecEnv holds this
rank's `num_envs // world` envs, the counterpart of the JAX VecEnv's
shard_map over the mesh: each rank steps its own shard, one kernel launch
at the local batch. Its reset and step draws are made at the global batch
from a generator seeded alike on every rank, and cut to the local rows.
"""

from __future__ import annotations

import torch

from steppingstone_tpu_torch.device import resolve_device
from steppingstone_tpu_torch.envs import terrain as terr
from steppingstone_tpu_torch.envs.stepper import (EnvState, EnvStepDraws, ResetDraws, StepperEnv,
                                                  create_temp_states)
from steppingstone_tpu_torch.parallel.mesh import SINGLE, Mesh


class VecEnv:
    def __init__(self, env: StepperEnv, num_envs: int, device=None, seed: int = 0,
                 mesh: Mesh = SINGLE):
        """`num_envs` envs in all, `num_envs // mesh.world` of them here."""
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"env lives on {env.device}, VecEnv asked for {self.device}")
        if num_envs % mesh.world:
            raise ValueError(f"num_envs={num_envs} must divide over {mesh.world} ranks")
        self.env = env
        self.mesh = mesh
        self.num_envs = num_envs // mesh.world  # this rank's envs
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    @property
    def observation_dim(self):
        return self.env.observation_dim

    @property
    def action_dim(self):
        return self.env.action_dim

    def reset(self, cur: terr.CurriculumState | None = None, draws: ResetDraws | None = None):
        if cur is None:
            cur = terr.default_curriculum(batch=self.num_envs, device=self.device)
        if draws is None:
            draws = self.env.draw_reset(cur, self.generator, self.mesh)
        return self.env.reset(cur, draws=draws)

    def step(self, state: EnvState, actions: torch.Tensor, draws: EnvStepDraws | None = None):
        if draws is None:
            draws = self.env.draw_step(state.cur, self.generator, self.mesh)
        return self.env.step(state, actions, draws=draws)

    def create_temp_states(self, state: EnvState) -> torch.Tensor:
        """(num_envs, GRID * GRID, obs_dim) candidate observations."""
        return create_temp_states(self.env.cfg, state)

    def set_mirror(self, state: EnvState, enabled: bool) -> EnvState:
        return self.env.set_mirror(state, enabled)

    def set_env_params(self, state: EnvState, params: dict) -> EnvState:
        return self.env.set_env_params(state, params)

    def set_robot_params(self, state: EnvState, params: dict) -> EnvState:
        return self.env.set_robot_params(state, params)

    def update_curriculum(self, state: EnvState, level, assist=None) -> EnvState:
        return self.env.update_curriculum(state, level, assist)

    def update_assist(self, state: EnvState, assist) -> EnvState:
        return self.env.update_assist(state, assist)

    def update_specialist(self, state: EnvState, k) -> EnvState:
        return self.env.update_specialist(state, k)

    def update_sample_prob(self, state: EnvState, prob) -> EnvState:
        """prob: one (GRID, GRID) grid, normalized and broadcast to every env."""
        return self.env.update_sample_prob(state, prob)
