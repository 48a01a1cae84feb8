"""The training iteration (port of steppingstone_tpu/runtime/train.py,
`Trainer` up to `_train_iteration_impl`).

One iteration: rollout (T control steps of N envs, each one launch of the
control-step kernel on the card) -> bootstrap value -> GAE with
time-limit `bad_masks` -> normalized advantages -> `ppo_epoch` x
`num_mini_batch` PPO steps (mirror-augmented with `use_mirror`); value-only
iterations act deterministically and step at 10x lr.

The optimizer state comes from `agents.ppo.init_optimizer(policy)`. The
host loop `Trainer.train` (curricula, test fleet, checkpoints,
progress.csv) is not ported yet (ROADMAP item 8).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from steppingstone_tpu_torch.agents.gae import compute_gae, normalize_advantages
from steppingstone_tpu_torch.agents.mirror import MirrorSpec
from steppingstone_tpu_torch.agents.networks import ActorCritic
from steppingstone_tpu_torch.agents.ppo import PPOConfig, ppo_update
from steppingstone_tpu_torch.agents.rollout import collect_rollout
from steppingstone_tpu_torch.device import resolve_device
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.envs.vector import VecEnv
from steppingstone_tpu_torch.runtime.config import TrainConfig


class IterationDraws(NamedTuple):
    """Random draws of one training iteration, each None to draw it from
    the trainer's generators."""

    action_noise: torch.Tensor | None = None  # (T, N, A) standard normals
    env_draws: list | None = None             # T EnvStepDraws
    perms: torch.Tensor | None = None         # (ppo_epoch, used) minibatch row orders


class Trainer:
    """Wires config -> env fleet -> networks -> PPO on one device (`None`
    means the card)."""

    def __init__(self, cfg: TrainConfig, device=None):
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        env_kw = {"plank_class": cfg.plank_class} if cfg.plank_class else {}
        if cfg.stall_timeout >= 0:
            env_kw["stall_timeout"] = cfg.stall_timeout
        self.env = make_env(cfg.env_name, device=self.device, **env_kw)
        self.venv = VecEnv(self.env, cfg.num_processes, device=self.device, seed=cfg.seed)
        self.ppo_cfg = PPOConfig(
            clip_param=cfg.clip_param,
            ppo_epoch=cfg.ppo_epoch,
            num_mini_batch=cfg.num_mini_batch,
            value_loss_coef=cfg.value_loss_coef,
            entropy_coef=cfg.entropy_coef,
            max_grad_norm=cfg.max_grad_norm,
            eps=cfg.eps,
            use_clipped_value_loss=cfg.use_clipped_value_loss,
            mirror=MirrorSpec.from_env(self.env) if cfg.use_mirror else None,
            kl_cutoff=cfg.kl_cutoff,
        )
        # minibatch permutations
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

    def init_params(self, generator: torch.Generator | None = None) -> ActorCritic:
        """A fresh actor-critic (init drawn from `generator`, a CPU
        generator, default seeded with cfg.seed)."""
        cfg = self.cfg
        if cfg.load_saved_controller or cfg.net:
            raise NotImplementedError(
                "warm starts (load_saved_controller / net) come with the checkpoint "
                "import, ROADMAP item 13")
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        return ActorCritic(self.env.observation_dim, self.env.action_dim, cfg.num_ensembles,
                           device=self.device, generator=generator)

    def rollout(self, policy: ActorCritic, env_state, obs, stats, value_only: bool = False,
                draws: IterationDraws = IterationDraws()):
        """Collect num_steps control steps and turn them into a PPO batch.
        Returns (env_state, obs, stats, batch, aux); aux is the rollout's,
        plus its rewards (T, N)."""
        cfg = self.cfg
        env_state, obs, stats, traj, aux = collect_rollout(
            self.venv, policy, env_state, obs, stats, cfg.num_steps, deterministic=value_only,
            action_noise=draws.action_noise, env_draws=draws.env_draws)
        with torch.no_grad():
            last_value = policy.value(obs)                                  # (N, 1)
        values = torch.cat([traj.values[..., 0], last_value.T], dim=0)      # (T+1, N)
        ones = torch.ones_like(traj.masks[:1])
        masks = torch.cat([ones, traj.masks], dim=0)
        bad_masks = torch.cat([ones, traj.bad_masks], dim=0)
        returns, adv = compute_gae(traj.rewards, values, masks, bad_masks, cfg.gamma,
                                   cfg.gae_lambda)
        adv = normalize_advantages(adv)
        T, N = traj.rewards.shape
        flat = lambda x: x.reshape(T * N, *x.shape[2:])
        batch = dict(obs=flat(traj.obs), actions=flat(traj.actions),
                     log_probs=flat(traj.log_probs), values=flat(traj.values),
                     returns=flat(returns[..., None]), adv=flat(adv[..., None]))
        return env_state, obs, stats, batch, dict(aux, rewards=traj.rewards)

    def update(self, policy: ActorCritic, opt_state, batch: dict, lr, value_only: bool = False,
               perms: torch.Tensor | None = None):
        """ppo_update over `batch`; value-only updates run at 10x lr (the
        reference's value_optimizer). Returns (opt_state, PPOMetrics)."""
        return ppo_update(policy, opt_state, self.ppo_cfg, batch,
                          10.0 * lr if value_only else lr, value_only=value_only,
                          perms=perms, generator=self.generator)

    def train_iteration(self, policy: ActorCritic, opt_state, env_state, obs, stats, lr,
                        value_only: bool = False, draws: IterationDraws = IterationDraws()):
        """One training iteration; `policy` is updated in place. Returns
        (policy, opt_state, env_state, obs, stats, metrics, aux)."""
        env_state, obs, stats, batch, aux = self.rollout(policy, env_state, obs, stats,
                                                         value_only, draws)
        opt_state, metrics = self.update(policy, opt_state, batch, lr, value_only, draws.perms)
        return policy, opt_state, env_state, obs, stats, metrics, aux
