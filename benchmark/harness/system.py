"""The systems a cell drives. `PortTrain` and `PortEval` are the system
under test: the port's `Trainer.rollout` and `Trainer.update`, and its
`behavior_eval.evaluate_entry`, called as a user calls them. `RefTrain`
and `RefEval` put the plain reference in the program's place, computed
in TF32: the control of the check (benchmark/control.py).

Each takes the benchmark's draws in the reference's types, converts them
to its own, and can record what its env step saw and returned
(`recording`), so that the check can follow it step by step."""

from __future__ import annotations

import contextlib

import torch

from benchmark.harness import seeds, tree
from benchmark.reference import drivers as ref_drivers
from benchmark.reference import networks as ref_networks
from benchmark.reference import ppo as ref_ppo
from benchmark.reference import stepper as ref_stepper
from benchmark.reference.mirror import MirrorSpec

def policy_shapes(config: dict, obs_dim: int, act_dim: int) -> list:
    return seeds.layer_shapes(obs_dim, act_dim, config["hidden"], config["actor_layers"],
                              config["critic_layers"], config["num_ensembles"])


def unflatten(flat: torch.Tensor, shapes: list) -> dict:
    sizes = [int(torch.Size(s).numel()) for _, s in shapes]
    return {name: x.view(shape) for (name, shape), x in zip(shapes, flat.split(sizes))}


def flatten(named: dict, shapes: list) -> torch.Tensor:
    return torch.cat([named[name].detach().reshape(-1) for name, _ in shapes])


def load(policy, flat: torch.Tensor, shapes: list) -> None:
    """Copy the flat vector into the policy's parameters, by name."""
    params = dict(policy.named_parameters())
    with torch.no_grad():
        for name, x in unflatten(flat, shapes).items():
            params[name].copy_(x)


def ppo_settings(config: dict) -> dict:
    keys = ("clip_param", "ppo_epoch", "value_loss_coef", "entropy_coef", "max_grad_norm", "eps",
            "use_clipped_value_loss", "kl_cutoff")
    return {k: config[k] for k in keys}


def num_mini_batch(config: dict) -> int:
    return max(1, config["episode_steps"] // config["mini_batch_size"])


def reference_env(config: dict, device):
    """The reference's env named by the configuration's `reference_env`."""
    kw = {"plank_class": config["plank_class"]} if config["plank_class"] else {}
    return getattr(ref_stepper, config["reference_env"])(device=device, **kw)


def reference_policy(config: dict, env, device) -> ref_networks.ActorCritic:
    with torch.device("meta"):
        policy = ref_networks.ActorCritic(env.observation_dim, env.action_dim,
                                          config["num_ensembles"], device="meta")
    return policy.to_empty(device=device)


def reference_ppo_config(config: dict, env) -> ref_ppo.PPOConfig:
    return ref_ppo.PPOConfig(num_mini_batch=num_mini_batch(config),
                             mirror=MirrorSpec(*env.get_mirror_indices())
                             if config["use_mirror"] else None,
                             **ppo_settings(config))


class Recorder:
    """Records each call of an env's `reset` and `step` on the instance:
    (what it was given, what it returned), tensors kept as they are."""

    def __init__(self, venv):
        self.venv, self.resets, self.steps = venv, [], []

    @contextlib.contextmanager
    def active(self):
        reset, step = self.venv.reset, self.venv.step

        def rec_reset(*args, **kw):
            out = reset(*args, **kw)
            self.resets.append(out)
            return out

        def rec_step(state, action, *args, **kw):
            new_state, out = step(state, action, *args, **kw)
            self.steps.append((state, action, out, new_state))
            return new_state, out

        saved = {k: self.venv.__dict__.get(k) for k in ("reset", "step")}
        self.venv.reset, self.venv.step = rec_reset, rec_step
        try:
            yield self
        finally:
            for k, v in saved.items():
                if v is None:
                    delattr(self.venv, k)
                else:
                    setattr(self.venv, k, v)


class PortTrain:
    """The port's training iteration: `Trainer.rollout` then
    `Trainer.update`, fed `IterationDraws` and the benchmark's weights."""

    def __init__(self, config: dict, device, flat: torch.Tensor):
        from steppingstone_tpu_torch.agents.networks import ActorCritic
        from steppingstone_tpu_torch.agents.ppo import init_optimizer
        from steppingstone_tpu_torch.runtime.config import TrainConfig
        from steppingstone_tpu_torch.runtime.train import IterationDraws, Trainer
        self.types, self.IterationDraws = tree.port_types(), IterationDraws
        cfg = TrainConfig(env_name=config["env_name"], plank_class=config["plank_class"],
                          num_processes=config["num_processes"],
                          episode_steps=config["episode_steps"],
                          mini_batch_size=config["mini_batch_size"],
                          num_frames=config["episode_steps"], num_tests=0,
                          num_ensembles=config["num_ensembles"], use_mirror=config["use_mirror"],
                          use_phase_mirror=config["use_phase_mirror"], gamma=config["gamma"],
                          gae_lambda=config["gae_lambda"], lr=config["lr"], mesh_devices=0,
                          **ppo_settings(config))
        self.config, self.trainer = config, Trainer(cfg, device=device)
        env = self.trainer.env
        self.shapes = policy_shapes(config, env.observation_dim, env.action_dim)
        with torch.device("meta"):
            policy = ActorCritic(env.observation_dim, env.action_dim, config["num_ensembles"],
                                 device="meta")
        self.policy = policy.to_empty(device=device)
        load(self.policy, flat, self.shapes)
        self.opt_state = init_optimizer(self.policy)
        self.recorder = Recorder(self.trainer.venv)

    def reset(self, cur, draws) -> None:
        from steppingstone_tpu_torch.agents.rollout import EpisodeStats
        venv = self.trainer.venv
        self.state, self.obs = venv.reset(tree.convert(cur, self.types),
                                          tree.convert(draws, self.types))
        if self.config["use_phase_mirror"]:
            self.state = venv.set_mirror(self.state, True)
        self.stats = EpisodeStats.init(venv.num_envs, self.trainer.device)

    def rollout(self, noise, env_draws: list) -> dict:
        draws = self.IterationDraws(action_noise=noise,
                                    env_draws=[tree.convert(d, self.types) for d in env_draws])
        self.state, self.obs, self.stats, batch, aux = self.trainer.rollout(
            self.policy, self.state, self.obs, self.stats, draws=draws)
        return dict(batch, rewards=aux["rewards"])

    def update(self, batch: dict, perms, lr: float) -> tuple:
        batch = {k: v for k, v in batch.items() if k != "rewards"}
        self.opt_state, metrics = self.trainer.update(self.policy, self.opt_state, batch, lr,
                                                      perms=perms)
        return tuple(metrics)

    def params(self) -> torch.Tensor:
        return flatten(dict(self.policy.named_parameters()), self.shapes)

    def adam(self) -> tuple:
        return tuple(self.opt_state)


class PortEval:
    """The port's behavior evaluation: `evaluate_entry` over a fleet, with
    the benchmark's weights and draws."""

    def __init__(self, config: dict, device, flat: torch.Tensor, n_envs: int):
        from steppingstone_tpu_torch.agents.networks import ActorCritic
        from steppingstone_tpu_torch.envs import make_env
        from steppingstone_tpu_torch.envs.vector import VecEnv
        from steppingstone_tpu_torch.runtime import behavior_eval
        self.types, self.evaluate_entry = tree.port_types(), behavior_eval.evaluate_entry
        kw = {"plank_class": config["plank_class"]} if config["plank_class"] else {}
        env = make_env(config["env_name"], device=device, **kw)
        self.venv = VecEnv(env, n_envs, device=device)
        self.shapes = policy_shapes(config, env.observation_dim, env.action_dim)
        with torch.device("meta"):
            policy = ActorCritic(env.observation_dim, env.action_dim, config["num_ensembles"],
                                 device="meta")
        self.policy = policy.to_empty(device=device)
        load(self.policy, flat, self.shapes)
        self.recorder = Recorder(self.venv)

    def entry(self, cur, reset_draws, step_draws, steps: int):
        """(records, final state) of one entry; `step_draws(done)` returns
        the reference-typed draws of the next step."""
        return self.evaluate_entry(self.venv, self.policy, tree.convert(cur, self.types), steps,
                                   tree.convert(reset_draws, self.types),
                                   lambda done: tree.convert(step_draws(done), self.types))


@contextlib.contextmanager
def tf32():
    """Matmuls in TF32, the control's precision."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class RefTrain:
    """The reference in the program's place, in TF32: the control."""

    def __init__(self, config: dict, device, flat: torch.Tensor):
        self.config = config
        self.env = reference_env(config, device)
        self.shapes = policy_shapes(config, self.env.observation_dim, self.env.action_dim)
        self.policy = reference_policy(config, self.env, device)
        load(self.policy, flat, self.shapes)
        self.opt_state = ref_ppo.init_optimizer(self.policy)
        self.ppo = reference_ppo_config(config, self.env)
        self.recorder = Recorder(self.env)

    def reset(self, cur, draws) -> None:
        self.state, self.obs = self.env.reset(cur, draws=draws)
        if self.config["use_phase_mirror"]:
            self.state = self.env.set_mirror(self.state, True)

    def rollout(self, noise, env_draws: list) -> dict:
        with tf32():
            self.state, self.obs, batch, rewards = ref_drivers.rollout(
                self.env, self.policy, self.state, self.obs, noise, env_draws,
                self.config["gamma"], self.config["gae_lambda"])
        return dict(batch, rewards=rewards)

    def update(self, batch: dict, perms, lr: float) -> tuple:
        batch = {k: v for k, v in batch.items() if k != "rewards"}
        with tf32():
            self.opt_state, metrics = ref_ppo.ppo_update(self.policy, self.opt_state, self.ppo,
                                                         batch, lr, perms=perms)
        return tuple(metrics)

    def params(self) -> torch.Tensor:
        return flatten(dict(self.policy.named_parameters()), self.shapes)

    def adam(self) -> tuple:
        return tuple(self.opt_state)


class RefEval:
    """The reference's behavior evaluation in the program's place, in
    TF32: the control."""

    def __init__(self, config: dict, device, flat: torch.Tensor, n_envs: int):
        self.env = reference_env(config, device)
        self.shapes = policy_shapes(config, self.env.observation_dim, self.env.action_dim)
        self.policy = reference_policy(config, self.env, device)
        load(self.policy, flat, self.shapes)
        self.recorder = Recorder(self.env)

    def entry(self, cur, reset_draws, step_draws, steps: int):
        with tf32():
            return ref_drivers.evaluate_entry(self.env, self.policy, cur, steps, reset_draws,
                                              step_draws)
