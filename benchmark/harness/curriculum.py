"""The systems of the threshold kind (kinds/threshold.py), the record it
hands the per-layer readers, and the value grid's work counts.

`PortThreshold` is the system under test: the port's `Trainer.curriculum`
(the training loop's pre-update hooks) with the configuration's
strategies, then `Trainer.rollout` and `Trainer.update`, then threshold
sampling's `post_test`, called as `Trainer.train` calls them.
`RefThreshold` puts the plain reference (reference/curriculum.py) in the
program's place, computed in TF32: the control of the check
(benchmark/readings.py).

Each takes the value grid's draws in the reference's types and records
what its grid fleet's env saw and returned (`grid_recorder`), so that
the check can follow it step by step."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from benchmark.harness import counts, system, tree
from benchmark.harness.record import Record
from benchmark.reference import curriculum as ref_curr


@dataclass
class ThresholdRecord(Record):
    grid_rounds: int = 0           # value-grid rounds in the window
    grid_flops: float = 0.0        # FLOPs of one value-grid round, counted from shapes
    grid_steps: int = 0            # control steps of one value grid
    spans_on: dict = field(default_factory=dict)     # span path -> tracing.totals' entry
    counters_on: dict = field(default_factory=dict)  # the recorder's counters


def grid_flops(config: dict, obs_dim: int, act_dim: int, step_flops: int) -> float:
    """FLOPs of one value-grid round: on each of its control steps the
    actor's mean on every env, the control step, and every critic on each
    env's GRID x GRID candidate observations."""
    m = counts.network_macs(config, obs_dim, act_dim)
    envs, cells = config["value_grid_envs"], config["grid"] ** 2
    per_step = envs * (2.0 * m["actor"] + step_flops
                       + 2.0 * config["num_ensembles"] * m["critic"] * cells)
    return config["value_grid_steps"] * per_step


def train_config(config: dict):
    """The port's TrainConfig of a threshold-sampling configuration."""
    from steppingstone_tpu_torch.runtime.config import TrainConfig
    keys = ("env_name", "plank_class", "num_processes", "episode_steps", "mini_batch_size",
            "num_tests", "num_ensembles", "use_mirror", "use_phase_mirror", "gamma",
            "gae_lambda", "lr", "use_threshold_sampling", "sampling_scale",
            "curriculum_threshold", "grid_assist", "assist_bar", "level_ramp_updates",
            "first_sampling", "save_sampling_prob", "plot_prob")
    return TrainConfig(num_frames=config["episode_steps"], mesh_devices=0,
                       **{k: config[k] for k in keys}, **system.ppo_settings(config))


class PortThreshold(system.PortTrain):
    """The port's training iteration under threshold sampling."""

    def __init__(self, config: dict, device, flat: torch.Tensor):
        from steppingstone_tpu_torch.agents.networks import ActorCritic
        from steppingstone_tpu_torch.agents.ppo import init_optimizer
        from steppingstone_tpu_torch.runtime.curriculum import ValueGridDraws
        from steppingstone_tpu_torch.runtime.train import IterationDraws, Trainer
        self.types, self.IterationDraws = tree.port_types(), IterationDraws
        self.GridDraws = ValueGridDraws
        self.config, self.trainer = config, Trainer(train_config(config), device=device)
        grid = self.trainer.value_grid
        if (grid.venv.num_envs, grid.max_steps) != (config["value_grid_envs"],
                                                    config["value_grid_steps"]):
            raise ValueError(f"the program's value grid ({grid.venv.num_envs} envs x "
                             f"{grid.max_steps} steps) is not the configuration's")
        env = self.trainer.env
        self.shapes = system.policy_shapes(config, env.observation_dim, env.action_dim)
        with torch.device("meta"):
            policy = ActorCritic(env.observation_dim, env.action_dim, config["num_ensembles"],
                                 device="meta")
        self.policy = policy.to_empty(device=device)
        system.load(self.policy, flat, self.shapes)
        self.opt_state = init_optimizer(self.policy)
        self.recorder = system.Recorder(self.trainer.venv)
        self.grid_recorder = system.Recorder(grid.venv)
        self.strategies = self.trainer.make_strategies()
        self.first_sampling = config["first_sampling"]

    def reset(self, cur, draws) -> None:
        super().reset(cur, draws)
        for strategy in (self.strategies.fixed, self.strategies.assist,
                         self.strategies.specialist):
            if strategy:
                self.state = strategy.install(self.state)

    def grid_round(self) -> bool:
        """Whether the next `curriculum` runs a value grid."""
        return not self.strategies.threshold.uniform_sampling

    def curriculum(self, update: int, grid_draws) -> None:
        """`Trainer.curriculum` before update `update`; `grid_draws`
        (reset draws, [step draws]) feed its value grid."""
        gd = None if grid_draws is None else self.GridDraws(
            tree.convert(grid_draws[0], self.types),
            [tree.convert(d, self.types) for d in grid_draws[1]])
        self.state, _, _, self.first_sampling = self.trainer.curriculum(
            self.strategies, self.policy, self.state, None, update, self.first_sampling,
            grid_draws=gd)

    def installed(self):
        """The fleet's curriculum, in the reference's types."""
        return tree.convert(self.state.cur, tree.reference_types())

    def grid(self) -> tuple:
        """(the last round's normalized grid as a host array, or None after
        a uniform round; its count of hit events)."""
        return self.strategies.threshold.last_grid, self.trainer.value_grid.last_count

    def post_test(self) -> None:
        self.strategies.threshold.post_test()


class RefThreshold(system.RefTrain):
    """The reference in the program's place, in TF32: the control."""

    def __init__(self, config: dict, device, flat: torch.Tensor):
        super().__init__(config, device, flat)
        self.grid_env = system.reference_env(config, device)
        self.grid_recorder = system.Recorder(self.grid_env)
        self.uniform, self.counter, self.last_grid, self.last_count = True, 1, None, None

    def grid_round(self) -> bool:
        return not self.uniform

    def curriculum(self, update: int, grid_draws) -> None:
        cfg, cur = self.config, self.state.cur
        with system.tf32():
            if self.uniform:
                cur, self.last_grid = ref_curr.uniform_round(cur, 0.0), None
            else:
                grid, count, _ = ref_curr.value_grid(self.grid_env, self.policy,
                                                     cfg["value_grid_envs"], *grid_draws)
                probs = ref_curr.threshold_probs(grid, float(cfg["sampling_scale"]),
                                                 cfg["curriculum_threshold"])
                cur = ref_curr.install(cur, probs)
                self.last_grid, self.last_count = grid.cpu().numpy(), int(count)
        self.state = self.state._replace(cur=cur)

    def installed(self):
        return self.state.cur

    def grid(self) -> tuple:
        return self.last_grid, self.last_count

    def post_test(self) -> None:
        # threshold sampling's bookkeeping at the trainer's uniform_every (500,000)
        self.uniform = self.counter % 500_000 == 0
        self.counter = 0 if self.uniform else self.counter
        self.counter += 1
