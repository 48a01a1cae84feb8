"""The ranks that tests/test_torch_parallel.py starts (through
steppingstone_tpu_torch.parallel.launch.spawn): each joins a gloo process
group on the CPU and runs one piece of the port sharded over it. This
module imports torch and the port only, so a started rank does not import
JAX (the test module does, and tests/conftest.py sets up its devices).

The cases that a rank and the single-process reference both need are
built here from numpy seeds, so both build the same inputs."""

from __future__ import annotations

import contextlib
import io

import numpy as np
import torch

from steppingstone_tpu_torch.parallel import mesh as pmesh


def join() -> pmesh.Mesh:
    """One thread, the gloo process group of torchrun's variables, its mesh."""
    torch.set_num_threads(1)
    assert pmesh.maybe_initialize_distributed(device="cpu")
    return pmesh.make_mesh()


# ----------------------------------------------------------------------
# shard, replicate, gather and the reductions
# ----------------------------------------------------------------------

def fleet_tree(n: int, seed: int = 0):
    """A full-fleet tree of an env state's kinds: nested NamedTuples, a
    float, a long and a bool field, a (T, n) field with the env axis
    second, a non-tensor leaf."""
    from steppingstone_tpu_torch.agents.rollout import EpisodeStats

    rng = np.random.default_rng(seed)
    stats = EpisodeStats(ret=torch.as_tensor(rng.standard_normal(n).astype(np.float32)),
                         length=torch.as_tensor(rng.integers(0, 1000, n)),
                         valid=torch.as_tensor(rng.random(n) < 0.5))
    return dict(stats=stats, terrain=torch.as_tensor(rng.standard_normal((n, 20, 6)),
                                                     dtype=torch.float32),
                label="fleet"), torch.as_tensor(rng.standard_normal((7, n)).astype(np.float32))


def trees(n: int) -> dict:
    mesh = join()
    pmesh.CLOCK.enabled = True
    full, by_time = fleet_tree(n)
    local = pmesh.shard_env_tree(mesh, full)
    local_t = pmesh.shard_env_tree(mesh, by_time, dim=1)
    gathered = pmesh.gather_env_tree(mesh, local)
    gathered_t = pmesh.gather_env_tree(mesh, local_t, dim=1)
    # replicate: every rank starts from its own values, all end with rank 0's
    mine = [torch.full((3, 4), float(mesh.rank)), torch.arange(5) * (mesh.rank + 1)]
    pmesh.replicate_tree(mesh, mine)
    mean, std = pmesh.global_mean_std(mesh, local_t)
    summed = pmesh.all_reduce_sum(mesh, torch.tensor([mesh.rank + 1.0, 2.0]))
    return dict(rank=mesh.rank, world=mesh.world, local_ret=local["stats"].ret,
                local_t=local_t, gathered_ret=gathered["stats"].ret,
                gathered_length=gathered["stats"].length, gathered_valid=gathered["stats"].valid,
                gathered_terrain=gathered["terrain"], label=gathered["label"],
                gathered_t=gathered_t, replicated=mine, mean=mean, std=std, summed=summed,
                bool_dtype=str(gathered["stats"].valid.dtype),
                clock={k: (pmesh.CLOCK.calls[k], pmesh.CLOCK.bytes[k]) for k in pmesh.CLOCK.calls})


def fleet_curriculum(n: int):
    """A curriculum of `n` envs with a grid of its own for each env (grid
    mode on every other env), from a numpy seed."""
    from steppingstone_tpu_torch.envs import terrain as terr

    rng = np.random.default_rng(1)
    prob = rng.random((n, terr.GRID, terr.GRID)).astype(np.float32) ** 4
    prob[:, :4] = 0.0
    cur = terr.default_curriculum(3, batch=n)
    return cur._replace(sample_prob=torch.as_tensor(prob / prob.sum(axis=(1, 2), keepdims=True)),
                        use_prob=torch.arange(n) % 2 == 0)


def fleet_draws(n: int, steps: int, mesh: pmesh.Mesh | None = None) -> dict:
    """A Walker3D VecEnv of `n` envs in all (seed 5): its reset and step
    draws on fleet_curriculum, then a rollout of `steps` control steps
    from its own reset; over the ranks of the process group unless `mesh`
    is given (the single process)."""
    from steppingstone_tpu_torch.agents.networks import ActorCritic
    from steppingstone_tpu_torch.agents.rollout import EpisodeStats, collect_rollout
    from steppingstone_tpu_torch.envs import make_env
    from steppingstone_tpu_torch.envs.vector import VecEnv

    mesh = join() if mesh is None else mesh
    venv = VecEnv(make_env("Walker3DStepperEnv-v0", device="cpu"), n, device="cpu", seed=5,
                  mesh=mesh)
    cur = pmesh.shard_env_tree(mesh, fleet_curriculum(n))
    reset = venv.env.draw_reset(cur, venv.generator, mesh)
    step = venv.env.draw_step(cur, venv.generator, mesh)
    policy = ActorCritic(venv.observation_dim, venv.action_dim, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    state, obs = venv.reset(cur)
    state, obs, stats, traj, _ = collect_rollout(venv, policy, state, obs,
                                                 EpisodeStats.init(venv.num_envs), steps)
    return dict(reset=reset, step=step, actions=traj.actions, rewards=traj.rewards, obs=obs,
                terrain=state.terrain)


# ----------------------------------------------------------------------
# the learner
# ----------------------------------------------------------------------

PPO_T, PPO_N = 4, 16  # the batch's steps and envs in all (8 a rank over 2)
PPO_EPOCHS, PPO_MB = 2, 4


def ppo_case():
    """(policy, AdamState, PPOConfig, global batch (T * N rows, flat over
    (T, N)), perms) for a 2-critic Walker3D learner with mirror, an
    entropy bonus and the KL guard: epoch 0's first minibatch holds rows of the first half of
    the envs only (rank 0's over two ranks) and drifted by 0.5 nats, so
    the guard skips it; the Adam state is nonzero."""
    from steppingstone_tpu_torch.agents import distributions as dist
    from steppingstone_tpu_torch.agents import ppo
    from steppingstone_tpu_torch.agents.mirror import MirrorSpec
    from steppingstone_tpu_torch.agents.networks import ActorCritic, clamped_logstd
    from steppingstone_tpu_torch.envs import make_env

    env = make_env("Walker3DStepperEnv-v0", device="cpu")
    obs_dim, act = env.observation_dim, env.action_dim
    policy = ActorCritic(obs_dim, act, 2, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    B = PPO_T * PPO_N
    obs = torch.as_tensor(rng.standard_normal((B, obs_dim)).astype(np.float32))
    with torch.no_grad():
        mean = policy.action_mean(obs)
        actions = mean + 0.2 * torch.as_tensor(rng.standard_normal((B, act)).astype(np.float32))
        logp = dist.log_prob(mean, clamped_logstd(policy), actions)
    f32 = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    batch = dict(obs=obs, actions=actions, log_probs=logp + 0.02 * f32(B, 1), values=f32(B, 1),
                 returns=f32(B, 1), adv=f32(B, 1))
    n_params = sum(p.numel() for p in policy.parameters())
    opt = ppo.AdamState(count=torch.tensor(3, dtype=torch.int32),
                        mu=1e-3 * f32(n_params), nu=1e-4 * torch.abs(f32(n_params)))
    cfg = ppo.PPOConfig(ppo_epoch=PPO_EPOCHS, num_mini_batch=PPO_MB, kl_cutoff=0.12,
                        entropy_coef=0.01, mirror=MirrorSpec.from_env(env))
    mbs = B // PPO_MB
    rows = np.arange(B)
    first_half = rows[rows % PPO_N < PPO_N // 2]
    lead = rng.permutation(first_half)[:mbs]
    rest = rng.permutation(np.setdiff1d(rows, lead))
    perms = torch.as_tensor(np.stack([np.concatenate([lead, rest]), rng.permutation(B)]))
    batch["log_probs"][perms[0, :mbs]] += 0.5
    return policy, opt, cfg, batch, perms


def ppo_result(policy, opt, metrics) -> dict:
    return dict(params=torch.cat([p.detach().reshape(-1) for p in policy.parameters()]),
                count=opt.count, mu=opt.mu, nu=opt.nu,
                metrics={f: float(getattr(metrics, f)) for f in metrics._fields})


def ppo_sharded(value_only: bool) -> dict:
    """ppo_update of ppo_case over the ranks: each rank takes its envs'
    rows of the global batch."""
    from steppingstone_tpu_torch.agents import ppo

    mesh = join()
    policy, opt, cfg, batch, perms = ppo_case()
    local = {k: pmesh.shard_env_tree(mesh, v.reshape(PPO_T, PPO_N, -1), dim=1).reshape(
        -1, v.shape[-1]) for k, v in batch.items()}
    opt, metrics = ppo.ppo_update(policy, opt, cfg, local, 3e-4, value_only=value_only,
                                  perms=perms, mesh=mesh, num_envs=PPO_N // mesh.world)
    minibatch_rows = [len(r) for r in ppo.local_minibatches(mesh, perms[0], PPO_MB,
                                                            PPO_N // mesh.world)]
    return dict(ppo_result(policy, opt, metrics), minibatch_rows=minibatch_rows)


# ----------------------------------------------------------------------
# the Cassie iteration on the JAX run's draws
# ----------------------------------------------------------------------

def cassie_iteration(path: str) -> dict:
    """Trainer.train_iteration of the case torch.save'd at `path` (config,
    policy and Adam state, the full fleet's state and obs, the JAX run's
    action noise, env draws and permutations) on this rank's envs."""
    from steppingstone_tpu_torch.agents.rollout import EpisodeStats
    from steppingstone_tpu_torch.runtime.config import TrainConfig
    from steppingstone_tpu_torch.runtime.train import IterationDraws, Trainer

    mesh = join()
    case = torch.load(path, weights_only=False)
    tr = Trainer(TrainConfig(**case["config"]), device="cpu")
    assert tr.mesh == mesh and tr.venv.num_envs == case["config"]["num_processes"] // mesh.world
    policy = tr.init_params()
    policy.load_state_dict(case["policy"])
    sl = mesh.env_slice(case["config"]["num_processes"])
    draws = IterationDraws(action_noise=case["noise"][:, sl],
                           env_draws=pmesh.shard_env_tree(mesh, case["env_draws"]),
                           perms=case["perms"])
    state, obs = pmesh.shard_env_tree(mesh, (case["state"], case["obs"]))
    policy, opt, state, obs, stats, metrics, aux = tr.train_iteration(
        policy, case["opt"], state, obs, EpisodeStats.init(tr.venv.num_envs), case["lr"],
        draws=draws)
    return dict(params={k: v for k, v in policy.state_dict().items()}, count=opt.count,
                q=state.phys.q, qd=state.phys.qd, next_step_index=state.next_step_index,
                phase=state.phase, obs=obs, valid=stats.valid, ret=stats.ret,
                length=stats.length, ep_done=aux["ep_done"], ep_return=aux["ep_return"],
                hits=aux["hits"], metrics={f: float(getattr(metrics, f))
                                           for f in metrics._fields})


# ----------------------------------------------------------------------
# the training CLI and the config's checks
# ----------------------------------------------------------------------

def train_main(argv: list) -> dict:
    """train.main(argv) on the CPU, joined through torchrun's variables;
    returns what the rank printed."""
    from steppingstone_tpu_torch.runtime import train

    torch.set_num_threads(1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(argv, device="cpu")
    return dict(stdout=out.getvalue())


# the value-based, specialist and fixed strategies on a tiny run: 2
# updates of 8 envs x 8 steps, a 2-env test fleet every update
STRATEGY_BASE = ["env_name=Walker3DStepperEnv-v0", "num_processes=8", "episode_steps=64",
                 "mini_batch_size=32", "ppo_epoch=2", "num_tests=2", "test_interval=1",
                 "seed=3", "num_frames=128"]
STRATEGIES = {
    "specialist": ["use_specialist=True"],
    "adaptive": ["use_adaptive_sampling=True", "save_sampling_prob=True"],
    "threshold": ["use_threshold_sampling=True", "save_sampling_prob=True",
                  "assist_bar=-1000", "level_ramp_updates=3"],
}


def train_strategies(root: str, single: bool = False) -> dict:
    """Trainer.train of every STRATEGIES case under `root`/<case>, over the
    ranks of the process group (or in this process with `single`), with
    episodes of 12 steps and a value grid of 4 envs x 24 steps (its own
    fleet, whole on every rank)."""
    import dataclasses
    import os

    from steppingstone_tpu_torch.runtime import curriculum as curr
    from steppingstone_tpu_torch.runtime.config import parse_cli
    from steppingstone_tpu_torch.runtime.train import Trainer

    if not single:
        join()
    out = {}
    for case, args in STRATEGIES.items():
        cfg = parse_cli(STRATEGY_BASE + args + [f"experiment_dir={os.path.join(root, case)}"])
        tr = Trainer(cfg, device="cpu")
        tr.env.cfg = dataclasses.replace(tr.env.cfg, max_episode_steps=12)
        if tr.value_grid is not None:
            tr.value_grid = curr.make_value_grid_fn(tr.env, max_steps=24, n_envs=4,
                                                    seed=cfg.seed + 2)
        with contextlib.redirect_stdout(io.StringIO()):
            tr.train()
        out[case] = (tr.venv.num_envs, tr.test_venv.num_envs)
    return out


def config_checks() -> dict:
    """What TrainConfig.validate and Trainer make of fleets over the ranks:
    each case's ValueError message, or the fleets' local sizes."""
    from steppingstone_tpu_torch.runtime.config import TrainConfig
    from steppingstone_tpu_torch.runtime.train import Trainer

    mesh = join()
    out = {}
    cases = {"indivisible fleet": dict(num_processes=7, episode_steps=7 * 8),
             "mesh_devices=1": dict(mesh_devices=1),
             "mesh_devices=3": dict(mesh_devices=3)}
    for name, kw in cases.items():
        base = dict(env_name="Walker3DStepperEnv-v0", num_processes=8, episode_steps=64,
                    num_frames=64, num_tests=0)
        try:
            TrainConfig(**{**base, **kw}).validate()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    for name, tests in (("test fleet divides", 4), ("test fleet whole on each rank", 3)):
        tr = Trainer(TrainConfig(env_name="Walker3DStepperEnv-v0", num_processes=8,
                                 episode_steps=64, num_frames=64, num_tests=tests,
                                 mesh_devices=mesh.world), device="cpu")
        out[name] = (tr.venv.num_envs, tr.test_venv.num_envs, tr.test_venv.mesh.world)
    return out
