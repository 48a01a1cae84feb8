"""The training loop (port of steppingstone_tpu/runtime/train.py).

One iteration: rollout (T control steps of N envs, each one launch of the
control-step kernel on the card) -> bootstrap value -> GAE with
time-limit `bad_masks` -> normalized advantages -> `ppo_epoch` x
`num_mini_batch` PPO steps (mirror-augmented with `use_mirror`); value-only
iterations act deterministically and step at 10x lr with their own Adam
state.

`Trainer.train` is the host loop around it, step for step the JAX
package's: the warm start (`net` / `load_saved_controller`), the LR
schedule and warm-up, the four curriculum strategies
(the fixed curriculum, the specialist schedule, and the value-based
adaptive and threshold sampling with the grid-mode assist ladder and the
threshold coupling of value-only rounds), the deterministic test fleet
every `test_interval` updates, `advance_on_test`, the logstd re-inflation
and anneal, the NaN watchdog, checkpoints (numbered, latest, best) with
full resume, episodes.csv, progress.csv, the sampling-probability and
value-grid pickles (and their heatmap), and with `profile_dir` a
torch.profiler trace of updates 10-12 (from 0) with the program's spans
(tracing.py) on a track of their own.

Over the ranks of a torch.distributed job (parallel/mesh.py) the env
fleet is sharded and the learner replicated: each rank steps
`num_processes // world` envs, the advantages are normalized and the
minibatch gradients summed over all ranks, and every host read of
per-env values (episode stats, episodes.csv, the test fleet's returns,
checkpoints) gathers the whole fleet first, so every rank decides alike
and the run computes what one process computes. Only rank 0 writes
files and the console log.

Run:  python -m steppingstone_tpu_torch.runtime.train [with] k=v ...
(on the card; `main(argv, device="cpu")` runs it on the CPU), or on N
GPUs: torchrun --nproc_per_node=N -m steppingstone_tpu_torch.runtime.train ...
"""

from __future__ import annotations

import math
import os
import pickle
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from steppingstone_tpu_torch.agents.gae import compute_gae, normalize_advantages
from steppingstone_tpu_torch.agents.mirror import MirrorSpec
from steppingstone_tpu_torch.agents.networks import (ActorCritic, cap_logstd, reinflate_logstd,
                                                     reset_logstd)
from steppingstone_tpu_torch.agents.ppo import PPOConfig, init_optimizer, ppo_update
from steppingstone_tpu_torch.agents.rollout import EpisodeStats, collect_rollout, evaluate
from steppingstone_tpu_torch.device import resolve_device
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.envs import terrain as terr
from steppingstone_tpu_torch.envs.vector import VecEnv
from steppingstone_tpu_torch.parallel import mesh as pmesh
from steppingstone_tpu_torch.runtime import curriculum as curr
from steppingstone_tpu_torch.runtime.checkpoint import CheckpointManager
from steppingstone_tpu_torch.runtime.config import TrainConfig, init_experiment, parse_cli
from steppingstone_tpu_torch.runtime.enjoy import load_params, policy_from_state
from steppingstone_tpu_torch.runtime.loggers import ConsoleCSVLogger
from steppingstone_tpu_torch.runtime.schedules import exponential_decay, linear_decay
from steppingstone_tpu_torch.runtime.torch_import import REFERENCE_MODELS
from steppingstone_tpu_torch.tracing import RECORDER, add_to_chrome_trace, span


class IterationDraws(NamedTuple):
    """Random draws of one training iteration, each None to draw it from
    the trainer's generators. Over several ranks the action noise and env
    draws are this rank's env rows, the permutations global."""

    action_noise: torch.Tensor | None = None  # (T, N, A) standard normals
    env_draws: list | None = None             # T EnvStepDraws
    perms: torch.Tensor | None = None         # (ppo_epoch, used) minibatch row orders


class Strategies(NamedTuple):
    """The curriculum strategies a config enables, each None where it is
    off."""

    fixed: curr.FixedCurriculum | None
    assist: curr.FixedCurriculum | None      # the grid-mode assist ladder
    specialist: curr.SpecialistSchedule | None
    adaptive: curr.AdaptiveSampling | None
    threshold: curr.ThresholdSampling | None

    def snapshot_keys(self, anneal_start: int, first_sampling: bool) -> dict:
        """The strategies' state as a snapshot's "curriculum" keys."""
        fixed, assist, specialist, _, threshold = self
        return {
            "fixed_level": fixed.level if fixed else -1,
            "fixed_frac": fixed.frac if fixed else -1.0,
            "assist_level": assist.level if assist else -1,
            "assist_frac": assist.frac if assist else -1.0,
            "specialist": specialist.specialist if specialist else -1,
            "thr_uniform_counter": threshold.uniform_counter if threshold else -1,
            "thr_uniform_sampling": bool(threshold.uniform_sampling) if threshold else False,
            "anneal_start": anneal_start,
            "first_sampling": bool(first_sampling),
        }


class Trainer:
    """Wires config -> mesh -> env fleet (and test fleet) -> networks -> PPO
    on one device (`None` means the card; under a process group
    cuda:LOCAL_RANK). Its generators, seeded alike on every rank: the
    fleet's (`venv`, seeded cfg.seed; env draws and action noise), the
    test fleet's (cfg.seed + 1), the minibatch permutations' (cfg.seed)
    and, with a value-based curriculum, the value grid's eval fleet's
    (cfg.seed + 2)."""

    def __init__(self, cfg: TrainConfig, device=None):
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(pmesh.rank_device(device))
        # the mesh first: the fleet shards over its ranks
        self.mesh = pmesh.make_mesh(cfg.mesh_devices)
        env_kw = {"plank_class": cfg.plank_class} if cfg.plank_class else {}
        if cfg.stall_timeout >= 0:
            env_kw["stall_timeout"] = cfg.stall_timeout
        self.env = make_env(cfg.env_name, device=self.device, **env_kw)
        self.venv = VecEnv(self.env, cfg.num_processes, device=self.device, seed=cfg.seed,
                           mesh=self.mesh)
        # the test fleet is sharded when it divides over the ranks, else it
        # runs whole on every rank
        test_mesh = self.mesh if cfg.num_tests % self.mesh.world == 0 else pmesh.SINGLE
        self.test_venv = (VecEnv(self.env, cfg.num_tests, device=self.device, seed=cfg.seed + 1,
                                 mesh=test_mesh)
                          if cfg.num_tests > 0 else None)
        # the adaptive and threshold strategies' value grid (one eval fleet,
        # whole on every rank)
        self.value_grid = (curr.make_value_grid_fn(self.env, seed=cfg.seed + 2)
                           if cfg.use_adaptive_sampling or cfg.use_threshold_sampling else None)
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
        self.start_update = 0   # where the last `train` began (after a resume)
        self.update_times: list = []  # per update: curriculum / rollout / update / test fleet s

    def init_params(self, generator: torch.Generator | None = None) -> ActorCritic:
        """A fresh actor-critic (init drawn from `generator`, a CPU
        generator, default seeded with cfg.seed), or with
        `load_saved_controller` / `net` the warm start: the policy of
        `cfg.net` (a port checkpoint or a reference .pt), else the
        reference's `{env_name}_base.pt`, with every logstd reset to
        `warm_start_logstd`."""
        cfg = self.cfg
        if cfg.load_saved_controller or cfg.net:
            # reference warm-start flow (`train.py:147-153`); `net=` may
            # also name one of the port's checkpoints, e.g. warm-starting
            # Mike from the trained Walker3D policy (same skeleton/spaces)
            path = cfg.net or os.path.join(REFERENCE_MODELS, f"{cfg.env_name}_base.pt")
            print(f"Loading model {path}", flush=True)
            state, n_critics = load_params(path, self.env, cfg.num_ensembles, self.device)
            if n_critics != cfg.num_ensembles:
                raise SystemExit(
                    f"checkpoint has {n_critics} critics, config wants "
                    f"{cfg.num_ensembles} (set num_ensembles={n_critics})")
            # reference resets exploration noise on warm start
            # (train.py:153, controller.py:102)
            return reset_logstd(policy_from_state(state, self.env, n_critics, self.device),
                                cfg.warm_start_logstd)
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
        with span("trainer.rollout"):
            env_state, obs, stats, traj, aux = collect_rollout(
                self.venv, policy, env_state, obs, stats, cfg.num_steps, deterministic=value_only,
                action_noise=draws.action_noise, env_draws=draws.env_draws)
            with span("rollout.gae"):
                with torch.no_grad():
                    last_value = policy.value(obs)                              # (N, 1)
                values = torch.cat([traj.values[..., 0], last_value.T], dim=0)  # (T+1, N)
                ones = torch.ones_like(traj.masks[:1])
                masks = torch.cat([ones, traj.masks], dim=0)
                bad_masks = torch.cat([ones, traj.bad_masks], dim=0)
                returns, adv = compute_gae(traj.rewards, values, masks, bad_masks, cfg.gamma,
                                           cfg.gae_lambda)
                adv = normalize_advantages(adv, mesh=self.mesh)
                T, N = traj.rewards.shape
                flat = lambda x: x.reshape(T * N, *x.shape[2:])
                batch = dict(obs=flat(traj.obs), actions=flat(traj.actions),
                             log_probs=flat(traj.log_probs), values=flat(traj.values),
                             returns=flat(returns[..., None]), adv=flat(adv[..., None]))
        return env_state, obs, stats, batch, dict(aux, rewards=traj.rewards)

    def update(self, policy: ActorCritic, opt_state, batch: dict, lr, value_only: bool = False,
               perms: torch.Tensor | None = None):
        """ppo_update over `batch` (this rank's rows); value-only updates run
        at 10x lr (the reference's value_optimizer). Returns (opt_state,
        PPOMetrics)."""
        return ppo_update(policy, opt_state, self.ppo_cfg, batch,
                          10.0 * lr if value_only else lr, value_only=value_only,
                          perms=perms, generator=self.generator, mesh=self.mesh,
                          num_envs=self.venv.num_envs)

    def train_iteration(self, policy: ActorCritic, opt_state, env_state, obs, stats, lr,
                        value_only: bool = False, draws: IterationDraws = IterationDraws()):
        """One training iteration; `policy` is updated in place. Returns
        (policy, opt_state, env_state, obs, stats, metrics, aux)."""
        env_state, obs, stats, batch, aux = self.rollout(policy, env_state, obs, stats,
                                                         value_only, draws)
        opt_state, metrics = self.update(policy, opt_state, batch, lr, value_only, draws.perms)
        return policy, opt_state, env_state, obs, stats, metrics, aux

    # ------------------------------------------------------------------
    def _generators(self) -> dict:
        gens = {"venv": self.venv.generator, "trainer": self.generator}
        if self.test_venv is not None:
            gens["test_venv"] = self.test_venv.generator
        if self.value_grid is not None:
            gens["value_grid"] = self.value_grid.venv.generator
        return gens

    def generator_seeds(self) -> dict:
        """Each generator's seed at the start of a run (cfg.seed after the
        replicate offset): the fleet's and the permutations' cfg.seed, the
        test fleet's cfg.seed + 1, the value grid's cfg.seed + 2."""
        offsets = {"venv": 0, "trainer": 0, "test_venv": 1, "value_grid": 2}
        return {k: self.cfg.seed + offsets[k] for k in self._generators()}

    def seed_generators(self) -> None:
        """Seed every generator as at the start of a run."""
        seeds = self.generator_seeds()
        for k, g in self._generators().items():
            g.manual_seed(seeds[k])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _test_eval(self, policy: ActorCritic, test_state, test_obs):
        """The deterministic test fleet over one episode length."""
        return evaluate(self.test_venv, policy, test_state, test_obs,
                        self.env.cfg.max_episode_steps)

    def make_strategies(self) -> Strategies:
        """The config's curriculum strategies, at their initial state."""
        cfg = self.cfg
        fixed = (curr.FixedCurriculum(self.venv, ramp_updates=cfg.level_ramp_updates,
                                      bar=cfg.curriculum_bar)
                 if cfg.use_curriculum else None)
        # grid-mode assist ladder: threshold and adaptive runs ramp the
        # support geometry carpet -> calibrated without touching the
        # sampling distribution
        assist = (curr.FixedCurriculum(self.venv, ramp_updates=cfg.level_ramp_updates,
                                       assist_only=True, bar=cfg.assist_bar)
                  if cfg.grid_assist and self.value_grid is not None else None)
        specialist = curr.SpecialistSchedule(self.venv) if cfg.use_specialist else None
        adaptive = (curr.AdaptiveSampling(self.venv, self.env, scale=float(cfg.sampling_scale),
                                          value_grid=self.value_grid)
                    if cfg.use_adaptive_sampling else None)
        threshold = (curr.ThresholdSampling(self.venv, self.env,
                                            threshold=cfg.curriculum_threshold,
                                            scale=float(cfg.sampling_scale),
                                            value_grid=self.value_grid)
                     if cfg.use_threshold_sampling else None)
        return Strategies(fixed, assist, specialist, adaptive, threshold)

    def fresh_fleets(self, strategies: Strategies):
        """A fresh start's fleets, drawn from their generators: (env_state,
        obs, test_state, test_obs), the mirror set with use_phase_mirror
        and the strategies' initial curricula installed; the test fleet's
        pair None without one."""
        cfg = self.cfg
        env_state, obs = self.venv.reset()
        if cfg.use_phase_mirror:
            env_state = self.venv.set_mirror(env_state, True)
        test_state = test_obs = None
        if self.test_venv is not None:
            test_state, test_obs = self.test_venv.reset()
            if cfg.use_phase_mirror:
                test_state = self.test_venv.set_mirror(test_state, True)
        for strategy in (strategies.fixed, strategies.assist, strategies.specialist):
            if strategy:
                env_state = strategy.install(env_state)
        return env_state, obs, test_state, test_obs

    def curriculum(self, strategies: Strategies, policy: ActorCritic, env_state, test_state,
                   update: int, first_sampling: bool,
                   grid_draws: curr.ValueGridDraws | None = None):
        """The curriculum hooks before update `update` (from 0), as `train`
        runs them: the fixed curriculum's and the assist ladder's ramp
        ticks, the threshold coupling of value-only rounds, the threshold
        and adaptive strategies' pre-updates (a value grid and its install,
        or threshold sampling's uniform round) and the mirrors onto the
        test fleet (`test_state` None without one). `grid_draws` feeds the
        value grid (None: its fleet's generator). Returns (env_state,
        test_state, value_only, first_sampling)."""
        cfg = self.cfg
        fixed, assist, _, adaptive, threshold = strategies
        with span("trainer.curriculum"):
            if fixed:
                env_state = fixed.tick(env_state)
            if assist:
                env_state = assist.tick(env_state)
            # reference alternation: `update_values` every other update
            value_only = cfg.use_value_update and update % 2 == 1
            # reference threshold coupling (`train.py:224-228`): value-only
            # rounds collect at uniform full range; the first non-value
            # sampling round restricts to specialist band 0
            if value_only and threshold:
                env_state = self.venv.update_curriculum(env_state, terr.N_LEVELS - 1,
                                                        assist=assist.frac if assist else None)
            elif not value_only and threshold and first_sampling:
                env_state = self.venv.update_specialist(env_state, 0)
                first_sampling = False
            if threshold:
                env_state = threshold.pre_update(env_state, policy,
                                                 assist=assist.frac if assist else None,
                                                 draws=grid_draws)
            if adaptive:
                env_state = adaptive.pre_update(env_state, policy, draws=grid_draws)
            # mirror the current level onto the deterministic test fleet
            if cfg.test_curriculum and self.test_venv is not None and fixed:
                test_state = self.test_venv.update_curriculum(test_state, fixed.frac)
            # grid-mode runs: mirror the assist onto the test fleet (level
            # stays 0, uniform), which the assist ladder gates on in `train`
            if assist and self.test_venv is not None:
                test_state = self.test_venv.update_assist(test_state, assist.frac)
        return env_state, test_state, value_only, first_sampling

    def replicate_learner(self, *trees) -> None:
        """Rank 0's learner on every rank: the policy's parameters and the
        optimizer states, overwritten in place."""
        pmesh.replicate_tree(self.mesh, [t.state_dict() if isinstance(t, ActorCritic) else t
                                         for t in trees])

    def train(self) -> ActorCritic:
        """The training run `cfg` describes; returns the trained policy."""
        cfg = self.cfg
        rank0 = self.mesh.rank == 0
        exp_dir = init_experiment(cfg, write=rank0)
        # the replicate offset moved cfg.seed: every generator starts from it
        self.seed_generators()

        policy = self.init_params()
        opt_state = init_optimizer(policy)
        # value-only updates get their OWN Adam moments, like the reference's
        # separate `value_optimizer` (`algorithms/ppo.py:36-38`)
        value_opt_state = init_optimizer(policy)
        # the curriculum strategies, installed on the fresh fleet
        strategies = self.make_strategies()
        fixed, assist, specialist, adaptive, threshold = strategies
        if fixed:
            print("curriculum", fixed.level, flush=True)
        env_state, obs, test_state, test_obs = self.fresh_fleets(strategies)
        stats = EpisodeStats.init(self.venv.num_envs, self.device)
        self.replicate_learner(policy, opt_state, value_opt_state)

        ckpt = CheckpointManager(os.path.join(exp_dir, "checkpoints"), self.mesh)
        logger = (ConsoleCSVLogger(exp_dir, console_log_interval=cfg.log_interval,
                                   resume=cfg.resume) if rank0 else None)
        gather = lambda venv, tree, dim=0: pmesh.gather_env_tree(venv.mesh, tree, dim)
        # the value-based strategies' grids, from this call's updates only
        # (the JAX package's behaviour: a resumed run's pickles hold the
        # rounds after the resume)
        sampling_prob_log = []
        value_grid_log = []

        start = time.time()
        next_checkpoint = cfg.save_every
        max_ep_reward = float("-inf")
        test_rets = np.zeros(0)
        start_update = 0
        anneal_start = -1  # update where the logstd anneal began (-1: not yet)
        first_sampling = cfg.first_sampling  # reference train.py:125

        # ---- full-resume snapshot: params, both optimizers, env and test
        # fleet state, episode stats, every generator, the curricula and
        # the counters, so a resumed run continues the same trajectory; the
        # fleets gathered whole (a collective), whatever the ranks
        def make_snapshot(update, frames):
            tr = np.full(max(cfg.num_tests, 1), np.nan, np.float32)
            tr[: len(test_rets)] = np.asarray(test_rets, np.float32)[: len(tr)]
            snap = {
                "policy": policy.state_dict(),
                "opt_state": opt_state,
                "value_opt_state": value_opt_state,
                "env_state": gather(self.venv, env_state),
                "obs": gather(self.venv, obs),
                "stats": gather(self.venv, stats),
                "generators": {k: g.get_state() for k, g in self._generators().items()},
                "update": update,
                "frames": frames,
                "max_ep_reward": max(max_ep_reward, -1e30),
                "test_rets": torch.as_tensor(tr),
                "curriculum": strategies.snapshot_keys(anneal_start, first_sampling),
            }
            if self.test_venv is not None:
                snap["test_state"] = gather(self.test_venv, test_state)
                snap["test_obs"] = gather(self.test_venv, test_obs)
            return snap

        # a JAX run's orbax `latest` (with no port `latest.pt` beside it)
        # raises here, naming the converter, instead of starting afresh
        if cfg.resume and ckpt.exists("latest"):
            template = make_snapshot(0, 0)
            # each generator's state (set_state checks it), or its seed in a
            # snapshot converted from the JAX package: its streams restart
            template["generators"] = dict.fromkeys(template["generators"])
            snap = ckpt.restore_like("latest", template)
            policy.load_state_dict(snap["policy"])
            opt_state, value_opt_state = snap["opt_state"], snap["value_opt_state"]
            # each rank takes its slice of the fleets
            env_state, obs, stats = pmesh.shard_env_tree(
                self.venv.mesh, (snap["env_state"], snap["obs"], snap["stats"]))
            for k, g in self._generators().items():
                saved = snap["generators"][k]
                if isinstance(saved, int):
                    g.manual_seed(saved)
                else:
                    g.set_state(saved)
            start_update = int(snap["update"])
            max_ep_reward = float(snap["max_ep_reward"])
            tr = snap["test_rets"].numpy()
            test_rets = tr[~np.isnan(tr)]
            if self.test_venv is not None:
                test_state, test_obs = pmesh.shard_env_tree(
                    self.test_venv.mesh, (snap["test_state"], snap["test_obs"]))
            c = snap["curriculum"]
            if fixed:
                fixed.level = int(c["fixed_level"])
                fixed.frac = float(c["fixed_frac"])
                env_state = fixed.install(env_state)
            if assist and int(c["assist_level"]) >= 0:
                assist.level = int(c["assist_level"])
                assist.frac = float(c["assist_frac"])
                env_state = assist.install(env_state)
            anneal_start = int(c["anneal_start"])
            first_sampling = bool(c["first_sampling"])
            if specialist:
                specialist.specialist = int(c["specialist"])
            if threshold:
                threshold.uniform_counter = int(c["thr_uniform_counter"])
                threshold.uniform_sampling = bool(c["thr_uniform_sampling"])
            next_checkpoint = ((int(snap["frames"]) // int(cfg.save_every)) + 1) * cfg.save_every
            self.replicate_learner(policy, opt_state, value_opt_state)
            print(f"resumed from update {start_update}", flush=True)
        self.start_update = start_update
        self.update_times = []

        prof, recording = None, False  # recording: this loop turned the span recorder on
        for j in range(start_update, cfg.num_updates):
            # ---- profiling: updates 10-12, the program's spans on a track
            # of their own beside the profiler's events ---------------------
            if cfg.profile_dir is not None and j == 10:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                prof.start()
                recording = not RECORDER.on
                if recording:
                    RECORDER.start()
            if prof is not None and j == 13:
                spans = RECORDER.stop()[0] if recording else []
                prof.stop()
                os.makedirs(cfg.profile_dir, exist_ok=True)
                name = "trace.json" if self.mesh.world == 1 else f"trace_rank{self.mesh.rank}.json"
                prof.export_chrome_trace(os.path.join(cfg.profile_dir, name))
                add_to_chrome_trace(os.path.join(cfg.profile_dir, name), spans)
                prof, recording = None, False
                print(f"profiler trace written to {cfg.profile_dir}", flush=True)

            # ---- LR schedule (reference train.py:213-220) ------------------
            if cfg.lr_decay_type == "linear":
                lr = linear_decay(j, cfg.num_updates, cfg.lr, final_value=0.0)
            elif cfg.lr_decay_type == "exponential":
                lr = exponential_decay(j, 0.99, cfg.lr, final_value=3e-5)
            else:
                lr = cfg.lr
            if cfg.lr_warmup_updates:
                lr = lr * min(1.0, (j + 1) / cfg.lr_warmup_updates)

            # ---- curriculum pre-hooks -------------------------------------
            t_pre = time.perf_counter()
            env_state, test_state, value_only, first_sampling = self.curriculum(
                strategies, policy, env_state, test_state, j, first_sampling)
            for strategy in (threshold, adaptive):
                if strategy and strategy.last_probs is not None and cfg.save_sampling_prob:
                    sampling_prob_log.append(strategy.last_probs)
                    value_grid_log.append(strategy.last_grid)
            self._sync()

            # ---- the update -----------------------------------------------
            t0 = time.perf_counter()
            env_state, obs, stats, batch, aux = self.rollout(policy, env_state, obs, stats,
                                                             value_only)
            self._sync()
            t1 = time.perf_counter()
            it_opt = value_opt_state if value_only else opt_state
            it_opt, metrics = self.update(policy, it_opt, batch, lr, value_only)
            if value_only:
                value_opt_state = it_opt
            else:
                opt_state = it_opt
            self._sync()
            t2 = time.perf_counter()

            # ---- Monitor-style per-episode log (envs_utils.py:71-194) -------
            if cfg.episode_log:
                done, ep_ret, ep_len = (x.cpu().numpy() for x in gather(
                    self.venv, (aux["ep_done"], aux["ep_return"], aux["ep_len"]), 1))
                if done.any() and rank0:
                    t_now = time.time() - start
                    with open(os.path.join(exp_dir, "episodes.csv"), "a") as f:
                        if f.tell() == 0:
                            f.write("r,l,t\n")
                        for r_, l_ in zip(ep_ret[done], ep_len[done]):
                            f.write(f"{r_:.3f},{int(l_)},{t_now:.2f}\n")

            # ---- test fleet (reference train.py:472-500) -------------------
            test_fresh = False
            if cfg.num_tests > 0 and j % cfg.test_interval == 0:
                test_state, test_obs, test_stats = self._test_eval(policy, test_state, test_obs)
                test_stats = gather(self.test_venv, test_stats)
                tvalid = test_stats.valid.cpu().numpy()
                test_rets = test_stats.ret.cpu().numpy()[tvalid]
                test_fresh = True
            if threshold:
                threshold.post_test()
            t3 = time.perf_counter()

            # ---- episode stats to host ---------------------------------
            full = gather(self.venv, stats)
            valid = full.valid.cpu().numpy()
            rets = full.ret.cpu().numpy()[valid]
            mean_rew = float(rets.mean()) if rets.size else 0.0

            # ---- fixed curriculum advance --------------------------------
            # advance metric: stochastic training mean (reference
            # train.py:503) or, with advance_on_test, the deterministic
            # test-fleet mean, only on updates with a fresh test rollout
            if cfg.advance_on_test:
                adv_metric = float(test_rets.mean()) if test_fresh and test_rets.size else None
            else:
                adv_metric = mean_rew if rets.size else None
            if fixed and adv_metric is not None:
                env_state, advanced = fixed.post_update(env_state, adv_metric)
                if advanced and cfg.advance_logstd != 0.0:
                    # restore exploration for the harder level
                    reinflate_logstd(policy, cfg.advance_logstd)
            # the assist ladder advances on the deterministic test mean when
            # a test fleet exists: frontier-targeting sampling holds the
            # stochastic training mean low by design
            if assist:
                if cfg.num_tests > 0:
                    a_metric = (float(test_rets.mean()) if test_fresh and test_rets.size
                                else None)
                else:
                    a_metric = mean_rew if rets.size else None
                if a_metric is not None:
                    env_state, a_adv = assist.post_update(env_state, a_metric)
                    if a_adv and cfg.advance_logstd != 0.0:
                        reinflate_logstd(policy, cfg.advance_logstd)

            # ---- late-run exploration anneal (networks.cap_logstd) ----------
            if cfg.anneal_updates > 0:
                if anneal_start < 0:
                    if cfg.anneal_start_update >= 0:
                        at_top = j >= cfg.anneal_start_update
                    else:
                        at_top = (fixed.level >= 5 and fixed.frac >= 5.0 if fixed
                                  else j >= int(0.6 * cfg.num_updates))
                    if at_top:
                        anneal_start = j
                        print(f"logstd anneal begins at update {j + 1}", flush=True)
                if anneal_start >= 0:
                    t = min(1.0, (j - anneal_start) / cfg.anneal_updates)
                    cap_logstd(policy, -1.5 + t * (cfg.final_logstd + 1.5))

            if specialist and rets.size:
                env_state = specialist.post_update(
                    env_state, mean_rew,
                    save_fn=lambda k: ckpt.save(f"specialist_{k}",
                                                {"policy": policy.state_dict()}))

            # ---- failure detection: NaN watchdog --------------------------
            if not math.isfinite(float(metrics.value_loss)):
                ckpt.save("crash", {"policy": policy.state_dict(), "update": j + 1})
                raise RuntimeError(f"non-finite losses at update {j + 1}; state saved to "
                                   "checkpoints/crash")

            # ---- checkpointing (reference cadence) ---------------------------
            frame_count = (j + 1) * cfg.num_steps * cfg.num_processes
            is_best = rets.size > 1 and mean_rew > max_ep_reward
            if is_best:
                max_ep_reward = mean_rew
            snap = None
            save_numbered = frame_count >= next_checkpoint or j == cfg.num_updates - 1
            save_latest = (j + 1) % cfg.checkpoint_interval == 0 or j == cfg.num_updates - 1
            if save_numbered or save_latest or is_best:
                snap = make_snapshot(j + 1, frame_count)
            if save_numbered:
                ckpt.save(str(int(next_checkpoint)), snap)
                next_checkpoint += cfg.save_every
            if save_latest:
                ckpt.save("latest", snap)
            if is_best:
                ckpt.save("best", snap)

            if cfg.save_sampling_prob and sampling_prob_log and rank0:
                with open(os.path.join(exp_dir, f"{cfg.env_name}_sampling_prob.pkl"), "wb") as fp:
                    pickle.dump(sampling_prob_log, fp)
                with open(os.path.join(exp_dir, f"{cfg.env_name}_value_grid.pkl"), "wb") as fp:
                    pickle.dump(value_grid_log, fp)
            # the sampling-probability heatmap (headless analog of the
            # reference's live `plot_prob` window)
            if cfg.plot_prob and sampling_prob_log and rank0:
                from steppingstone_tpu_torch.viz.sampling_prob import render_grid

                render_grid(sampling_prob_log[-1], os.path.join(exp_dir, "sampling_prob.png"))

            # ---- logging (reference train.py:564-578) -----------------------
            if rets.size > 1 and rank0:
                elapsed = time.time() - start
                done_frames = frame_count - start_update * cfg.num_steps * cfg.num_processes
                logger.log_epoch({
                    "iter": j + 1,
                    "total_num_steps": frame_count,
                    "fps": int(done_frames / elapsed),
                    "entropy": float(metrics.dist_entropy),
                    "value_loss": float(metrics.value_loss),
                    "action_loss": float(metrics.action_loss),
                    "stats": {"rew": rets},
                    # blank (not repeated) between test intervals
                    "test_stats": {
                        "rew": (test_rets if test_rets.size else np.zeros(1))
                        if test_fresh or cfg.test_interval == 1 else None
                    },
                })
            self.update_times.append(dict(update=j + 1, curriculum_s=t0 - t_pre,
                                          rollout_s=t1 - t0, update_s=t2 - t1, test_s=t3 - t2))

        if prof is not None:
            if recording:
                RECORDER.stop()
            prof.stop()
        if logger is not None:
            logger.close()
        # every rank returns once rank 0 has written everything
        pmesh.barrier(self.mesh)
        return policy


def main(argv=None, device=None, backend=None):
    """`python -m steppingstone_tpu_torch.runtime.train [with] k=v ...`:
    one training run on the card (`device` picks another). Under torchrun's
    variables each process first joins the process group (`backend`, by
    default nccl on CUDA and gloo on the CPU) and runs rank r of the
    sharded run on cuda:LOCAL_RANK."""
    # the process group this call joins, it also leaves
    owned = not dist.is_initialized() and pmesh.maybe_initialize_distributed(backend, device)
    if dist.is_initialized():
        print(f"distributed: process {dist.get_rank()}/{dist.get_world_size()} on "
              f"{pmesh.rank_device(device)} ({dist.get_backend()})", flush=True)
    try:
        Trainer(parse_cli(argv), device=device).train()
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
