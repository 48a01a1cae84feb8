"""The "train" kind: training iterations back to back (`Trainer.rollout`,
a sync, `Trainer.update`, a sync). Set-up builds the trainer, makes the
weights from the seed and drives the first `check_iterations`
iterations through the window's own calls and feed, recording them; the
window then runs until an iteration finishes after `--seconds`.
End-to-end: `train_env_steps_per_s`, the frames of every iteration of
the window over the window's time.

Its traffic file's keys: `level` (the curriculum level of every env),
`check_iterations`, `check_block_steps` (control steps the reference
stacks over envs at once)."""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmark.harness import counts, draws, judge, seeds, system, trace, tree
from benchmark.harness.cell import Outcome, bound_s, check_launches, host, launches, lr_at, \
    peak_flops
from benchmark.harness.record import Record
from benchmark.reference import terrain as ref_terrain


def run(ctx) -> Outcome:
    cfg, dev, seed = ctx.config, ctx.device, ctx.seed
    K = ctx.traffic["check_iterations"]
    env = system.reference_env(cfg, dev)
    N, T = cfg["num_processes"], cfg["episode_steps"] // cfg["num_processes"]
    used = (cfg["episode_steps"] // cfg["mini_batch_size"]) * cfg["mini_batch_size"]
    nmb = system.num_mini_batch(cfg)
    shapes = system.policy_shapes(cfg, env.observation_dim, env.action_dim)
    flat0 = seeds.weights(shapes, dev, seed, cfg["logstd_init"])
    cur = ref_terrain.default_curriculum(ctx.traffic["level"], batch=N, device=dev)
    model = env.cfg.model

    def iteration_draws(i):
        return (draws.action_noise(seed, T, N, env.action_dim, dev, "iteration", i),
                draws.step_draws(seed, cur, T, env.cfg.n_stones, model.njoints, "iteration", i),
                draws.permutations(seed, cfg["ppo_epoch"], N * T, used, dev, "iteration", i))

    sut = (ctx.make_system or system.PortTrain)(cfg, dev, flat0)
    launches0 = launches() if ctx.port else None
    reset_d = draws.reset_draws(seed, cur, env.cfg.n_stones, model.njoints, "fleet")
    sut.reset(cur, reset_d)
    start = host((sut.state, sut.obs))
    checks = []
    check_s = []
    for i in range(K):
        t_i = time.perf_counter()
        noise, env_draws, perms = iteration_draws(i)
        before = dict(obs=sut.obs.detach().cpu(), params=sut.params().cpu(),
                      adam=host(sut.adam()))
        with sut.recorder.active():
            batch = sut.rollout(noise, env_draws)
        ctx.sync()
        metrics = sut.update(batch, perms, lr_at(cfg, i))
        ctx.sync()
        steps = [host(s) for s in sut.recorder.steps]
        sut.recorder.steps.clear()
        checks.append(dict(before, steps=steps, metrics=host(metrics),
                           batch={k: v.detach().cpu() for k, v in batch.items()},
                           obs_last=sut.obs.detach().cpu()))
        check_s.append(time.perf_counter() - t_i)
    after = dict(params=sut.params().cpu(), adam=host(sut.adam()))
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0

    rec = Record("train", minibatch_steps=cfg["ppo_epoch"] * nmb, control_steps=T)
    rec.spans = {"rollout": [], "update": []}
    failed, it = 0, K
    w0 = c = time.perf_counter()
    while ctx.seconds >= 0:  # a negative window: the check's readings alone
        noise, env_draws, perms = iteration_draws(it)
        a = time.perf_counter()
        batch = sut.rollout(noise, env_draws)
        ctx.sync()
        b = time.perf_counter()
        metrics = sut.update(batch, perms, lr_at(cfg, it))
        ctx.sync()
        c = time.perf_counter()
        rec.spans["rollout"].append(b - a)
        rec.spans["update"].append(c - b)
        failed += int(not all(math.isfinite(float(x)) for x in metrics))
        it += 1
        if c - w0 >= ctx.seconds:
            break
    rec.window_s = max(c - w0, 1e-9)
    rec.units = it - K
    rec.env_steps = rec.units * N * T
    rec.bound_s, step_flops = bound_s(cfg, env, N)
    rec.peak_flops = peak_flops()
    rec.flops = rec.env_steps * counts.train_flops_per_frame(cfg, env.observation_dim,
                                                            env.action_dim, step_flops)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    slices = 0
    if ctx.trace:
        noise, env_draws, perms = iteration_draws(it)
        tr = trace.Tracer()
        tr.start("rollout")
        batch = sut.rollout(noise, env_draws)
        tr.stop()
        tr.start("update")
        sut.update(batch, perms, lr_at(cfg, it))
        tr.stop()
        rec.slice = tr.slice
        rec.slice_control_steps, rec.slice_minibatch_steps = T, rec.minibatch_steps
        slices = 1
    check_launches(ctx, launches0, (K + rec.units + slices) * T)
    del sut, batch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, detail = check(ctx, env, shapes, cur, reset_d, start, checks, after,
                            iteration_draws)
    detail["phases_s"] = dict(setup=setup_s, window=rec.window_s,
                              after_window=t_check - w0 - rec.window_s,
                              check=time.perf_counter() - t_check)
    detail["iterations_s"] = dict(check=check_s, rollout=rec.spans["rollout"],
                                  update=rec.spans["update"])
    return Outcome(rec, setup_s, peak, rec.units, failed, numbers,
                   {"train_env_steps_per_s": rec.env_steps / rec.window_s}, detail)


def check(ctx, env, shapes, cur, reset_d, start, checks, after, iteration_draws):
    """The reference follows each check iteration from the program's state
    at its start, stage by stage: each control step from the program's
    state (the answers), the batch (what it holds of the steps, GAE,
    normalization) from the program's step outputs, the PPO update from
    the program's batch, parameters and Adam state."""
    cfg, dev, tol = ctx.config, ctx.device, ctx.limits["tolerances"]
    block = ctx.traffic["check_block_steps"]
    types = tree.reference_types()
    policy = system.reference_policy(cfg, env, dev)
    ppo_cfg = system.reference_ppo_config(cfg, env)
    tally = judge.Tally()
    ref_state, ref_obs = env.reset(cur, draws=reset_d)
    if cfg["use_phase_mirror"]:
        ref_state = env.set_mirror(ref_state, True)
    judge.check_start(tree.to(start[0], dev, types), start[1].to(dev), ref_state, ref_obs, tally,
                      tol)
    losses, change, moment = [], None, None
    for i, rec in enumerate(checks):
        noise, env_draws, perms = iteration_draws(i)
        system.load(policy, rec["params"].to(dev), shapes)
        steps = [tree.convert(s, types) for s in rec["steps"]]
        T, N = len(steps), rec["obs"].shape[0]
        prog = {k: v.to(dev) for k, v in rec["batch"].items()}
        judge.follow(env, policy, steps, rec["obs"], env_draws, tol, tally, block, noise=noise,
                     prog_policy=(prog["log_probs"].view(T, N, -1), prog["values"].view(T, N, -1)),
                     device=dev)
        judge.check_batch(policy, prog, steps, rec["obs"].to(dev), rec["obs_last"].to(dev), cfg,
                          tol, tally)
        del steps
        params, opt, loss_ref = judge.reference_update(
            cfg, ppo_cfg, policy, shapes, rec["params"].to(dev),
            tuple(x.to(dev) for x in rec["adam"]),
            {k: v for k, v in prog.items() if k != "rewards"}, perms, lr_at(cfg, i))
        del prog
        step = params.cpu() - rec["params"]
        change = step if change is None else change + step
        if i == 0:
            prog_adam = checks[1]["adam"] if len(checks) > 1 else after["adam"]
            moment = (opt.mu.cpu(), prog_adam[1])
        losses.append((judge.loss(cfg, rec["metrics"]), loss_ref))
    ref_norms = judge.leaf_norms(moment[0], shapes)
    median = sorted(ref_norms)[len(ref_norms) // 2]
    keep = [n >= 1e-3 * median for n in ref_norms]
    prog_change = after["params"] - checks[0]["params"]
    numbers = {
        "answers_wrong": tally.share,
        "loss_gap": max(abs(p - r) / max(abs(r), 1e-30) for p, r in losses),
        "moment_gap": judge.leaf_gap(judge.leaf_norms(moment[1], shapes), ref_norms, keep),
        "change_gap": judge.leaf_gap(judge.leaf_norms(prog_change, shapes),
                                     judge.leaf_norms(change, shapes), keep),
    }
    detail = dict(answers=tally.total, wrong=tally.wrong,
                  wrong_by_field={k: v for k, v in tally.by_field.items() if v},
                  max_gap=tally.max_gap, losses=losses,
                  leaves_left_out=[n for (n, _), k in zip(shapes, keep) if not k])
    return numbers, detail
