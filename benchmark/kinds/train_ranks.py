"""The "train_ranks" kind: the train kind's iterations (kinds/train.py) over
`ranks` ranks of one torch.distributed job, one process a card (NCCL;
gloo on the CPU), started by the port's launcher
(`parallel/launch.py`, torchrun's variables). Each rank's `Trainer`
shards the fleet over the ranks (`num_processes / ranks` envs each) and
replicates the learner: the minibatches stay global, each rank takes its
rows of them, and each minibatch step all-reduces the flat gradient
(parallel/mesh.py). The draws are made at the whole fleet's size from
the seed on every rank and cut to its rows; the permutations are global
(`IterationDraws`' contract).

Every rank runs the same iterations: set-up (its process, the trainer,
the weights and draws, the first `check_iterations` iterations recorded),
then the window, in which each iteration ends on every rank's sync and
rank 0's clock, broadcast to all, decides when the window closes. Rank 0
times the window, its spans and set-up (from this process's start); with
`--trace 1` every rank runs one more iteration, profiled on rank 0 with
the port's collective clock (`mesh.CLOCK`) on for its update.
End-to-end: `train_env_steps_per_s`, the whole fleet's frames of every
iteration of the window over rank 0's window.

The check runs in this process once the ranks have ended: the ranks'
recorded steps, batches and states are joined into the whole fleet's, and
the train kind's check follows them: every rank's env rows, the batch,
and the global update from the gathered batch with the same
permutations, over each update's first `check_update_steps` minibatch
steps. The ranks' sums reorder float32 rounding against the reference's
single sum, and Adam and the KL guard's gate (a step whose approximate KL
passes `kl_cutoff` makes no move) grow that gap over an update's 1,000
steps past what separates the sound program from the TF32 control
(PERF.md §2), so the check follows the update's first steps from the
program's state, and the learner is recorded after them
(`first_steps`).

Its traffic file's keys: `ranks`, `level`, `check_iterations`,
`check_block_steps`, `check_update_steps`, `timeout_s` (the ranks' limit,
after which the run fails and every rank is ended)."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time
import types as pytypes

import numpy as np
import torch

from benchmark.harness import counts, draws, judge, seeds, system, trace, tree
from benchmark.harness.cell import Context, Outcome, bound_s, check_launches, host, launches, \
    lr_at, peak_flops
from benchmark.harness.faults import _patched
from benchmark.harness.record import Record
from benchmark.reference import terrain as ref_terrain


def run(ctx) -> Outcome:
    from steppingstone_tpu_torch.parallel import launch
    tr = ctx.traffic
    spec = dict(config=ctx.config, traffic=tr, limits=ctx.limits, seed=ctx.seed,
                seconds=ctx.seconds, trace=ctx.trace, device=ctx.device.type, t0=ctx.t0,
                make_system=ctx.make_system)
    results = launch.spawn(rank_main, tr["ranks"], (spec,), timeout=tr["timeout_s"])
    results = [tensors(r) for r in results]
    r0 = results[0]
    gc.collect()
    cfg, dev = ctx.config, ctx.device
    env = system.reference_env(cfg, dev)
    shapes = system.policy_shapes(cfg, env.observation_dim, env.action_dim)
    N, T = cfg["num_processes"], cfg["episode_steps"] // cfg["num_processes"]
    cur = ref_terrain.default_curriculum(tr["level"], batch=N, device=dev)
    S, nj = env.cfg.n_stones, env.cfg.model.njoints
    reset_d = draws.reset_draws(ctx.seed, cur, S, nj, "fleet")
    start = tree.cat([r["start"] for r in results])
    checks = [joined([r["checks"][i] for r in results], T)
              for i in range(tr["check_iterations"])]
    del results
    gc.collect()
    t_check = time.perf_counter()
    numbers, detail = check(ctx, env, shapes, cur, reset_d, start, checks,
                            global_draws(cfg, env, ctx.seed, dev, tr["level"]))
    detail.update(r0["detail"], ranks=tr["ranks"])
    detail["phases_s"]["check"] = time.perf_counter() - t_check
    rec = r0["record"]
    return Outcome(rec, r0["setup_s"], r0["memory_peak_bytes"], rec.units, r0["failed"],
                   numbers, {"train_env_steps_per_s": rec.env_steps / rec.window_s}, detail)


def tensors(x):
    """A rank's result with every host array turned back into a tensor."""
    if isinstance(x, dict):
        return {k: tensors(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not isinstance(x, str):
        items = [tensors(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return torch.as_tensor(x) if isinstance(x, np.ndarray) else x


def joined(parts: list, T: int) -> dict:
    """One check iteration of the whole fleet from every rank's record:
    the env rows joined in rank order, the batch in the global order (T,
    ranks x envs) flat; the learner's state is rank 0's (every rank's is
    the same)."""
    first = parts[0]

    def batch(k):
        if k == "rewards":  # (T, envs)
            return torch.cat([p["batch"][k] for p in parts], dim=1)
        rows = [p["batch"][k].view(T, -1, *p["batch"][k].shape[1:]) for p in parts]
        return torch.cat(rows, dim=1).reshape(-1, *rows[0].shape[2:])

    return dict(obs=torch.cat([p["obs"] for p in parts]), params=first["params"],
                adam=first["adam"], metrics=first["metrics"], first_steps=first["first_steps"],
                steps=[tree.cat(s) for s in zip(*(p["steps"] for p in parts))],
                batch={k: batch(k) for k in first["batch"]},
                obs_last=torch.cat([p["obs_last"] for p in parts]))


def global_draws(cfg: dict, env, seed: int, dev, level: float):
    """iteration_draws(i) of the whole fleet: (action noise, step draws,
    permutations), as the train kind makes them."""
    N, T = cfg["num_processes"], cfg["episode_steps"] // cfg["num_processes"]
    used = (cfg["episode_steps"] // cfg["mini_batch_size"]) * cfg["mini_batch_size"]
    cur = ref_terrain.default_curriculum(level, batch=N, device=dev)
    S, nj = env.cfg.n_stones, env.cfg.model.njoints

    def iteration_draws(i):
        return (draws.action_noise(seed, T, N, env.action_dim, dev, "iteration", i),
                draws.step_draws(seed, cur, T, S, nj, "iteration", i),
                draws.permutations(seed, cfg["ppo_epoch"], N * T, used, dev, "iteration", i))
    return iteration_draws


@contextlib.contextmanager
def first_steps(record: dict, steps: int, reference: bool):
    """Records the learner after an update's first `steps` minibatch steps:
    the flat parameters, Adam's first moment and the steps' metrics; of
    the port's eager step over ranks (`agents/ppo.py`), or of the
    reference's step where the reference is in the program's place."""
    if reference:
        from benchmark.reference import ppo as owner
        name = "_minibatch_step"
    else:
        from steppingstone_tpu_torch.agents import ppo as owner
        owner, name = owner._StepBuffers, "step"
    original, done, rows = getattr(owner, name), [0], []

    def flat(params):
        return torch.cat([p.detach().reshape(-1) for p in params]).cpu()

    def port_step(self, policy, rows_=None):
        original(self, policy, rows_)
        done[0] += 1
        if done[0] == steps:
            record.update(params=flat(self.params), mu=self.mu.to("cpu", copy=True),
                          history=self.history[:steps].to("cpu", copy=True))

    def reference_step(policy, params, *args):
        opt, metrics = original(policy, params, *args)
        done[0] += 1
        rows.append(torch.stack(metrics).view(-1))
        if done[0] == steps:
            record.update(params=flat(params), mu=opt.mu.to("cpu", copy=True),
                          history=torch.stack(rows).cpu())
        return opt, metrics
    with _patched(owner, name, reference_step if reference else port_step):
        yield


def rank_main(spec: dict) -> dict:
    """One rank of the job: set-up, the check iterations, the window and the
    traced slice. Returns what the check and the readers need of it (the
    record, times and memory from rank 0 only)."""
    import torch.distributed as dist

    from steppingstone_tpu_torch.parallel import mesh as pmesh
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = spec["device"] == "cpu"
    pmesh.maybe_initialize_distributed(None, "cpu" if cpu else None)
    mesh = pmesh.make_mesh(0)
    dev = torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())
    cell = pytypes.SimpleNamespace(config=spec["config"], traffic=spec["traffic"],
                                   limits=spec["limits"])
    ctx = Context(cell, spec["seed"], spec["seconds"], spec["trace"], dev, spec["t0"],
                  spec["make_system"])
    cfg, tr, seed = ctx.config, ctx.traffic, ctx.seed
    K, rank0 = tr["check_iterations"], mesh.rank == 0
    env = system.reference_env(cfg, dev)
    N, T = cfg["num_processes"], cfg["episode_steps"] // cfg["num_processes"]
    nmb = system.num_mini_batch(cfg)
    shapes = system.policy_shapes(cfg, env.observation_dim, env.action_dim)
    flat0 = seeds.weights(shapes, dev, seed, cfg["logstd_init"])
    cur = ref_terrain.default_curriculum(tr["level"], batch=N, device=dev)
    S, nj = env.cfg.n_stones, env.cfg.model.njoints
    whole = global_draws(cfg, env, seed, dev, tr["level"])
    mine = lambda x: tree.convert(x, None, mesh.local)

    def iteration_draws(i):
        noise, env_draws, perms = whole(i)
        return mesh.local(noise, 1), [mine(d) for d in env_draws], perms

    sut = (ctx.make_system or system.PortTrain)(cfg, dev, flat0)
    launches0 = launches() if ctx.port else None
    sut.reset(mine(cur), mine(draws.reset_draws(seed, cur, S, nj, "fleet")))
    types = tree.reference_types()
    out = dict(start=tree.convert(host((sut.state, sut.obs)), types), checks=[])
    for i in range(K):
        noise, env_draws, perms = iteration_draws(i)
        before = dict(obs=sut.obs.detach().cpu(), params=sut.params().cpu(),
                      adam=host(sut.adam()))
        with sut.recorder.active():
            batch = sut.rollout(noise, env_draws)
        ctx.sync()
        first = {}
        with first_steps(first, tr["check_update_steps"], isinstance(sut, system.RefTrain)):
            metrics = sut.update(batch, perms, lr_at(cfg, i))
        ctx.sync()
        steps = [tree.convert(host(s), types) for s in sut.recorder.steps]
        sut.recorder.steps.clear()
        out["checks"].append(dict(before, steps=steps, metrics=host(metrics), first_steps=first,
                                  batch={k: v.detach().cpu() for k, v in batch.items()},
                                  obs_last=sut.obs.detach().cpu()))
    ctx.sync()
    dist.barrier()
    setup_s = time.perf_counter() - ctx.t0

    rec = Record("train_ranks", minibatch_steps=cfg["ppo_epoch"] * nmb, control_steps=T)
    rec.spans = {"rollout": [], "update": []}
    failed, it = 0, K
    stop = torch.zeros(1, device=dev)
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
        stop.fill_(float(c - w0 >= ctx.seconds))
        dist.broadcast(stop, 0)  # rank 0's clock closes the window on every rank
        if stop.item():
            break
    rec.window_s = max(c - w0, 1e-9)
    rec.units = it - K
    rec.env_steps = rec.units * N * T
    rec.bound_s, step_flops = bound_s(cfg, env, N // mesh.world)
    rec.peak_flops = peak_flops()
    rec.flops = rec.env_steps * counts.train_flops_per_frame(cfg, env.observation_dim,
                                                            env.action_dim, step_flops)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    slices = 0
    if ctx.trace:
        noise, env_draws, perms = iteration_draws(it)
        tracer = trace.Tracer() if rank0 else None
        if tracer:
            tracer.start("rollout")
        batch = sut.rollout(noise, env_draws)
        ctx.sync()
        if tracer:
            tracer.stop()
            tracer.start("update")
            pmesh.CLOCK.reset()
            pmesh.CLOCK.enabled = True
        sut.update(batch, perms, lr_at(cfg, it))
        ctx.sync()
        if tracer:
            pmesh.CLOCK.enabled = False
            tracer.stop()
            rec.slice = tracer.slice
            rec.slice_control_steps, rec.slice_minibatch_steps = T, rec.minibatch_steps
            rec.spans["gradient_allreduce_s"] = [pmesh.CLOCK.seconds.get("gradient", 0.0)]
            rec.spans["gradient_allreduces"] = [pmesh.CLOCK.calls.get("gradient", 0)]
        slices = 1
    check_launches(ctx, launches0, (K + rec.units + slices) * T)
    dist.barrier()
    if rank0:
        out.update(record=rec, setup_s=setup_s, memory_peak_bytes=peak, failed=failed,
                   detail=dict(phases_s=dict(setup=setup_s, window=rec.window_s),
                               iterations_s=dict(rollout=rec.spans["rollout"],
                                                 update=rec.spans["update"])))
    return out


def check(ctx, env, shapes, cur, reset_d, start, checks, iteration_draws):
    """The train kind's check (kinds/train.py) over the whole fleet, its
    update followed over each update's first `check_update_steps` steps
    from the program's parameters, Adam state, batch and permutations:
    `loss_gap` of those steps' mean loss, `moment_gap` of Adam's first
    moment after them in the first update, `change_gap` of the parameters'
    change over them in both updates, per leaf (judge.leaf_gap)."""
    cfg, dev, tol = ctx.config, ctx.device, ctx.limits["tolerances"]
    block = ctx.traffic["check_block_steps"]
    types = tree.reference_types()
    policy = system.reference_policy(cfg, env, dev)
    ppo_cfg = system.reference_ppo_config(cfg, env)
    k = ctx.traffic["check_update_steps"]
    tally = judge.Tally()
    ref_state, ref_obs = env.reset(cur, draws=reset_d)
    judge.check_start(tree.to(start[0], dev, types), start[1].to(dev), ref_state, ref_obs, tally,
                      tol)
    losses, change, prog_change, moment = [], 0.0, 0.0, None
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
        # the first k minibatch steps: their rows, in order, as a batch of k minibatches
        order = perms[0, :k * (perms.shape[1] // ppo_cfg.num_mini_batch)]
        params, opt, loss_ref = judge.reference_update(
            cfg, dataclasses.replace(ppo_cfg, ppo_epoch=1, num_mini_batch=k), policy, shapes,
            rec["params"].to(dev), tuple(x.to(dev) for x in rec["adam"]),
            {name: v[order] for name, v in prog.items() if name != "rewards"},
            torch.arange(order.numel(), device=dev)[None], lr_at(cfg, i))
        del prog
        first = rec["first_steps"]
        change = change + (params.cpu() - rec["params"])
        prog_change = prog_change + (first["params"] - rec["params"])
        if i == 0:
            moment = (opt.mu.cpu(), first["mu"])
        losses.append((judge.loss(cfg, tuple(first["history"].mean(dim=0))), loss_ref))
    ref_norms = judge.leaf_norms(moment[0], shapes)
    median = sorted(ref_norms)[len(ref_norms) // 2]
    keep = [n >= 1e-3 * median for n in ref_norms]
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
