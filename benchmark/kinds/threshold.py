"""The "threshold" kind: training iterations back to back under threshold
sampling, as `Trainer.train` runs a value-based curriculum: before each
update the curriculum hooks (`Trainer.curriculum`: threshold sampling's
uniform full-range round first, then on every later update a value grid
of the configuration's eval fleet and its install on the training fleet),
a sync, `Trainer.rollout` with stones drawn from the curriculum the
program installed, a sync, `Trainer.update`, a sync, and threshold
sampling's `post_test`. Set-up builds the trainer, makes the weights from
the seed and drives the first `check_iterations` iterations through the
window's own calls, recording them; the window then runs until an
iteration finishes after `--seconds`. End-to-end: `train_env_steps_per_s`,
the training rollouts' frames over the window's time (the value grid's
time inside it, its steps not counted as frames).

With `--trace 1`, after the window: one iteration profiled in three
sessions (the curriculum, the rollout, the update), then one curriculum
call with the port's span recorder on (tracing.py), its spans and
counters kept for the readers.

The check: the train kind's (kinds/train.py) over the check iterations,
plus the curriculum: after the uniform round the installed curriculum
must equal the reference's; in a grid round the reference follows the
grid fleet step by step from the program's state, recomputes the grid
from the program's states and parameters (`grid_gap`, the largest gap
of the normalized grid; `event_gap`, the gap of the hit events' count)
and the probabilities it installs (`prob_gap`, the largest gap of the
installed probabilities over the reference's + 1e-6: a softmax at scale
150 turns a grid gap g into a relative gap up to exp(2 x 150 x g) - 1).

Its traffic file's keys: `level` (the fleet's level at reset),
`check_iterations`, `check_block_steps` and `grid_block_steps` (control
steps the reference stacks over envs at once, in the rollout and in the
grid)."""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmark.harness import counts, curriculum, draws, judge, seeds, system, trace, tree
from benchmark.harness.cell import Outcome, bound_s, check_launches, host, launches, lr_at, \
    peak_flops
from benchmark.kinds import train as train_kind
from benchmark.reference import curriculum as ref_curr
from benchmark.reference import terrain as ref_terrain

PROB_FLOOR = 1e-6


def run(ctx) -> Outcome:
    if ctx.port:
        from steppingstone_tpu_torch.runtime.train import Trainer
        if not hasattr(Trainer, "curriculum"):
            raise SystemExit("the program has no Trainer.curriculum: the threshold kind "
                             "cannot drive its curriculum hooks")
    cfg, dev, seed = ctx.config, ctx.device, ctx.seed
    K = ctx.traffic["check_iterations"]
    env = system.reference_env(cfg, dev)
    N, T = cfg["num_processes"], cfg["episode_steps"] // cfg["num_processes"]
    G, GS = cfg["value_grid_envs"], cfg["value_grid_steps"]
    used = (cfg["episode_steps"] // cfg["mini_batch_size"]) * cfg["mini_batch_size"]
    nmb = system.num_mini_batch(cfg)
    shapes = system.policy_shapes(cfg, env.observation_dim, env.action_dim)
    flat0 = seeds.weights(shapes, dev, seed, cfg["logstd_init"])
    cur0 = ref_terrain.default_curriculum(ctx.traffic["level"], batch=N, device=dev)
    S, nj = env.cfg.n_stones, env.cfg.model.njoints

    def grid_draws(i):
        cur = ref_terrain.default_curriculum(0, batch=G, device=dev)
        return (draws.reset_draws(seed, cur, S, nj, "grid", i),
                draws.step_draws(seed, cur, GS, S, nj, "grid", i))

    def iteration_draws(i, cur):
        """Update i's draws, its stones drawn from the installed `cur`."""
        return (draws.action_noise(seed, T, N, env.action_dim, dev, "iteration", i),
                draws.step_draws(seed, cur, T, S, nj, "iteration", i),
                draws.permutations(seed, cfg["ppo_epoch"], N * T, used, dev, "iteration", i))

    sut = (ctx.make_system or curriculum.PortThreshold)(cfg, dev, flat0)
    launches0 = launches() if ctx.port else None
    reset_d = draws.reset_draws(seed, cur0, S, nj, "fleet")
    sut.reset(cur0, reset_d)
    start = host((sut.state, sut.obs))
    grids = 0  # value-grid rounds run, the check's and the trace's included

    def hooks(i, record=False):
        """The curriculum before update i, ended on a sync: (seconds, what
        the check needs of it when `record`)."""
        nonlocal grids
        gd = grid_draws(i) if sut.grid_round() else None
        before = host(sut.installed()) if record else None
        t = time.perf_counter()
        if record and gd is not None:
            with sut.grid_recorder.active():
                sut.curriculum(i, gd)
        else:
            sut.curriculum(i, gd)
        ctx.sync()
        seconds = time.perf_counter() - t
        grids += gd is not None
        if not record:
            return seconds, None
        got = dict(cur_before=before, installed=host(sut.installed()), grid=None)
        if gd is not None:
            g, count = sut.grid()
            r = sut.grid_recorder
            got["grid"] = dict(grid=torch.as_tensor(g), count=count, reset=host(r.resets[0]),
                               steps=[host(s) for s in r.steps])
            r.steps.clear()
            r.resets.clear()
        return seconds, got

    checks, check_s = [], []
    for i in range(K):
        t_i = time.perf_counter()
        _, hook = hooks(i, record=True)
        noise, env_draws, perms = iteration_draws(i, sut.installed())
        before = dict(obs=sut.obs.detach().cpu(), params=sut.params().cpu(),
                      adam=host(sut.adam()))
        with sut.recorder.active():
            batch = sut.rollout(noise, env_draws)
        ctx.sync()
        metrics = sut.update(batch, perms, lr_at(cfg, i))
        ctx.sync()
        sut.post_test()
        steps = [host(s) for s in sut.recorder.steps]
        sut.recorder.steps.clear()
        checks.append(dict(before, steps=steps, metrics=host(metrics), hook=hook,
                           batch={k: v.detach().cpu() for k, v in batch.items()},
                           obs_last=sut.obs.detach().cpu()))
        check_s.append(time.perf_counter() - t_i)
    after = dict(params=sut.params().cpu(), adam=host(sut.adam()))
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0

    rec = curriculum.ThresholdRecord("threshold", minibatch_steps=cfg["ppo_epoch"] * nmb,
                                     control_steps=T, grid_steps=GS)
    rec.spans = {"curriculum": [], "rollout": [], "update": []}
    failed, it, grids0 = 0, K, grids
    w0 = c = time.perf_counter()
    while ctx.seconds >= 0:  # a negative window: the check's readings alone
        s_cur, _ = hooks(it)
        noise, env_draws, perms = iteration_draws(it, sut.installed())
        a = time.perf_counter()
        batch = sut.rollout(noise, env_draws)
        ctx.sync()
        b = time.perf_counter()
        metrics = sut.update(batch, perms, lr_at(cfg, it))
        ctx.sync()
        c = time.perf_counter()
        sut.post_test()
        rec.spans["curriculum"].append(s_cur)
        rec.spans["rollout"].append(b - a)
        rec.spans["update"].append(c - b)
        failed += int(not all(math.isfinite(float(x)) for x in metrics))
        it += 1
        if c - w0 >= ctx.seconds:
            break
    rec.window_s = max(c - w0, 1e-9)
    rec.units = it - K
    rec.env_steps = rec.units * N * T
    rec.grid_rounds = grids - grids0
    rec.bound_s, step_flops = bound_s(cfg, env, N)
    rec.peak_flops = peak_flops()
    rec.grid_flops = curriculum.grid_flops(cfg, env.observation_dim, env.action_dim, step_flops)
    rec.flops = (rec.env_steps * counts.train_flops_per_frame(cfg, env.observation_dim,
                                                              env.action_dim, step_flops)
                 + rec.grid_rounds * rec.grid_flops)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    slices = 0
    if ctx.trace:
        tr = trace.Tracer()
        gd = grid_draws(it) if sut.grid_round() else None
        tr.start("curriculum")
        sut.curriculum(it, gd)
        tr.stop()
        grids += gd is not None
        noise, env_draws, perms = iteration_draws(it, sut.installed())
        tr.start("rollout")
        batch = sut.rollout(noise, env_draws)
        tr.stop()
        tr.start("update")
        sut.update(batch, perms, lr_at(cfg, it))
        tr.stop()
        sut.post_test()
        rec.slice = tr.slice
        rec.slice_control_steps, rec.slice_minibatch_steps = T, rec.minibatch_steps
        slices = 1
        if ctx.port:
            from steppingstone_tpu_torch import tracing
            gd = grid_draws(it + 1) if sut.grid_round() else None
            tracing.RECORDER.start()
            try:
                sut.curriculum(it + 1, gd)
                ctx.sync()
            finally:
                spans, rec.counters_on = tracing.RECORDER.stop()
            grids += gd is not None
            rec.spans_on = tracing.totals(spans)
    check_launches(ctx, launches0, (K + rec.units + slices) * T + grids * GS)
    del sut, batch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, detail = check(ctx, env, shapes, cur0, reset_d, start, checks, after,
                            iteration_draws, grid_draws)
    detail["phases_s"] = dict(setup=setup_s, window=rec.window_s,
                              after_window=t_check - w0 - rec.window_s,
                              check=time.perf_counter() - t_check)
    detail["iterations_s"] = dict(check=check_s, curriculum=rec.spans["curriculum"],
                                  rollout=rec.spans["rollout"], update=rec.spans["update"])
    return Outcome(rec, setup_s, peak, rec.units, failed, numbers,
                   {"train_env_steps_per_s": rec.env_steps / rec.window_s}, detail)


def check(ctx, env, shapes, cur, reset_d, start, checks, after, iteration_draws, grid_draws):
    """The train kind's check over the check iterations, each from the
    curriculum the program installed, and the curriculum's own."""
    dev, types = ctx.device, tree.reference_types()
    installed = [tree.to(rec["hook"]["installed"], dev, types) for rec in checks]
    numbers, detail = train_kind.check(ctx, env, shapes, cur, reset_d, start, checks, after,
                                       lambda i: iteration_draws(i, installed[i]))
    tally, gaps = check_curriculum(ctx, env, shapes, checks, grid_draws)
    numbers["answers_wrong"] = (detail["wrong"] + tally.wrong) / max(detail["answers"]
                                                                    + tally.total, 1)
    numbers.update(gaps)
    detail["curriculum"] = dict(answers=tally.total, wrong=tally.wrong, max_gap=tally.max_gap,
                                wrong_by_field={k: v for k, v in tally.by_field.items() if v},
                                events=[rec["hook"]["grid"]["count"] for rec in checks
                                        if rec["hook"]["grid"] is not None])
    return numbers, detail


def check_curriculum(ctx, env, shapes, checks, grid_draws):
    """Each check iteration's curriculum hooks against the reference's,
    from the program's curriculum before them: the uniform round's install
    (the level, sampling switch, assist and grid of every env, exact); in
    a grid round the grid fleet followed step by step, the grid and its
    events recomputed from the program's states and parameters, and the
    probabilities the program installed. Returns (the tally of wrong
    answers, {grid_gap, prob_gap, event_gap})."""
    cfg, dev, tol = ctx.config, ctx.device, ctx.limits["tolerances"]
    types = tree.reference_types()
    policy = system.reference_policy(cfg, env, dev)
    tally = judge.Tally()
    gaps = dict(grid_gap=0.0, prob_gap=0.0, event_gap=0.0)
    for i, rec in enumerate(checks):
        hook = rec["hook"]
        before = tree.to(hook["cur_before"], dev, types)
        prog = tree.to(hook["installed"], dev, types)
        fields = ("level", "use_prob", "assist")
        g = hook["grid"]
        if g is None:
            # the assist ladder stays at its first rung in the cell
            want = ref_curr.uniform_round(before, 0.0)
            fields += ("sample_prob",)
        else:
            system.load(policy, rec["params"].to(dev), shapes)
            reset_draws, step_draws = grid_draws(i)
            ref_state, ref_obs = env.reset(
                ref_terrain.default_curriculum(0, batch=cfg["value_grid_envs"], device=dev),
                draws=reset_draws)
            judge.check_start(tree.to(g["reset"][0], dev, types), g["reset"][1].to(dev),
                              ref_state, ref_obs, tally, tol)
            steps = [tree.convert(s, types) for s in g["steps"]]
            judge.follow(env, policy, steps, g["reset"][1], step_draws, tol, tally,
                         ctx.traffic["grid_block_steps"], device=dev)
            raw, count = ref_curr.grid_from_states(env, policy,
                                                   [tree.to(s[3], dev) for s in steps])
            ref_grid = ref_curr.normalize(raw)
            gaps["grid_gap"] = max(gaps["grid_gap"],
                                   float((g["grid"].to(dev) - ref_grid).abs().max()))
            gaps["event_gap"] = max(gaps["event_gap"], float(abs(g["count"] - int(count))))
            probs = ref_curr.threshold_probs(ref_grid, float(cfg["sampling_scale"]),
                                             cfg["curriculum_threshold"])
            want = ref_curr.install(before, probs)
            gap = (prog.sample_prob - want.sample_prob).abs() / (want.sample_prob + PROB_FLOOR)
            gaps["prob_gap"] = max(gaps["prob_gap"], float(gap.max()))
            del steps
        flags = {f"curriculum.{k}": judge._rows_wrong(getattr(prog, k), getattr(want, k), 0.0,
                                                     0.0) for k in fields}
        tally.add(flags, prog.level.shape[0])
    return tally, gaps
