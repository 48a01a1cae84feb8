"""The "eval" kind: behavior-evaluation entries back to back
(`evaluate_entry`, `steps` control steps of `envs` envs, at each of
`levels` in turn). Set-up warms up with `warmup_steps` steps; the window
runs until an entry finishes after `--seconds`; each step's start is a
CUDA event recorded from the step-draws callback, with no host sync in
the loop. End-to-end: `eval_env_steps_per_s` (the env-steps of every
entry of the window over the window's time) and `eval_step_ms_p95` (the
95th percentile of the times between consecutive step starts).

The check follows one entry of each level, drawn from the seed before
the window among its first `check_rounds` rounds of the levels; only
those entries are recorded. Where the window closes first, entries run
on, untimed, until each drawn entry has run.

Its traffic file's keys: `envs`, `steps`, `levels`, `warmup_steps`,
`trace_steps`, `check_rounds`, `check_block_steps`."""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from benchmark.harness import counts, draws, judge, seeds, system, trace, tree
from benchmark.harness.cell import Outcome, bound_s, check_launches, host, launches, peak_flops
from benchmark.harness.record import Record
from benchmark.reference import terrain as ref_terrain


def sampled_entries(seed: int, levels: list, rounds: int) -> set:
    """The entries the check follows: one of each level, drawn from the seed."""
    rng = random.Random(seeds.stream(seed, "sample"))
    return {l + len(levels) * rng.randrange(rounds) for l in range(len(levels))}


def run(ctx) -> Outcome:
    cfg, dev, seed, tr_cfg = ctx.config, ctx.device, ctx.seed, ctx.traffic
    N, T, levels = tr_cfg["envs"], tr_cfg["steps"], tr_cfg["levels"]
    env = system.reference_env(cfg, dev)
    model, S = env.cfg.model, env.cfg.n_stones
    shapes = system.policy_shapes(cfg, env.observation_dim, env.action_dim)
    flat0 = seeds.weights(shapes, dev, seed, cfg["logstd_init"])
    sut = (ctx.make_system or system.PortEval)(cfg, dev, flat0, N)
    launches0 = launches() if ctx.port else None
    cuda = dev.type == "cuda"
    sampled = sampled_entries(seed, levels, tr_cfg["check_rounds"])

    def entry_draws(k, steps=T):
        cur = ref_terrain.default_curriculum(levels[k % len(levels)], batch=N, device=dev)
        return (cur, draws.reset_draws(seed, cur, S, model.njoints, "entry", k),
                draws.step_draws(seed, cur, steps, S, model.njoints, "entry", k))

    def feed(step_list, marks=None):
        it = iter(step_list)

        def step_draws(done):
            if marks is not None:
                marks.append(torch.cuda.Event(enable_timing=True) if cuda else time.perf_counter())
                if cuda:
                    marks[-1].record()
            return next(it)
        return step_draws

    entries = []

    def entry(k, marks=None):
        """Entry `k`, recorded where the check follows it; its records."""
        cur, rd, sd = entry_draws(k)
        if k not in sampled:
            return sut.entry(cur, rd, feed(sd, marks), T)[0]
        with sut.recorder.active():
            records, _ = sut.entry(cur, rd, feed(sd, marks), T)
        # the entry's own reset (a reference env's step resets through the same call)
        entries.append(dict(k=k, records=records, reset=sut.recorder.resets[0],
                            steps=list(sut.recorder.steps)))
        sut.recorder.steps.clear()
        sut.recorder.resets.clear()
        return records

    warm = tr_cfg["warmup_steps"]
    cur, rd, sd = entry_draws(-1, warm)
    sut.entry(cur, rd, feed(sd), warm)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0

    rec = Record("eval", control_steps=T)
    marks, failed, k = [], 0, 0
    w0 = time.perf_counter()
    while True:
        records = entry(k, marks)
        failed += int(not all(np.isfinite(records[n]).all() for n in ("reward", "ep_return")))
        k += 1
        if time.perf_counter() - w0 >= ctx.seconds:
            break
    marks.append(torch.cuda.Event(enable_timing=True) if cuda else time.perf_counter())
    if cuda:
        marks[-1].record()
    ctx.sync()
    rec.window_s = time.perf_counter() - w0
    rec.units, rec.env_steps = k, k * N * T
    if cuda:
        rec.spans["step_ms"] = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    else:
        rec.spans["step_ms"] = [1e3 * (b - a) for a, b in zip(marks[:-1], marks[1:])]
    rec.bound_s, step_flops = bound_s(cfg, env, N)
    rec.peak_flops = peak_flops()
    rec.flops = rec.env_steps * counts.eval_flops_per_step(cfg, env.observation_dim,
                                                          env.action_dim, step_flops)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    late = 0
    while k + late <= max(sampled):  # a drawn entry the window did not reach
        entry(k + late)
        late += 1
    slice_steps = 0
    if ctx.trace:
        slice_steps = tr_cfg["trace_steps"]
        cur, rd, sd = entry_draws(k + late, slice_steps)
        tr, inner = trace.Tracer(), feed(sd)

        def traced(done):
            if done is None:  # the first step: the reset is not in the slice
                tr.start("steps")
            return inner(done)

        sut.entry(cur, rd, traced, slice_steps)
        tr.stop()
        rec.slice = tr.slice
        rec.slice_control_steps = slice_steps
    check_launches(ctx, launches0, warm + (k + late) * T + slice_steps)
    del sut
    entries = [dict(e, reset=host(e["reset"]), steps=[host(s) for s in e["steps"]])
               for e in entries]
    gc.collect()
    t_check = time.perf_counter()
    numbers, detail = check(ctx, env, shapes, flat0, entries, entry_draws)
    detail["phases_s"] = dict(setup=setup_s, window=rec.window_s,
                              after_window=t_check - w0 - rec.window_s,
                              check=time.perf_counter() - t_check)
    detail["entries_after_window"] = late
    p95 = float(np.percentile(np.asarray(rec.spans["step_ms"], dtype=np.float64), 95))
    return Outcome(rec, setup_s, peak, k, failed, numbers,
                   {"eval_env_steps_per_s": rec.env_steps / rec.window_s,
                    "eval_step_ms_p95": p95}, detail)


def check(ctx, env, shapes, flat0, entries, entry_draws):
    """Each drawn entry followed step by step."""
    cfg, dev, tol = ctx.config, ctx.device, ctx.limits["tolerances"]
    types = tree.reference_types()
    policy = system.reference_policy(cfg, env, dev)
    system.load(policy, flat0, shapes)
    tally = judge.Tally()
    for e in entries:
        cur, rd, sd = entry_draws(e["k"])
        ref_state, ref_obs = env.reset(cur, draws=rd)
        judge.check_start(tree.convert(e["reset"][0], types), e["reset"][1], ref_state, ref_obs,
                          tally, tol)
        steps = [tree.convert(s, types) for s in e["steps"]]
        judge.follow(env, policy, steps, e["reset"][1], sd, tol, tally,
                     ctx.traffic["check_block_steps"], records=e["records"], device=dev)
    numbers = {"answers_wrong": tally.share}
    detail = dict(entries=sorted(e["k"] for e in entries), answers=tally.total,
                  wrong=tally.wrong, wrong_by_field={k: v for k, v in tally.by_field.items() if v},
                  max_gap=tally.max_gap)
    return numbers, detail
