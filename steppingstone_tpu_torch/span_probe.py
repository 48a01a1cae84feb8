"""Where a training iteration's and a behavior evaluation's host time goes,
by program span (tracing.py), on the card.

    python3 -m steppingstone_tpu_torch.span_probe [walker3d] [cassie] [eval] [--out DIR]

The settings are the benchmark's cells (BENCHMARK.json): `walker3d` and
`cassie` the round-5 runs' training shape (1,024 envs x 100 control steps
on LargePlank, 10 epochs of 100 mirrored 1,024-row minibatches, kl_cutoff
0.12; Cassie with two critics and the phase mirror), `eval` a behavior
evaluation entry of 256 Walker3D envs on LargePlank at level 0. Random
draws are made before each half, outside what is timed, as the benchmark
feeds them. After WARMUPS iterations (5 steps of an entry), the same
slice is profiled twice, CUDA activity only, one profiler session per
half (the rollout, the update; the entry's `TRACE_STEPS` steps, its reset
left out), each started and ended on a sync: slice 1 with the recorder
off, as the benchmark's traced run, and slice 2 with it on. Prints one
JSON line per setting:

- `host_ms`: each span path's host time (and self time) per control step
  or per minibatch step, and the host syncs inside it per step;
- `metrics`: policy_host_ms, env_step_host_ms, physics_entry_host_ms,
  syncs_per_env_step, graph_replays_per_env_step (the replays of the
  captured env step, envs/vector.py: 1.0 on the card once captured, 0 on
  the CPU) and foot_launches_per_env_step (the `foot_positions` kernel's
  launches, physics/step_kernel.py: 2.0 on the card, 0 on the CPU) per
  control step, ppo_step_host_ms, syncs_per_ppo_step and
  graph_replays_per_ppo_step (the replays of the captured minibatch step,
  agents/ppo.py: 1.0 on the card once captured, 0 on the CPU) and
  adam_launches_per_ppo_step (the `adam_step` kernel's launches,
  physics/step_kernel.py: 1.0 on the card, 0 on the CPU) per
  minibatch step, reset_share (env.reset over env.step). On the card
  slice 2's update replays the captured step: `ppo.minibatch` spans one
  replay and has no child; `ppo.forward`, `ppo.backward` and
  `ppo.optimizer` exist only on the eager path (the CPU, several ranks)
  and in the warm-up and capture of the first update. Likewise slice 2's
  `env.step` spans one replay and its copies: `env.reset`,
  `physics.entry` and `physics.launch` exist only on the eager path and
  in the warm-up and capture, so on the card physics_entry_host_ms and
  reset_share have no reading (None);
- `sync_sites`: syncs by source line; `idle_ms`: slice 2's device idle
  time by the innermost span open over it (`<session>/<path>`, `-` outside
  every span) and `idle_attributed`, the share inside a span;
- `launches`: kernel launches (the runtime's launch calls in the profile)
  by innermost span path, per step, where the profile holds them;
- `overhead`: slice 2's wall time over slice 1's, by session;
  `overhead_unprofiled`: the same of four unprofiled runs after the
  slices, the recorder off, on, on, off (means); `profiler_inflation`:
  slice 1's wall over the unprofiled runs with the recorder off; `slices`:
  each session's wall, busy and kernel count;
- `cost_ns`: one span entered and left, and one `count` call, with the
  recorder off and on, and what the recorder adds to one host sync.

With `--out DIR` each setting's whole result is also written to
DIR/span_probe_<setting>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from steppingstone_tpu_torch import tracing
from steppingstone_tpu_torch.agents.networks import ActorCritic
from steppingstone_tpu_torch.agents.ppo import init_optimizer
from steppingstone_tpu_torch.agents.rollout import EpisodeStats
from steppingstone_tpu_torch.device import resolve_device
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.envs import terrain as terr
from steppingstone_tpu_torch.envs.vector import VecEnv
from steppingstone_tpu_torch.physics.step_kernel import ADAM_STEP, FOOT_POSITIONS
from steppingstone_tpu_torch.runtime import behavior_eval
from steppingstone_tpu_torch.runtime.config import TrainConfig
from steppingstone_tpu_torch.runtime.train import IterationDraws, Trainer
from steppingstone_tpu_torch.tracing import RECORDER

TRAIN = dict(plank_class="LargePlank", num_processes=1024, episode_steps=102_400,
             mini_batch_size=1024, num_frames=102_400, num_tests=0, use_mirror=True,
             kl_cutoff=0.12, mesh_devices=0)
SETTINGS = {
    "walker3d": dict(TRAIN, env_name="Walker3DStepperEnv-v0", num_ensembles=1),
    "cassie": dict(TRAIN, env_name="CassieStepper-v1", num_ensembles=2, use_phase_mirror=True),
}
EVAL_ENV, EVAL_ENVS, EVAL_LEVEL = "Walker3DStepperEnv-v0", 256, 0
WARMUPS = 2           # training iterations before the slices
EVAL_WARMUP_STEPS = 5
TRACE_STEPS = 20      # the entry's steps in each slice (the benchmark's trace_steps)
LR = 3e-4
LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


class Sessions:
    """Profiler sessions, one per half, each started and ended on a sync:
    their wall time, device operations and launch calls. Unprofiled
    (`profiled=False`), the same starts and stops time the halves alone."""

    def __init__(self, dev: torch.device, profiled: bool = True):
        self.dev, self.runs, self.profiled = dev, [], profiled
        self.cuda = dev.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def start(self, name: str) -> None:
        self.sync()
        self.name = name
        if self.profiled:
            self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                            else ProfilerActivity.CPU])
            self.prof.__enter__()
        self.t0, self.lo = time.perf_counter(), time.time_ns()

    def stop(self) -> None:
        self.sync()
        wall, hi = time.perf_counter() - self.t0, time.time_ns()
        cuda = torch.autograd.DeviceType.CUDA
        device, launches = [], []
        if self.profiled:
            self.prof.__exit__(None, None, None)
        for e in self.prof.profiler.kineto_results.events() if self.profiled else ():
            if e.device_type() == cuda and not e.is_user_annotation():
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif e.name() in LAUNCH:
                launches.append(e.start_ns())
        self.runs.append(dict(name=self.name, wall_s=wall, lo=self.lo, hi=hi, device=device,
                              launches=sorted(launches)))

    def summary(self) -> dict:
        """By session name: runs, and wall, busy and kernels over them all."""
        out = {}
        for r in self.runs:
            busy = sum(b - a for a, b in _union((a, b) for a, b, _ in r["device"]))
            kernels = sum(not n.startswith(("Memcpy", "Memset")) for *_, n in r["device"])
            t = out.setdefault(r["name"], dict(runs=0, wall_s=0.0, busy_s=0.0, kernels=0))
            t["runs"] += 1
            t["wall_s"] += r["wall_s"]
            t["busy_s"] += busy * 1e-9
            t["kernels"] += kernels
        return out


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _loops_ns(n: int) -> dict:
    """ns of one `with span(...)` and of one `count(...)` (n of each, less
    an empty loop's time), as the recorder stands."""
    span, count = tracing.span, tracing.count
    t0 = time.perf_counter_ns()
    for _ in range(n):
        pass
    empty = time.perf_counter_ns() - t0
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("x"):
            pass
    spans = time.perf_counter_ns() - t0
    t0 = time.perf_counter_ns()
    for _ in range(n):
        count("x")
    counts = time.perf_counter_ns() - t0
    return dict(span=(spans - empty) / n, count=(counts - empty) / n)


def _copies_ns(dev: torch.device, n: int) -> float:
    """ns of one pageable copy of a Python number to `dev` (on the card, one
    sync)."""
    t0 = time.perf_counter_ns()
    for _ in range(n):
        torch.tensor(0.0, device=dev)
    return (time.perf_counter_ns() - t0) / n


def span_costs_ns(dev: torch.device, n: int = 1_000_000) -> dict:
    """The recorder's costs in ns: a span and a count off (n of each) and on
    (n // 10), and what recording adds to one sync (2,000 copies on and off)."""
    off = _loops_ns(n)
    copy_off = _copies_ns(dev, 2000)
    RECORDER.start()
    try:
        on = _loops_ns(n // 10)
        copy_on = _copies_ns(dev, 2000)
    finally:
        RECORDER.stop()
    return dict(span_off=off["span"], count_off=off["count"], span_on=on["span"],
                count_on=on["count"], sync_on=copy_on - copy_off)


def analyse(spans: list, counters: dict, sessions: Sessions, per: dict) -> dict:
    """What slice 2 shows. `per` maps a span path to the steps its numbers
    are divided by (paths under it too)."""
    paths = tracing.paths(spans)
    totals = tracing.totals(spans)

    def steps_of(path):
        return next((n for p, n in per.items() if path == p or path.startswith(p + "/")), 1)

    host = {p: dict(n=t["n"] / steps_of(p), ms=1e-6 * t["ns"] / steps_of(p),
                    self_ms=1e-6 * t["self_ns"] / steps_of(p), syncs=t["syncs"] / steps_of(p))
            for p, t in totals.items()}
    idle, launches, total_idle = {}, {}, 0
    for r in sessions.runs:
        busy = [(a, b) for a, b, _ in r["device"]]
        for p, ns in tracing.attribute_idle(spans, busy, r["lo"], r["hi"]).items():
            idle[f"{r['name']}/{p}"] = idle.get(f"{r['name']}/{p}", 0) + ns
            total_idle += ns
        for i in tracing.innermost(spans, r["launches"]):
            p = paths[i] if i >= 0 else "-"
            launches[p] = launches.get(p, 0) + 1
    outside = sum(ns for p, ns in idle.items() if p.endswith("/-"))
    return dict(
        host_ms=host,
        spans_per_step={p: sum(1 for q in paths if q == p or q.startswith(p + "/")) / n
                        for p, n in per.items()},
        sync_sites={k[len("syncs@"):]: v for k, v in sorted(counters.items())
                    if k.startswith("syncs@")},
        syncs=counters.get("syncs", 0),
        idle_ms={p: 1e-6 * ns for p, ns in sorted(idle.items(), key=lambda x: -x[1])},
        idle_attributed=1.0 - outside / total_idle if total_idle else None,
        launches={p: n / steps_of(p) for p, n in sorted(launches.items())} if launches else None,
    )


def _ms(host: dict, path: str):
    """A span path's host ms a step, None where slice 2 has no such span
    (one inside a replayed graph)."""
    return host[path]["ms"] if path in host else None


def _share(host: dict, part: str, whole: str):
    return host[part]["ms"] / host[whole]["ms"] if part in host else None


def train_probe(name: str, dev: torch.device, **sizes) -> dict:
    """The training setting `name`; `sizes` replace its TrainConfig
    fields (the tests' tiny runs on the CPU)."""
    cfg = TrainConfig(**dict(SETTINGS[name], **sizes))
    trainer = Trainer(cfg, device=dev)
    venv, T, N = trainer.venv, cfg.num_steps, cfg.num_processes
    policy = trainer.init_params()
    opt = init_optimizer(policy)
    state, obs = venv.reset()
    if cfg.use_phase_mirror:
        state = venv.set_mirror(state, True)
    stats = EpisodeStats.init(N, dev)
    used = cfg.episode_steps // cfg.mini_batch_size * cfg.mini_batch_size

    def draws():
        return IterationDraws(
            action_noise=torch.randn((T, N, venv.action_dim), generator=venv.generator,
                                     device=dev),
            env_draws=[venv.env.draw_step(state.cur, venv.generator) for _ in range(T)],
            perms=torch.stack([torch.randperm(cfg.episode_steps, generator=trainer.generator,
                                              device=dev)[:used] for _ in range(cfg.ppo_epoch)]))

    def iteration(d, sessions=None):
        nonlocal state, obs, stats, opt
        if sessions:
            sessions.start("rollout")
        state, obs, stats, batch, _ = trainer.rollout(policy, state, obs, stats, draws=d)
        if sessions:
            sessions.stop()
            sessions.start("update")
        opt, _ = trainer.update(policy, opt, batch, LR, perms=d.perms)
        if sessions:
            sessions.stop()

    slice1, slice2 = Sessions(dev), Sessions(dev)
    for _ in range(WARMUPS):
        iteration(draws())
    iteration(draws(), slice1)
    d = draws()
    slice2.sync()
    feet, adam = FOOT_POSITIONS.launches, ADAM_STEP.launches
    RECORDER.start()
    try:
        iteration(d, slice2)
    finally:
        spans, counters = RECORDER.stop()
    feet_launches, adam_launches = FOOT_POSITIONS.launches - feet, ADAM_STEP.launches - adam
    plain = abba(lambda sessions: iteration(draws(), sessions), dev)
    minibatches = cfg.ppo_epoch * cfg.num_mini_batch
    out = analyse(spans, counters, slice2, {"trainer.rollout/rollout.step": T,
                                            "trainer.update/ppo.minibatch": minibatches})
    host = out["host_ms"]
    step, mb = "trainer.rollout/rollout.step", "trainer.update/ppo.minibatch"
    out["metrics"] = dict(
        policy_host_ms=host[f"{step}/policy"]["ms"],
        env_step_host_ms=host[f"{step}/env.step"]["ms"],
        physics_entry_host_ms=_ms(host, f"{step}/env.step/physics.entry"),
        ppo_step_host_ms=host[mb]["ms"],
        syncs_per_env_step=host[step]["syncs"],
        graph_replays_per_env_step=counters.get("env.graph.replays", 0) / T,
        foot_launches_per_env_step=feet_launches / T,
        syncs_per_ppo_step=host[mb]["syncs"],
        graph_replays_per_ppo_step=counters.get("ppo.graph.replays", 0) / minibatches,
        adam_launches_per_ppo_step=adam_launches / minibatches,
        reset_share=_share(host, f"{step}/env.step/env.reset", f"{step}/env.step"))
    return _finish(name, out, slice1, slice2, plain,
                   dict(control_steps=T, minibatch_steps=minibatches, envs=N))


def eval_probe(dev: torch.device, envs: int = EVAL_ENVS, steps: int = TRACE_STEPS) -> dict:
    env = make_env(EVAL_ENV, device=dev, plank_class="LargePlank")
    venv = VecEnv(env, envs, device=dev)
    policy = ActorCritic(env.observation_dim, env.action_dim, 1, device=dev,
                         generator=torch.Generator().manual_seed(0))
    cur = terr.default_curriculum(EVAL_LEVEL, batch=envs, device=dev)
    feet = 0  # the foot kernel's launches before the first step of the last entry

    def entry(steps, sessions=None):
        step_draws = [env.draw_step(cur, venv.generator) for _ in range(steps)]
        reset = env.draw_reset(cur, venv.generator)
        feed = iter(step_draws)

        def next_draws(done):
            nonlocal feet
            if done is None:  # the first step: the reset is not in the slice
                feet = FOOT_POSITIONS.launches
                if sessions:
                    sessions.start("steps")
            return next(feed)

        behavior_eval.evaluate_entry(venv, policy, cur, steps, reset, next_draws)
        if sessions:
            sessions.stop()

    entry(EVAL_WARMUP_STEPS)
    slice1, slice2 = Sessions(dev), Sessions(dev)
    entry(steps, slice1)
    RECORDER.start()
    try:
        entry(steps, slice2)
    finally:
        spans, counters = RECORDER.stop()
    feet_launches = FOOT_POSITIONS.launches - feet
    plain = abba(lambda sessions: entry(steps, sessions), dev)
    step = "eval.entry/eval.step"
    out = analyse(spans, counters, slice2, {step: steps})
    host = out["host_ms"]
    out["metrics"] = dict(
        policy_host_ms=host[f"{step}/policy"]["ms"],
        env_step_host_ms=host[f"{step}/env.step"]["ms"],
        physics_entry_host_ms=_ms(host, f"{step}/env.step/physics.entry"),
        syncs_per_env_step=host[step]["syncs"],
        graph_replays_per_env_step=counters.get("env.graph.replays", 0) / steps,
        foot_launches_per_env_step=feet_launches / steps,
        reset_share=_share(host, f"{step}/env.step/env.reset", f"{step}/env.step"))
    return _finish("eval", out, slice1, slice2, plain, dict(control_steps=steps, envs=envs))


def abba(run, dev) -> tuple:
    """`run(sessions)` four times unprofiled, the recorder off, on, on,
    off: (the off runs' Sessions, the on runs')."""
    off, on = Sessions(dev, profiled=False), Sessions(dev, profiled=False)
    for recording in (False, True, True, False):
        if recording:
            RECORDER.start()
        try:
            run(on if recording else off)
        finally:
            if recording:
                RECORDER.stop()
    return off, on


def _ratio(a: dict, b: dict) -> dict:
    """Mean wall of each session of `a` over `b`'s, and of all of them."""
    out = {k: (a[k]["wall_s"] / a[k]["runs"]) / (b[k]["wall_s"] / b[k]["runs"]) for k in b}
    out["all"] = (sum(v["wall_s"] / v["runs"] for v in a.values())
                  / sum(v["wall_s"] / v["runs"] for v in b.values()))
    return out


def _finish(name, out, slice1, slice2, plain, shape) -> dict:
    s1, s2 = slice1.summary(), slice2.summary()
    p_off, p_on = plain[0].summary(), plain[1].summary()
    out["slices"] = dict(off=s1, on=s2, unprofiled_off=p_off, unprofiled_on=p_on)
    out["overhead"] = _ratio(s2, s1)
    out["overhead_unprofiled"] = _ratio(p_on, p_off)
    out["profiler_inflation"] = _ratio(s1, p_off)
    return dict(setting=name, **shape, **out)


def main(argv=None, device=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("settings", nargs="*", choices=[*SETTINGS, "eval"],
                    help="default: all three")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("span_probe profiles the card: it needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = []
    for name in args.settings or [*SETTINGS, "eval"]:
        r = eval_probe(dev) if name == "eval" else train_probe(name, dev)
        r = dict(r, cost_ns=span_costs_ns(dev), card=torch.cuda.get_device_name(dev))
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"span_probe_{name}.json"), "w") as f:
                json.dump(r, f, indent=1)
        brief = {k: r[k] for k in ("setting", "card", "metrics", "sync_sites", "idle_attributed",
                                   "overhead", "overhead_unprofiled", "profiler_inflation",
                                   "cost_ns", "spans_per_step")}
        brief["idle_ms"] = dict(list(r["idle_ms"].items())[:12])
        print(json.dumps(brief), flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
