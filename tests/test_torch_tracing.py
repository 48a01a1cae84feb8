"""The port's span and counter recorder (steppingstone_tpu_torch/tracing.py).

On the CPU at tiny sizes (8 envs x 4 steps, two minibatch steps): off it
records nothing; on, a rollout + update and a behavior-evaluation entry
give the span tree of the layers, with their counts per control step and
per minibatch step; the self-time and idle arithmetic; a sync warning
counted where it was raised; the outputs equal bit for bit with the
recorder on and off; `profile_dir`'s export carries the spans on the
profiler's clock; the collective clock's counters and span.

Card-marked (skipped without a card; on the card:
`python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -m card`):
a span around a synced ~1 ms kernel holds the kernel's device interval
within 50 us on the profiler's clock, and `.item()`, a tensor made on the
card from a Python number and `.cpu()` each count one sync.
"""

import json
import os
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from steppingstone_tpu_torch import span_probe, tracing
from steppingstone_tpu_torch.agents.ppo import init_optimizer
from steppingstone_tpu_torch.agents.rollout import EpisodeStats
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.envs import terrain as tterr
from steppingstone_tpu_torch.envs.vector import VecEnv
from steppingstone_tpu_torch.parallel import mesh as pmesh
from steppingstone_tpu_torch.physics import step_kernel
from steppingstone_tpu_torch.runtime import behavior_eval
from steppingstone_tpu_torch.runtime import curriculum as tcurr
from steppingstone_tpu_torch.runtime.config import TrainConfig, parse_cli
from steppingstone_tpu_torch.runtime.train import Trainer
from steppingstone_tpu_torch.tracing import RECORDER, Span

N, T, MINIBATCHES = 8, 4, 2
US = 1000  # ns


@pytest.fixture
def card():
    """Skips the test on a host without a CUDA card: decided when the test
    runs, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def recorder():
    """RECORDER on for the test; `stop()` returns what it recorded."""
    RECORDER.start()
    try:
        yield RECORDER
    finally:
        if RECORDER.on:
            RECORDER.stop()


def _trainer():
    cfg = TrainConfig(env_name="Walker3DStepperEnv-v0", plank_class="LargePlank",
                      num_processes=N, episode_steps=N * T, mini_batch_size=N * T // MINIBATCHES,
                      num_frames=N * T, num_tests=0, use_mirror=True, ppo_epoch=1,
                      mesh_devices=0, seed=3)
    return Trainer(cfg, device="cpu")


def _iteration(trainer):
    """One seeded rollout + update from a fresh fleet and policy: (batch,
    parameters after the update, the update's metrics)."""
    trainer.seed_generators()
    policy = trainer.init_params()
    opt = init_optimizer(policy)
    state, obs = trainer.venv.reset()
    state, obs, stats, batch, _ = trainer.rollout(policy, state, obs, EpisodeStats.init(N))
    _, metrics = trainer.update(policy, opt, batch, 3e-4)
    return batch, [p.detach().clone() for p in policy.parameters()], metrics


def _tree(spans):
    """path -> count."""
    return {k: v["n"] for k, v in tracing.totals(spans).items()}


def test_off_records_nothing():
    assert not RECORDER.on
    assert tracing.span("env.step") is tracing.NULL_SPAN
    with tracing.span("a") as s:
        tracing.count("c")
    assert s is tracing.NULL_SPAN
    _iteration(_trainer())
    RECORDER.start()
    assert RECORDER.stop() == ([], {})


def test_rollout_and_update_span_tree(recorder):
    trainer = _trainer()
    _iteration(trainer)
    spans, counters = RECORDER.stop()
    step = "trainer.rollout/rollout.step"
    mb = "trainer.update/ppo.minibatch"
    # on the CPU the control step runs the plain version: no launch
    assert _tree(spans) == {
        "trainer.rollout": 1, step: T, f"{step}/policy": T, f"{step}/env.step": T,
        f"{step}/env.step/physics.entry": T, f"{step}/env.step/env.reset": T,
        "trainer.rollout/rollout.gae": 1,
        "trainer.update": 1, mb: MINIBATCHES, f"{mb}/ppo.forward": MINIBATCHES,
        f"{mb}/ppo.backward": MINIBATCHES, f"{mb}/ppo.optimizer": MINIBATCHES}
    # spans per control step and per minibatch step
    per_step = sum(1 for p in tracing.paths(spans) if p.startswith(step)) / T
    per_mb = sum(1 for p in tracing.paths(spans) if p.startswith(mb)) / MINIBATCHES
    assert (per_step, per_mb) == (5, 4)
    # the reset's own fleet reset ran before the recording; the step's
    # auto-reset is a child of the env step, after the physics entry
    steps = [s for s in spans if s.name == "env.step"]
    for s in steps:
        kids = [c.name for c in spans if c.parent == s.index]
        assert kids == ["physics.entry", "env.reset"]
    # top-level spans carry their call's index; children share it
    assert [(s.name, s.call) for s in spans if s.parent < 0] == [("trainer.rollout", 0),
                                                                   ("trainer.update", 0)]
    assert all(s.call == 0 for s in spans)
    assert all(s.t0 <= s.t1 for s in spans)
    assert counters == {}  # no sync on the CPU, no counter on this path


def test_eval_entry_span_tree(recorder):
    env = make_env("Walker3DStepperEnv-v0", device="cpu", plank_class="LargePlank")
    venv = VecEnv(env, N, device="cpu", seed=0)
    policy = _trainer().init_params()
    from steppingstone_tpu_torch.envs import terrain as terr
    cur = terr.default_curriculum(0, batch=N, device="cpu")
    for _ in range(2):
        behavior_eval.evaluate_entry(venv, policy, cur, 3)
    spans, _ = RECORDER.stop()
    e = "eval.entry/eval.step"
    assert _tree(spans) == {
        "eval.entry": 2, "eval.entry/eval.reset": 2, e: 6, f"{e}/policy": 6,
        f"{e}/env.step": 6, f"{e}/env.step/physics.entry": 6, f"{e}/env.step/env.reset": 6,
        "eval.entry/eval.records": 2}
    roots = [s for s in spans if s.parent < 0]
    assert [s.call for s in roots] == [0, 1]
    # every span of an entry carries the entry's index
    for s in spans:
        root = s
        while root.parent >= 0:
            root = spans[root.parent]
        assert s.call == root.call


def _spans(*rows):
    """Spans from (name, parent, t0, t1) rows, in entry order."""
    return [Span(name, index=i, parent=p, t0=a, t1=b) for i, (name, p, a, b) in enumerate(rows)]


def test_self_time_and_idle_arithmetic():
    spans = _spans(("root", -1, 0, 100), ("a", 0, 10, 40), ("aa", 1, 20, 30),
                   ("b", 0, 50, 90), ("next", -1, 120, 150))
    assert tracing.paths(spans) == ["root", "root/a", "root/a/aa", "root/b", "next"]
    assert tracing.segments(spans) == [(0, 10, 0), (10, 20, 1), (20, 30, 2), (30, 40, 1),
                                       (40, 50, 0), (50, 90, 3), (90, 100, 0), (120, 150, 4)]
    assert tracing.self_ns(spans) == [30, 20, 10, 40, 30]
    t = tracing.totals(spans)
    assert (t["root"]["ns"], t["root"]["self_ns"], t["root/a"]["self_ns"]) == (100, 30, 20)
    # the self times add up to the top-level spans' durations
    assert sum(tracing.self_ns(spans)) == 100 + 30
    assert tracing.idle_intervals([(5, 25), (22, 35), (60, 200)], 0, 160) == [
        (0, 5), (35, 60)]
    # device busy [15, 25) and [45, 95): idle [0, 15), [25, 45), [95, 160),
    # cut at the spans' edges; [100, 120) and [150, 160) fall outside them
    idle = tracing.attribute_idle(spans, [(45, 95), (15, 25)], 0, 160)
    assert idle == {"root": 10 + 5 + 5, "root/a": 5 + 10, "root/a/aa": 5, "-": 20 + 10,
                    "next": 30}
    assert tracing.innermost(spans, [0, 15, 25, 95, 110, 130, 200]) == [0, 1, 2, 0, -1, 4, -1]


def test_sync_warning_counted_in_physics_entry(monkeypatch):
    """A sync debug warning raised inside the physics entry (no child
    span) counts there, once, with its source line; another warning goes
    through as before."""
    check = step_kernel.check_model

    def syncing_check(*args):
        warnings.warn(tracing.SYNC_MESSAGE + " (raised by the test)")
        warnings.warn("an unrelated warning")
        return check(*args)

    monkeypatch.setattr(step_kernel, "check_model", syncing_check)
    trainer = _trainer()
    state, obs = trainer.venv.reset()
    with pytest.warns(UserWarning, match="an unrelated warning") as caught:
        RECORDER.start()
        try:
            trainer.venv.step(state, torch.zeros(N, trainer.env.action_dim))
        finally:
            spans, counters = RECORDER.stop()
    assert not any(tracing.SYNC_MESSAGE in str(w.message) for w in caught)
    by_name = {s.name: s for s in spans}
    assert by_name["physics.entry"].syncs == 1
    assert sum(s.syncs for s in spans) == 1
    assert tracing.totals(spans)["env.step"]["syncs"] == 1
    sites = {k: v for k, v in counters.items() if k.startswith("syncs@")}
    assert counters["syncs"] == 1 and list(sites.values()) == [1]
    assert next(iter(sites)).startswith("syncs@test_torch_tracing.py:")


def test_outputs_equal_with_recorder_on_and_off():
    trainer = _trainer()
    off = _iteration(trainer)
    RECORDER.start()
    try:
        on = _iteration(trainer)
    finally:
        spans, _ = RECORDER.stop()
    assert spans
    for k in off[0]:
        assert torch.equal(off[0][k], on[0][k]), k
    assert all(torch.equal(a, b) for a, b in zip(off[1], on[1]))
    assert all(torch.equal(a, b) for a, b in zip(off[2], on[2]))


def test_chrome_trace_track_on_the_profilers_clock(tmp_path):
    """Spans written into an exported trace sit on its clock: each holds
    the CPU op run inside it."""
    x = torch.randn(300, 300)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        RECORDER.start()
        try:
            for _ in range(3):
                with tracing.span("matmul"):
                    x @ x
        finally:
            spans, _ = RECORDER.stop()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    tracing.add_to_chrome_trace(path, spans)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program"]
    ops = [e for e in events if e.get("name") == "aten::mm"]
    assert len(mine) == len(ops) == 3
    for s, op in zip(mine, ops):
        assert s["ts"] <= op["ts"] and op["ts"] + op["dur"] <= s["ts"] + s["dur"]
        assert s["pid"] == "program spans" and s["args"]["path"] == "matmul"


def test_profile_dir_trace_holds_the_programs_spans(tmp_path):
    """`profile_dir` profiles updates 10-12 (of 14) and writes the recorder's spans
    into the exported trace; the recorder is off again afterwards."""
    cfg = parse_cli(["env_name=Walker3DStepperEnv-v0", "num_processes=4",
                     "episode_steps=8", "mini_batch_size=4", "num_frames=112", "num_tests=0",
                     "ppo_epoch=1", f"experiment_dir={tmp_path / 'run'}",
                     f"profile_dir={tmp_path / 'prof'}"])
    Trainer(cfg, device="cpu").train()
    assert not RECORDER.on
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program"]
    roots = [e for e in mine if "/" not in e["args"]["path"]]
    assert [(e["name"], e["args"]["call"]) for e in roots] == [
        (name, k) for k in range(3)
        for name in ("trainer.curriculum", "trainer.rollout", "trainer.update")]
    assert sum(e["name"] == "rollout.step" for e in mine) == 3 * 2
    assert sum(e["name"] == "ppo.minibatch" for e in mine) == 3 * 2
    mm = [e for e in events if e.get("name") == "aten::addmm"]
    first, last = roots[0], roots[-1]
    assert mm and all(first["ts"] <= e["ts"] <= last["ts"] + last["dur"] for e in mm)


def test_collective_clock_counts_and_spans(recorder):
    """The clock keeps its calls and bytes by kind and times a host tensor
    on the host clock; each collective is a span with its counters."""
    clock = pmesh.CollectiveClock()
    clock.enabled = True
    x = torch.zeros(5, dtype=torch.float32)
    for _ in range(2):
        with clock.time("gradient", x):
            pass
    with clock.time("broadcast", torch.zeros(3, dtype=torch.int64)):
        pass
    spans, counters = RECORDER.stop()
    assert dict(clock.calls) == {"gradient": 2, "broadcast": 1}
    assert dict(clock.bytes) == {"gradient": 40, "broadcast": 24}
    assert set(clock.seconds) == {"gradient", "broadcast"}
    assert all(v >= 0 for v in clock.seconds.values())
    assert [s.name for s in spans] == ["collective.gradient"] * 2 + ["collective.broadcast"]
    assert spans[0].counts == {"collective.gradient.calls": 1, "collective.gradient.bytes": 20}
    assert counters == {"collective.gradient.calls": 2, "collective.gradient.bytes": 40,
                        "collective.broadcast.calls": 1, "collective.broadcast.bytes": 24}


def test_span_probe_at_a_tiny_size():
    """span_probe's slices and their analysis, at 4 envs x 2 steps on the
    CPU (where the profile holds no device operation, so every
    moment is idle)."""
    cpu = torch.device("cpu")
    r = span_probe.train_probe("walker3d", cpu, num_processes=4, episode_steps=8,
                               mini_batch_size=4, num_frames=8, ppo_epoch=1)
    m = r["metrics"]
    assert 0 < m["physics_entry_host_ms"] < m["env_step_host_ms"]
    assert 0 < m["reset_share"] < 1 and m["syncs_per_env_step"] == m["syncs_per_ppo_step"] == 0
    assert r["spans_per_step"] == {"trainer.rollout/rollout.step": 5,
                                   "trainer.update/ppo.minibatch": 4}
    assert set(r["overhead"]) == set(r["overhead_unprofiled"]) == set(
        r["profiler_inflation"]) == {"rollout", "update", "all"}
    assert r["idle_attributed"] > 0.9 and r["launches"] is None
    assert all(p.split("/")[0] in ("rollout", "update") for p in r["idle_ms"])
    assert m["foot_launches_per_env_step"] == 0  # the plain kinematics on the CPU
    assert m["adam_launches_per_ppo_step"] == 0  # the plain optimizer on the CPU
    r = span_probe.eval_probe(cpu, envs=4, steps=2)
    assert r["spans_per_step"] == {"eval.entry/eval.step": 5}
    assert r["metrics"]["foot_launches_per_env_step"] == 0
    assert set(r["overhead"]) == {"steps", "all"}


@pytest.mark.card
def test_span_holds_its_kernel_on_the_profilers_clock(card):
    """Three spans, each around a ~1 ms kernel and a synchronize: each
    holds its kernel's device interval, on the profiler's clock, within
    50 us at either end."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        RECORDER.start()
        try:
            for _ in range(3):
                with tracing.span("kernel"):
                    torch.cuda._sleep(2_000_000)
                    torch.cuda.synchronize()
        finally:
            spans, _ = RECORDER.stop()
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                     if e.device_type() == cuda and not e.is_user_annotation())
    calls = sorted((e.start_ns(), e.name()) for e in events if e.device_type() != cuda)
    assert len(kernels) == 3
    for s, (a, b) in zip(spans, kernels):
        inside = [f"{n} +{(t - s.t0) / US:.1f}" for t, n in calls if s.t0 <= t <= s.t1]
        print(f"span of {(s.t1 - s.t0) / US:.1f} us: kernel {(a - s.t0) / US:.1f} to "
              f"{(b - s.t0) / US:.1f} us in; runtime calls (us in): {inside}")
    for s, (a, b) in zip(spans, kernels):
        assert b - a > 200 * US, (a, b)
        assert s.t0 - 50 * US <= a and b <= s.t1 + 50 * US


@pytest.mark.card
@pytest.mark.parametrize("op", ["item", "tensor", "cpu"])
def test_one_sync_each_on_the_card(card, op):
    x = torch.ones(4, device="cuda")
    y = x * 2
    torch.cuda.synchronize()
    ops = {"item": lambda: y.sum().item(), "tensor": lambda: torch.tensor(0.0, device="cuda"),
           "cpu": lambda: y.cpu()}
    RECORDER.start()
    try:
        with tracing.span(op):
            ops[op]()
    finally:
        spans, counters = RECORDER.stop()
    assert [(s.name, s.syncs) for s in spans] == [(op, 1)]
    assert counters["syncs"] == 1
    assert os.path.basename(__file__) in next(k for k in counters if k.startswith("syncs@"))


def test_value_grid_span_tree_and_counters(recorder):
    """`Trainer.curriculum` on a threshold run's first grid round: the
    value grid's spans nest under `trainer.curriculum` as PERF.md's layer
    table says, its counters add up to B x 121 candidate rows a step and
    to the grid's own event count, and no sync is counted (none on the
    CPU, and the spans add none)."""
    RECORDER.stop()
    cfg = parse_cli(["env_name=Walker3DStepperEnv-v0", "num_processes=4", "episode_steps=16",
                     "mini_batch_size=8", "num_tests=0", "seed=5", "use_threshold_sampling=True"])
    trainer = Trainer(cfg, device="cpu")
    envs, steps = 4, 6
    trainer.value_grid = tcurr.make_value_grid_fn(trainer.env, max_steps=steps, n_envs=envs)
    policy = trainer.init_params()
    strategies = trainer.make_strategies()
    state, _, _, _ = trainer.fresh_fleets(strategies)
    strategies.threshold.uniform_sampling = False
    RECORDER.start()
    trainer.curriculum(strategies, policy, state, None, 1, False)
    spans, counters = RECORDER.stop()
    grid = "trainer.curriculum/curriculum.value_grid"
    step = f"{grid}/value_grid.step"
    assert _tree(spans) == {
        "trainer.curriculum": 1, grid: 1, step: steps, f"{step}/policy": steps, f"{step}/env.step": steps,
        f"{step}/env.step/physics.entry": steps, f"{step}/env.step/env.reset": steps,
        f"{step}/value_grid.candidates": steps, f"{step}/value_grid.critic": steps,
        f"{step}/value_grid.accumulate": steps, "trainer.curriculum/curriculum.install": 1}
    kids = [s.name for s in spans if s.parent >= 0 and spans[s.parent].name == "value_grid.step"]
    assert kids[:5] == ["policy", "env.step", "value_grid.candidates", "value_grid.critic",
                        "value_grid.accumulate"]
    assert counters["value_grid.candidate_rows"] == envs * tterr.GRID ** 2 * steps
    assert counters["value_grid.events"] == trainer.value_grid.last_count
    assert all(s.counts.get("value_grid.candidate_rows") == envs * tterr.GRID ** 2
               for s in spans if s.name == "value_grid.step")
    assert "syncs" not in counters and all(s.syncs == 0 for s in spans)
    # off again: the spans are the shared null span
    assert tracing.span("value_grid.step") is tracing.NULL_SPAN
