"""Port parity, the training loop: steppingstone_tpu_torch's schedules,
progress.csv logger, experiment directory and curricula against the JAX
package's on the same inputs, its checkpoints, and `Trainer.train` run
end to end on the CPU (tests/test_runtime.py's tiny run and its
resume-is-total check; no JAX Trainer.train runs here, its compile is what
makes tests/test_runtime.py slow).

Tolerances: the schedules, the logger's bytes, configs.json, the
curricula's (level, frac, advanced) sequences and installed fields are
exact; a resumed run's progress.csv is held to tests/test_runtime.py's
rel 1e-5 / abs 1e-6 (every column but fps)."""

import dataclasses
import json
import os
import pickle
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steppingstone_tpu.envs import make_env as jmake_env
from steppingstone_tpu.envs import terrain as jterr
from steppingstone_tpu.envs.vector import VecEnv as JVecEnv
from steppingstone_tpu.runtime import config as jconfig
from steppingstone_tpu.runtime import curriculum as jcurr
from steppingstone_tpu.runtime import loggers as jloggers
from steppingstone_tpu.runtime import schedules as jsched
from steppingstone_tpu_torch.agents.ppo import init_optimizer
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.envs import terrain as tterr
from steppingstone_tpu_torch.envs.vector import VecEnv
from steppingstone_tpu_torch.runtime import checkpoint as tckpt
from steppingstone_tpu_torch.runtime import config as tconfig
from steppingstone_tpu_torch.runtime import curriculum as tcurr
from steppingstone_tpu_torch.runtime import loggers as tloggers
from steppingstone_tpu_torch.runtime import schedules as tsched
from steppingstone_tpu_torch.runtime.train import Trainer

N = 8
HEADER = ["iter", "total_num_steps", "fps", "entropy", "value_loss", "action_loss",
          "mean_rew", "median_rew", "min_rew", "max_rew", "test_mean_rew", "test_median_rew",
          "test_min_rew", "test_max_rew"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_schedules_match_jax():
    for epoch in (0, 1, 7, 50, 99, 100, 10_000):
        for total in (1, 100, 488):
            for init, final in ((3e-4, 0.0), (1.0, 0.25), (3e-4, 3e-5)):
                assert tsched.linear_decay(epoch, total, init, final) == jsched.linear_decay(
                    epoch, total, init, final)
                for rate in (0.99, 0.5):
                    assert tsched.exponential_decay(epoch, rate, init, final) == (
                        jsched.exponential_decay(epoch, rate, init, final))


def _epochs():
    """A log_epoch sequence: fresh test stats, a stale (blank) interval,
    an empty test fleet, and an update with one training episode."""
    def epoch(it, rew, test_rew):
        return dict(iter=it, total_num_steps=100 * it, fps=10, entropy=-1.7, value_loss=12.5,
                    action_loss=0.01, stats={"rew": rew}, test_stats={"rew": test_rew})

    return [epoch(1, np.array([1.0, 2.5, 4.0]), np.array([3.0, 5.0])),
            epoch(2, np.array([2.0, 3.0]), None),
            epoch(3, np.array([7.25]), np.zeros(0))]


def _log(module, log_dir, epochs, **kw):
    lg = module.ConsoleCSVLogger(str(log_dir), console_log_interval=1, **kw)
    for e in epochs:
        lg.log_epoch(dict(e))
    lg.close()


def test_progress_csv_matches_jax(tmp_path, capsys):
    """The same log_epoch sequence gives byte-identical progress.csv files
    (reference header, blank stale test columns) and console lines."""
    _log(jloggers, tmp_path / "jax", _epochs())
    ref_out = capsys.readouterr().out
    _log(tloggers, tmp_path / "port", _epochs())
    assert capsys.readouterr().out == ref_out
    ours = (tmp_path / "port" / "progress.csv").read_bytes()
    assert ours == (tmp_path / "jax" / "progress.csv").read_bytes()
    rows = ours.decode().splitlines()
    assert rows[0].split(",") == HEADER
    assert rows[2].split(",")[-4:] == ["", "", "", ""]


def test_logger_truncates_unless_resuming(tmp_path, capsys):
    """A fresh logger on an existing file moves it aside (.bak) and starts
    anew; a resumed one appends: the same files, byte for byte, as JAX's."""
    for name, module in (("jax", jloggers), ("port", tloggers)):
        d = tmp_path / name
        _log(module, d, _epochs()[:2])
        _log(module, d, _epochs()[:1])
        _log(module, d, _epochs()[2:], resume=True)
    capsys.readouterr()
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) == ["progress.csv", "progress.csv.bak"]
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    assert len((tmp_path / "port" / "progress.csv").read_text().splitlines()) == 3


def test_init_experiment_matches_jax(tmp_path, capsys):
    """Identical configs.json (the replicate seed offset, derived values,
    inert keys) and run.json with the same keys and divergences."""
    kw = dict(experiment_dir=str(tmp_path / "exp"), replicate_num=3, num_processes=10,
              episode_steps=100, num_frames=1000, use_curriculum=True, test_curriculum=True)
    out = {}
    for name, module in (("jax", jconfig), ("port", tconfig)):
        cfg = module.TrainConfig(**kw)
        assert module.init_experiment(cfg) == kw["experiment_dir"] and cfg.seed == 8 + 20
        out[name] = (capsys.readouterr().out,
                     (tmp_path / "exp" / "configs.json").read_bytes(),
                     json.loads((tmp_path / "exp" / "run.json").read_text()))
    (log_j, cfg_j, run_j), (log_t, cfg_t, run_t) = out["jax"], out["port"]
    assert log_t == log_j and "test_curriculum" in log_t
    assert cfg_t == cfg_j
    assert sorted(run_t) == sorted(run_j)
    for k in ("host", "python", "argv", "reference_divergences", "commit"):
        assert run_t.get(k) == run_j.get(k), k


def test_specialist_band_prob_matches_jax():
    for k in range(-1, tterr.N_LEVELS + 1):
        ours = tterr.specialist_band_prob(k).numpy()
        np.testing.assert_array_equal(ours, np.asarray(jterr.specialist_band_prob(k)))
        assert ours.dtype == np.float32


class _JState(NamedTuple):
    """Stands in for the JAX EnvState: the fan-outs touch only `cur`."""

    cur: Any


def _fleets():
    jcur = jax.tree.map(lambda x: jnp.broadcast_to(x, (N,) + x.shape), jterr.default_curriculum())
    venv = VecEnv(make_env("Walker3DStepperEnv-v0", device="cpu"), N, device="cpu", seed=0)
    state, _ = venv.reset()
    return JVecEnv(jmake_env("Walker3DStepperEnv-v0"), N), _JState(jcur), venv, state


def _assert_cur_equal(port_state, jax_state):
    for f in jterr.CurriculumState._fields:
        ours = getattr(port_state.cur, f).numpy()
        np.testing.assert_array_equal(ours, np.asarray(getattr(jax_state.cur, f)), err_msg=f)


REWARDS = [500.0, 1200.0, 1100.0, 900.0, 1300.0, 650.0, 1300.0, 1300.0, 800.0, 1300.0,
           1300.0, 1300.0, 1300.0, 1300.0, 1300.0, 1300.0]


@pytest.mark.parametrize("case", ["ramp", "step", "assist_only", "specialist"])
def test_curricula_match_jax(case, capsys):
    """FixedCurriculum (a 2-update ramp, the reference's step change, the
    assist-only ladder at bar 700) and SpecialistSchedule driven by the
    same mean-reward sequence: the same (level, frac, advanced) sequence
    and the same installed curriculum fields on an 8-env fleet."""
    jvenv, jstate, tvenv, tstate = _fleets()
    if case == "specialist":
        jc, tc = jcurr.SpecialistSchedule(jvenv), tcurr.SpecialistSchedule(tvenv)
    else:
        kw = dict(ramp_updates=0 if case == "step" else 2 if case == "ramp" else 3,
                  assist_only=case == "assist_only", bar=700.0 if case == "assist_only" else 1000.0)
        jc, tc = jcurr.FixedCurriculum(jvenv, **kw), tcurr.FixedCurriculum(tvenv, **kw)
    jstate, tstate = jc.install(jstate), tc.install(tstate)
    _assert_cur_equal(tstate, jstate)
    seq_j, seq_t, saved_j, saved_t = [], [], [], []
    for rew in REWARDS:
        if case == "specialist":
            jstate = jc.post_update(jstate, rew, save_fn=saved_j.append)
            tstate = tc.post_update(tstate, rew, save_fn=saved_t.append)
            seq_j.append(jc.specialist)
            seq_t.append(tc.specialist)
        else:
            jstate, tstate = jc.tick(jstate), tc.tick(tstate)
            jstate, adv_j = jc.post_update(jstate, rew)
            tstate, adv_t = tc.post_update(tstate, rew)
            seq_j.append((jc.level, jc.frac, adv_j))
            seq_t.append((tc.level, tc.frac, adv_t))
        _assert_cur_equal(tstate, jstate)
    assert seq_t == seq_j and saved_t == saved_j
    assert seq_t[-1] == (5 if case == "specialist" else (5, 5.0, False))
    lines = capsys.readouterr().out.splitlines()
    word = "assist" if case == "assist_only" else "curriculum"
    assert lines == ([] if case == "specialist"
                     else [f"{word} {k}" for k in range(1, 6) for _ in ("jax", "port")])


def test_checkpoint_round_trip(tmp_path):
    """A snapshot with NamedTuples (EnvState, AdamState), a state_dict,
    generator states and scalars comes back equal; the written snapshot is
    a copy; restoring a generator state replays its draws; a layout that
    differs raises, naming the file."""
    venv = VecEnv(make_env("Walker3DStepperEnv-v0", device="cpu"), 4, device="cpu", seed=1)
    state, obs = venv.reset()
    tr = Trainer(tconfig.TrainConfig(env_name="Walker3DStepperEnv-v0", num_processes=4,
                                     episode_steps=8, num_frames=8, num_tests=0), device="cpu")
    policy = tr.init_params()
    snap = {"policy": policy.state_dict(), "opt_state": init_optimizer(policy),
            "env_state": state, "obs": obs, "generators": {"venv": venv.generator.get_state()},
            "update": 7, "max_ep_reward": 3.5, "curriculum": {"fixed_level": 2, "thr": False}}
    draws = torch.rand(5, generator=venv.generator)
    policy.logstd.data.fill_(-1.5)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save("latest", snap)
    policy.logstd.data.fill_(0.0)  # the written snapshot is a copy
    mgr.save("specialist_0", {"policy": policy.state_dict()})
    assert mgr.exists("latest") and mgr.tags() == ["latest", "specialist_0"]
    back = mgr.restore_like("latest", snap)
    assert type(back["env_state"]) is type(state)
    assert type(back["env_state"].phys) is type(state.phys)
    for name, a, b in (("q", back["env_state"].phys.q, state.phys.q), ("obs", back["obs"], obs),
                       ("level", back["env_state"].cur.level, state.cur.level),
                       ("mu", back["opt_state"].mu, snap["opt_state"].mu)):
        assert torch.equal(a, b), name
    assert (back["update"], back["max_ep_reward"], back["curriculum"]) == (
        7, 3.5, {"fixed_level": 2, "thr": False})
    assert torch.all(back["policy"]["logstd"] == -1.5)
    g = torch.Generator().manual_seed(99)
    g.set_state(back["generators"]["venv"])
    assert torch.equal(torch.rand(5, generator=g), draws)
    bad = dict(snap, extra=1)
    with pytest.raises(ValueError, match="latest.pt"):
        mgr.restore_like("latest", bad)


def _train(tmp_path, name, args, max_episode_steps):
    """Trainer(cfg, device="cpu").train() with short episodes (the test
    fleet evaluates one episode length per test) and, for the value-based
    curricula, a value grid of 4 envs x 24 steps, returning the trainer."""
    cfg = tconfig.parse_cli(args + [f"experiment_dir={tmp_path / name}"])
    trainer = Trainer(cfg, device="cpu")
    trainer.env.cfg = dataclasses.replace(trainer.env.cfg, max_episode_steps=max_episode_steps)
    if trainer.value_grid is not None:
        trainer.value_grid = tcurr.make_value_grid_fn(trainer.env, max_steps=24, n_envs=4)
    trainer.train()
    return trainer


def _progress(path):
    rows = path.read_text().strip().splitlines()
    header = rows[0].split(",")
    return header, {int(r.split(",")[0]): dict(zip(header, r.split(","))) for r in rows[1:]}


def test_tiny_training_run(tmp_path, capsys):
    """2 updates of 8 envs x 16 steps with the fixed curriculum and a
    4-env test fleet every update: progress.csv with the reference header
    and a row per update, configs.json, run.json, episodes.csv and the
    latest / best / numbered checkpoints."""
    args = ["env_name=Walker3DStepperEnv-v0", "num_processes=8", "episode_steps=128",
            "mini_batch_size=64", "num_frames=256", "num_tests=4", "test_interval=1",
            "use_curriculum=True", "seed=1", "checkpoint_interval=1", "episode_log=True"]
    trainer = _train(tmp_path, "run", args, max_episode_steps=16)
    run = tmp_path / "run"
    header, rows = _progress(run / "progress.csv")
    assert header == HEADER and sorted(rows) == [1, 2]
    for r in rows.values():
        assert all(np.isfinite(float(r[c])) for c in HEADER)
    assert (run / "configs.json").exists() and (run / "run.json").exists()
    assert (run / "episodes.csv").read_text().startswith("r,l,t\n")
    assert sorted(os.listdir(run / "checkpoints")) == ["10000000.pt", "best.pt", "latest.pt"]
    assert [t["update"] for t in trainer.update_times] == [1, 2]
    assert "Updates 2, num timesteps 256" in capsys.readouterr().out


# the curriculum of each resume case: the fixed curriculum advancing with
# a 2-update ramp, or threshold sampling (a uniform round, then value
# grids) with the assist ladder advancing on the test fleet, a 3-update
# ramp in flight across the resume
RESUME_CASES = {
    "fixed": ["use_curriculum=True", "curriculum_bar=-1000", "level_ramp_updates=2"],
    "threshold": ["use_threshold_sampling=True", "save_sampling_prob=True",
                  "assist_bar=-1000", "level_ramp_updates=3"],
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_is_total(tmp_path, case):
    """2 updates + a resume for 2 more == one unbroken 4-update run: every
    progress.csv column but fps, with the curriculum advancing (a ramp in
    flight across the resume) and a test fleet every 3 updates. Threshold
    sampling also restores its round counter and the value grid's
    generator; its pickles, rewritten by each call, hold the resumed call's
    rounds only (as the JAX package's do)."""
    base = ["env_name=Walker3DStepperEnv-v0", "num_processes=8", "episode_steps=64",
            "mini_batch_size=32", "ppo_epoch=2", "num_tests=2", "test_interval=3",
            *RESUME_CASES[case], "seed=3", "checkpoint_interval=1"]
    _train(tmp_path, "a", base + ["num_frames=256"], max_episode_steps=12)
    _train(tmp_path, "b", base + ["num_frames=128"], max_episode_steps=12)
    resumed = _train(tmp_path, "b", base + ["num_frames=256", "resume=True"],
                     max_episode_steps=12)
    assert resumed.start_update == 2
    # the curricula's state at the end: the resumed run restored it whole
    latest = [tckpt.CheckpointManager(str(tmp_path / run / "checkpoints")).restore("latest")
              for run in ("a", "b")]
    assert latest[1]["curriculum"] == latest[0]["curriculum"]
    header, rows_a = _progress(tmp_path / "a" / "progress.csv")
    _, rows_b = _progress(tmp_path / "b" / "progress.csv")
    assert sorted(rows_a) == sorted(rows_b) == [2, 3, 4]
    assert rows_a[4]["test_mean_rew"] != "" and rows_a[3]["test_mean_rew"] == ""
    for it in rows_a:
        for col in header:
            if col == "fps":
                continue
            a, b = rows_a[it][col], rows_b[it][col]
            if a == "" or b == "":
                assert a == b, (it, col)
                continue
            assert float(a) == pytest.approx(float(b), rel=1e-5, abs=1e-6), (it, col)
    if case == "threshold":
        def grids(run, what):
            with open(tmp_path / run / f"Walker3DStepperEnv-v0_{what}.pkl", "rb") as f:
                return pickle.load(f)

        for what in ("sampling_prob", "value_grid"):
            unbroken, after_resume = grids("a", what), grids("b", what)
            # rounds 2-4 are value-grid rounds; the resumed call logged 3 and 4
            assert len(unbroken) == 3 and len(after_resume) == 2
            assert np.abs(np.stack(unbroken)).max() > 0  # the grids scored hit events
            np.testing.assert_allclose(np.stack(after_resume), np.stack(unbroken[1:]),
                                       rtol=1e-5, atol=1e-6)
