"""The value-based curricula in the port's training loop, on the CPU:
`Trainer.train` with threshold sampling (alone, and with value-only
rounds and `first_sampling`) and with adaptive sampling, at a tiny size
(8 envs x 8 steps, episodes cut to 12 steps, a value grid of 4 envs x 24
steps). Each update's installed curriculum and the fan-out calls that
installed it are held to the rules of the JAX loop
(steppingstone_tpu/runtime/train.py:473-520, 564-565, 595-606), written
out below: a JAX Trainer.train of the same config compiles for minutes.
Also the pickles, the heatmap and the resume snapshot's curriculum keys.

Tolerances: the installed level, use_prob and assist are exact; an
installed grid equals the logged probabilities normalized by their sum
(1e-6); the probabilities are softmax(-150 * grid) or
softmax(-150 * |grid - 0.85|) of the logged grid, computed here in
float64 (1e-6)."""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from steppingstone_tpu_torch.envs import terrain as tterr
from steppingstone_tpu_torch.runtime import config as tconfig
from steppingstone_tpu_torch.runtime import curriculum as tcurr
from steppingstone_tpu_torch.runtime.checkpoint import CheckpointManager
from steppingstone_tpu_torch.runtime.train import Trainer
from steppingstone_tpu_torch.viz import sampling_prob as viz

ENV = "Walker3DStepperEnv-v0"
BASE = [f"env_name={ENV}", "num_processes=8", "episode_steps=64", "mini_batch_size=32",
        "ppo_epoch=2", "seed=5", "save_sampling_prob=True", "plot_prob=True"]
FAN_OUTS = ("update_curriculum", "update_assist", "update_specialist", "update_sample_prob")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _run(tmp_path, args):
    """Trainer.train on the CPU, logging for each update the fan-out calls
    on the training fleet since the previous rollout, the curriculum its
    rollout starts from and whether it is value-only, and the test fleet's
    assist at each test. Returns (trainer, updates, test assists)."""
    cfg = tconfig.parse_cli(BASE + args + [f"experiment_dir={tmp_path}"])
    trainer = Trainer(cfg, device="cpu")
    trainer.env.cfg = dataclasses.replace(trainer.env.cfg, max_episode_steps=12)
    trainer.value_grid = tcurr.make_value_grid_fn(trainer.env, max_steps=24, n_envs=4)
    calls, updates, tests = [], [], []
    for name in FAN_OUTS:
        def spy(state, *args, _name=name, _fn=getattr(trainer.venv, name), **kw):
            calls.append((_name,) + tuple(float(a) for a in args if not torch.is_tensor(a))
                         + tuple(None if v is None else float(v) for v in kw.values()))
            return _fn(state, *args, **kw)
        setattr(trainer.venv, name, spy)
    rollout, test_eval = trainer.rollout, trainer._test_eval

    def logged_rollout(policy, env_state, obs, stats, value_only=False, **kw):
        cur = env_state.cur
        updates.append(dict(calls=list(calls), value_only=value_only, level=set(cur.level.tolist()),
                            use_prob=set(cur.use_prob.tolist()), assist=set(cur.assist.tolist()),
                            sample_prob=cur.sample_prob.clone()))
        calls.clear()
        return rollout(policy, env_state, obs, stats, value_only, **kw)

    def logged_test(policy, test_state, test_obs):
        tests.append(set(test_state.cur.assist.tolist()))
        return test_eval(policy, test_state, test_obs)

    trainer.rollout, trainer._test_eval = logged_rollout, logged_test
    trainer.train()
    return trainer, updates, tests


def _pickles(tmp_path):
    def load(what):
        with open(tmp_path / f"{ENV}_{what}.pkl", "rb") as f:
            return pickle.load(f)
    return load("sampling_prob"), load("value_grid")


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()


# the expected (calls since the previous rollout, level, use_prob, assist,
# value_only) of each update, by the JAX loop's rules
CASES = {
    # threshold sampling with the assist ladder gated on the test fleet
    # every update (bar below any mean, ramp 0): update 1 is the uniform
    # round (level 5, the assist kept), then value-grid rounds; after each
    # test the ladder advances and installs its assist
    "threshold": (["use_threshold_sampling=True", "num_tests=2", "test_interval=1",
                   "assist_bar=-1e9", "level_ramp_updates=0", "num_frames=192"], [
        ([("update_assist", 0.0), ("update_curriculum", 5.0, 0.0)], 5.0, False, 0.0, False),
        ([("update_assist", 1.0), ("update_sample_prob",)], 5.0, True, 1.0, False),
        ([("update_assist", 2.0), ("update_sample_prob",)], 5.0, True, 2.0, False),
    ]),
    # value-only rounds every other update (train.py:480-491): the first
    # non-value round installs specialist band 0 before the uniform round
    # overrides it; a value-only round installs level 5 (assist kept)
    # before its value grid; no test fleet, the ladder reads the training
    # mean (below its bar of 700)
    "threshold_value_update": (["use_threshold_sampling=True", "use_value_update=True",
                                "first_sampling=True", "num_tests=0", "num_frames=192"], [
        ([("update_assist", 0.0), ("update_specialist", 0.0), ("update_curriculum", 5.0, 0.0)],
         5.0, False, 0.0, False),
        ([("update_curriculum", 5.0, 0.0), ("update_sample_prob",)], 5.0, True, 0.0, True),
        ([("update_sample_prob",)], 5.0, True, 0.0, False),
    ]),
    # adaptive sampling: a value grid every update, the level untouched
    "adaptive": (["use_adaptive_sampling=True", "num_tests=0", "num_frames=128"], [
        ([("update_assist", 0.0), ("update_sample_prob",)], 0.0, True, 0.0, False),
        ([("update_sample_prob",)], 0.0, True, 0.0, False),
    ]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_value_based_curricula_in_the_loop(tmp_path, case):
    args, expected = CASES[case]
    trainer, updates, tests = _run(tmp_path, args)
    got = [(u["calls"], *u["level"], *u["use_prob"], *u["assist"], u["value_only"])
           for u in updates]
    assert got == expected
    if case == "threshold":
        assert tests == [{0.0}, {1.0}, {2.0}]
    # one logged round per value-grid update, installed as logged
    probs, grids = _pickles(tmp_path)
    rounds = [u for u in updates if ("update_sample_prob",) in u["calls"]]
    assert len(probs) == len(grids) == len(rounds) > 0
    for p, g, u in zip(probs, grids, rounds):
        assert p.shape == g.shape == (tterr.GRID, tterr.GRID) and np.isfinite(g).all()
        metric = g if case == "adaptive" else np.abs(g.astype(np.float64) - 0.85)
        np.testing.assert_allclose(p, _softmax(-150.0 * metric.astype(np.float64).reshape(-1))
                                   .reshape(g.shape), rtol=1e-6, atol=1e-6)
        installed = u["sample_prob"].numpy()
        np.testing.assert_allclose(installed, np.broadcast_to(p / p.sum(), installed.shape),
                                   rtol=1e-6, atol=1e-6)
    png = tmp_path / "sampling_prob.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # the snapshot's curriculum keys hold the strategies' state
    c = CheckpointManager(str(tmp_path / "checkpoints")).restore("latest")["curriculum"]
    n = len(updates)
    assert c["thr_uniform_counter"] == (n + 1 if case != "adaptive" else -1)
    assert c["thr_uniform_sampling"] is False
    assert c["first_sampling"] is False
    assert (c["assist_level"], c["assist_frac"]) == ((3, 3.0) if case == "threshold" else (0, 0.0))
    assert trainer.update_times[-1]["curriculum_s"] >= 0


def test_render_grid_and_cli_write_pngs(tmp_path):
    """viz.sampling_prob: render_grid draws one grid, the CLI the pickled
    list's evolution."""
    rng = np.random.default_rng(0)
    grids = [_softmax(rng.normal(size=121)).reshape(11, 11).astype(np.float32) for _ in range(3)]
    viz.render_grid(grids[0], str(tmp_path / "one.png"))
    with open(tmp_path / "probs.pkl", "wb") as f:
        pickle.dump(grids, f)
    viz.main([str(tmp_path / "probs.pkl"), "--out", str(tmp_path / "all.png"), "--cells", "5,5"])
    for name in ("one.png", "all.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
