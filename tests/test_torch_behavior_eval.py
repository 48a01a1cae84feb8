"""Port parity, behavior evaluation: steppingstone_tpu_torch.runtime.
behavior_eval against scripts/behavior_eval.py on the same policy, a JAX
params-only checkpoint carried over by scripts/jax_ckpt_to_port.py, and
the same draws: the reset draws of split(PRNGKey(7), N) and, per env, the
step draws of its key chain, forked where the port's own episodes end (as
tests/torch_jax_draws.py `rollout_draws` forks), so a fork that differs
shows in the report. One disc level, and the specialist bands on
LargePlank with their own checkpoints (on a short track too, through
`compare_reports`, in tests/test_torch_behavior_eval_track_end.py).

Tolerances: the rollout is not teacher forced; integer fields equal,
floats within 1e-3 or one unit of the key's rounding."""

import json
import os
import runpy
import sys

os.environ["STEPPINGSTONE_NO_COMPILE_CACHE"] = "1"  # before the JAX runtime import

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_draws as draws_mod

from steppingstone_tpu.agents.networks import ActorCritic as JActorCritic
from steppingstone_tpu.runtime.checkpoint import CheckpointManager as JCheckpoints
from steppingstone_tpu_torch.runtime import behavior_eval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
N_ENVS, STEPS = 4, 30
N_STONES, N_NOISE = 20, 2 * 21 + 3
# each float key's rounding unit (scripts/behavior_eval.py)
UNITS = {"fall_rate": 1e-3, "walked_whole_track_rate": 1e-3, "fall_before_end_rate": 1e-3,
         "stones_per_episode": 1e-2, "mean_episode_reward": 0.1, "median_episode_reward": 0.1,
         "mean_episode_len": 0.1, "reward_per_step": 1e-2, "mean_final_next_step_index": 0.1,
         "mean_final_x_m": 0.1}
INTS = ("episodes_completed", "falls", "walked_whole_track", "falls_before_track_end",
        "stone_hits_total")
BANDS = ["--bands", "2", "--specialists", "--plank_class", "LargePlank"]
CASES = {"level": ["--levels", "2"], "bands": BANDS}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A JAX run directory with params-only tags (latest, specialist_0,
    specialist_2; seeded ActorCritic.init, each its own), and its port
    conversion."""
    base = tmp_path_factory.mktemp("behavior")
    jax_run, port_run = str(base / "jax"), str(base / "port")
    net = JActorCritic(action_dim=21, num_ensembles=1)
    mgr = JCheckpoints(os.path.join(jax_run, "checkpoints"))
    for seed, tag in enumerate(("latest", "specialist_0", "specialist_2")):
        params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 60)))
        mgr.save(tag, {"params": jax.tree.map(np.asarray, params)})
    runpy.run_path(os.path.join(SCRIPTS, "jax_ckpt_to_port.py"))["main"](
        [os.path.join(jax_run, "checkpoints"), "--out", os.path.join(port_run, "checkpoints")])
    return jax_run, port_run


def jax_draws(n_stones):
    """`main`'s draws: for each entry, (reset draws, step-draws callable)
    of the JAX script's entry on an `n_stones` track: env keys
    split(PRNGKey(7), N), each env's key chain forked at the done flags the
    port hands the callable."""

    def entry(label, cur):
        keys = jax.random.split(jax.random.PRNGKey(7), N_ENVS)
        prob = cur.sample_prob.numpy()
        reset = draws_mod.reset_draws(keys, prob, n_stones, N_NOISE)
        chain = {"keys": jax.vmap(lambda k: jax.random.split(k, 4)[2])(keys), "next": None}

        def step(done):
            if done is not None:
                k_keep, k_state = chain["next"]
                chain["keys"] = jnp.where(done.numpy()[:, None], k_state, k_keep)
            d, k_keep, k_state = draws_mod.step_draws(chain["keys"], prob, n_stones, N_NOISE)
            chain["next"] = (k_keep, k_state)
            return d

        return reset, step

    return entry


def compare_reports(runs, case_flags, env_kw, tmp_path, monkeypatch, capsys):
    """Both scripts on `runs` with `case_flags`, `env_kw` overriding both
    packages' make_env; with overrides, the JAX report must show a
    timeout, an episode ended at the track's end and a fall there."""
    jax_run, port_run = runs
    flags = ["--envs", str(N_ENVS), "--steps", str(STEPS)] + case_flags
    if env_kw:
        import steppingstone_tpu.envs as jenvs  # the JAX script imports make_env from here

        for module in (jenvs, behavior_eval):
            make = module.make_env
            monkeypatch.setattr(module, "make_env",
                                lambda *a, _make=make, **k: _make(*a, **env_kw, **k))
    ref_out = str(tmp_path / "jax.json")
    monkeypatch.setattr(sys, "argv", ["behavior_eval.py", jax_run, "--platform", "cpu",
                                      "--out", ref_out] + flags)
    runpy.run_path(os.path.join(SCRIPTS, "behavior_eval.py"), run_name="__main__")
    with open(ref_out) as f:
        ref = json.load(f)
    out = str(tmp_path / "port.json")
    got = behavior_eval.main([port_run, "--out", out] + flags, device="cpu",
                             draws=jax_draws(env_kw.get("n_stones", N_STONES)))
    with open(out) as f:
        assert json.load(f) == got
    assert capsys.readouterr().out.endswith(json.dumps(got, indent=2) + "\n")
    assert set(got) == set(ref)
    for k in set(ref) - {"run"}:
        if not isinstance(ref[k], dict):
            assert got[k] == ref[k], k
            continue
        assert set(got[k]) == set(ref[k]) and len(ref[k]) == 15, k
        assert ref[k]["episodes_completed"] >= 1, "no episode ended inside the window"
        if env_kw:
            # a timeout, a fall, and an episode ended at the track's end
            assert ref[k]["falls"] < ref[k]["episodes_completed"], k
            assert ref[k]["walked_whole_track"] >= 1, k
            assert ref[k]["falls"] > ref[k]["falls_before_track_end"], k
        for name in INTS:
            assert got[k][name] == ref[k][name], (k, name, got[k][name], ref[k][name])
        for name, unit in UNITS.items():
            a, b = got[k][name], ref[k][name]
            if b is None:
                assert a is None, (k, name)
            else:
                assert abs(a - b) <= max(1e-3, unit) + 1e-9, (k, name, a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_report_matches_jax_script(runs, case, tmp_path, monkeypatch, capsys):
    compare_reports(runs, CASES[case], {}, tmp_path, monkeypatch, capsys)
