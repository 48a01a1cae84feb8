"""Port parity, inference: steppingstone_tpu_torch.runtime.enjoy against the
JAX package's enjoy on the same weights (carried with `params_from_jax`)
and the same draws (the JAX run's, tests/torch_jax_draws.py), on Walker3D
over LargePlank planks (K2's configuration); its trajectory dump against
the JAX dump on the same flags; `load_params` on both kinds of checkpoint;
the specialist switch.

Tolerances: an episode is not teacher forced, so fp32 differences
compound through the contact steps: frames (body positions and
orientations), rewards, actions, values and value grids within 1e-3;
contacts, hits and episode lengths exact."""

import os
import pickle

os.environ["STEPPINGSTONE_NO_COMPILE_CACHE"] = "1"  # before the JAX runtime import

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_draws as draws_mod
from reference_policy import write_reference_policy

from steppingstone_tpu.agents.networks import ActorCritic as JActorCritic
from steppingstone_tpu.envs import make_env as jmake_env
from steppingstone_tpu.envs import terrain as jterr
from steppingstone_tpu.runtime import enjoy as jenjoy
from steppingstone_tpu_torch.agents.networks import ActorCritic, params_from_jax
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.runtime import enjoy
from steppingstone_tpu_torch.runtime.checkpoint import CheckpointManager

N_STONES, N_NOISE = 20, 2 * 21 + 3
EPISODES, MAX_STEPS = 3, 60


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _episode_draws(key, steps):
    """The port's draws of the JAX env.reset(key, level 0) and of the
    steps after it, while the episode goes on (the env key's k_keep
    chain)."""
    prob = np.asarray(jterr.default_curriculum(0).sample_prob)[None]
    reset = draws_mod.reset_draws(key[None], prob, N_STONES, N_NOISE)
    env_key = jax.random.split(key, 4)[2][None]  # the state key env.reset keeps
    step = []
    for _ in range(steps):
        d, env_key, _ = draws_mod.step_draws(env_key, prob, N_STONES, N_NOISE)
        step.append(d)
    return reset, step


def test_run_episode_matches_jax():
    """EPISODES episodes of up to MAX_STEPS from the keys JAX's `main`
    gives them (seed 1093): the untrained policy falls after about 21
    steps, so each ends in a fall and an auto-reset (`final_terrain`)."""
    jenv = jmake_env("Walker3DStepperEnv-v0", plank_class="LargePlank")
    net = JActorCritic(action_dim=21, num_ensembles=2)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 60)))
    env = make_env("Walker3DStepperEnv-v0", device="cpu", plank_class="LargePlank")
    policy = ActorCritic(60, 21, 2, device="cpu")
    policy.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))

    key, steps, grids = jax.random.PRNGKey(1093), 0, 0
    for _ in range(EPISODES):
        key, k = jax.random.split(key)
        ref = jenjoy.run_episode(jenv, net, params, k, MAX_STEPS, True, 0)
        reset, step = _episode_draws(k, MAX_STEPS)
        got = enjoy.run_episode(env, policy, MAX_STEPS, True, 0, reset_draws=reset,
                                step_draws=step)
        assert (got["steps"], got["hits"]) == (ref["steps"], ref["hits"])
        assert got["steps"] < MAX_STEPS  # the episode ended
        for i in range(2):
            np.testing.assert_allclose(np.stack([f[i] for f in got["frames"]]),
                                       np.stack([np.asarray(f[i]) for f in ref["frames"]]),
                                       rtol=1e-3, atol=1e-3)
        for f in ("rewards", "actions", "values", "stones", "final_terrain"):
            np.testing.assert_allclose(got[f], np.asarray(ref[f]), rtol=1e-3, atol=1e-3,
                                       err_msg=f)
            assert got[f].dtype == np.asarray(ref[f]).dtype, f
        np.testing.assert_array_equal(got["contacts"], ref["contacts"])
        assert got["total_reward"] == pytest.approx(ref["total_reward"], rel=1e-3, abs=1e-3)
        assert len(got["value_grids"]) == len(ref["value_grids"])
        for a, b in zip(got["value_grids"], ref["value_grids"]):
            assert a.dtype == np.asarray(b).dtype and a.shape == (11, 11)
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-3)
        steps, grids = steps + got["steps"], grids + len(got["value_grids"])
    assert steps >= 50 and grids >= 1, (steps, grids)


def test_dump_matches_jax_dump(tmp_path, capsys):
    """`main --steps 20 --plot-value --dump` on the CPU writes the JAX
    dump's keys, shapes and dtypes (the default disc config, K1's)."""
    ref_pt = str(tmp_path / "ref.pt")
    write_reference_policy(ref_pt, 60, 21, 2)
    flags = ["--net", ref_pt, "--steps", "20", "--plot-value", "--dump"]
    jenjoy.main(flags + [str(tmp_path / "jax.npz")])
    enjoy.main(flags + [str(tmp_path / "port.npz")], device="cpu")
    out = capsys.readouterr().out
    assert out.count("Env: Walker3DStepperEnv-v0") == 2 and out.count("Model: ref.pt") == 2
    assert out.count("over 20 steps, stones hit:") == 2
    j, t = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(t.files) == sorted(j.files)
    for k in j.files:
        assert (t[k].shape, t[k].dtype) == (j[k].shape, j[k].dtype), k
    np.testing.assert_array_equal(t["body_names"], j["body_names"])
    np.testing.assert_array_equal(t["joint_names"], j["joint_names"])


def _policy(n_critics=2, seed=0):
    return ActorCritic(60, 21, n_critics, device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def _same(state: dict, policy: ActorCritic):
    ref = policy.state_dict()
    assert state.keys() == ref.keys()
    return all(torch.equal(state[k], ref[k]) for k in ref)


def test_load_params_dispatch(tmp_path):
    env = make_env("Walker3DStepperEnv-v0", device="cpu")
    ckpt = CheckpointManager(str(tmp_path / "checkpoints"))
    policy = _policy(3)
    ckpt.save("latest", {"policy": policy.state_dict(), "update": 1})
    for net in ("latest", "latest.pt"):
        state, n = enjoy.load_params(str(tmp_path / "checkpoints" / net), env, 3, "cpu")
        assert n == 3 and _same(state, policy)
    ref_pt = str(tmp_path / "ref.pt")
    sd = write_reference_policy(ref_pt, 60, 21, 11)
    state, n = enjoy.load_params(ref_pt, env, 11, "cpu")
    assert n == 11 and torch.equal(state["critics.10.layers.0.weight"], sd["c10.0.weight"])
    # the two kinds by content: the reference pickle holds classes
    with pytest.raises(pickle.UnpicklingError):
        CheckpointManager.read(ref_pt)

    missing = str(tmp_path / "checkpoints" / "nope")
    with pytest.raises(FileNotFoundError, match="nope"):
        enjoy.load_params(missing, env, 1, "cpu")
    (tmp_path / "junk.pt").write_text("neither kind")
    torch.save({"update": torch.ones(1)}, tmp_path / "tensors.pt")
    (tmp_path / "junk.bin").write_text("neither kind")
    for name in ("junk.pt", "tensors.pt", "junk.bin"):
        with pytest.raises(ValueError, match=name):
            enjoy.load_params(str(tmp_path / name), env, 1, "cpu")
    assert not (tmp_path / "checkpoints" / "nope").exists()


def test_specialists(tmp_path, capsys):
    for n in (1, 3, 5):
        for ns in range(N_STONES):
            band = min(ns * n // N_STONES, n - 1)  # runtime/enjoy.py:87-89 of the JAX package
            assert enjoy.specialist_band(ns, n, N_STONES) == band
    ckpt = CheckpointManager(str(tmp_path / "checkpoints"))
    ckpt.save("latest", {"policy": _policy().state_dict()})
    for k in range(5):
        ckpt.save(f"specialist_{k}", {"policy": _policy(seed=k + 1).state_dict()})
    for net in ("latest", "latest.pt"):
        path = str(tmp_path / "checkpoints" / net)
        found = enjoy.specialist_paths(path)
        assert [os.path.basename(p).split(".")[0] for p in found] == [
            f"specialist_{k}" for k in range(5)]
        enjoy.main(["--net", path, "--use-specialist", "--steps", "3",
                    "--plank-class", "LargePlank"], device="cpu")
        assert "loaded 5 specialists" in capsys.readouterr().out
    os.remove(ckpt.path("specialist_0"))
    os.remove(ckpt.path("specialist_1"))
    assert len(enjoy.specialist_paths(str(tmp_path / "checkpoints" / "latest"))) == 3
    solo = CheckpointManager(str(tmp_path / "solo"))
    solo.save("latest", {"policy": _policy().state_dict()})
    with pytest.raises(SystemExit, match="no specialist"):
        enjoy.main(["--net", solo.path("latest"), "--use-specialist"], device="cpu")

    # the episode acts and values with the band's specialist: at the start
    # (next stone 1 of 20) band 0
    env = make_env("Walker3DStepperEnv-v0", device="cpu")
    specialists = [_policy(seed=k + 1) for k in range(5)]
    cur = enjoy.terr.default_curriculum(0, batch=1)
    draws = env.draw_reset(cur, torch.Generator().manual_seed(0))
    _, obs = env.reset(cur, draws=draws)
    got = enjoy.run_episode(env, _policy(), 2, False, 0, specialists=specialists,
                            reset_draws=draws, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert got["values"][0] == float(specialists[0].value(obs)[0, 0])
        assert got["values"][0] != float(specialists[1].value(obs)[0, 0])
        np.testing.assert_array_equal(got["actions"][0], specialists[0].action_mean(obs)[0])

    # value grids come from the main policy, as in the JAX copy: specialists
    # that share its actor but not its critics act alike and log their own
    # values, while the grids stay the main policy's
    env = make_env("Walker3DStepperEnv-v0", device="cpu", plank_class="LargePlank")
    main_policy = _policy(seed=0)
    twin = _policy(seed=7)
    twin.actor.load_state_dict(main_policy.actor.state_dict())
    runs = [enjoy.run_episode(env, main_policy, 40, True, 0, specialists=spec,
                              generator=torch.Generator().manual_seed(1))
            for spec in (None, [twin] * 5)]
    assert runs[0]["steps"] == runs[1]["steps"] and len(runs[0]["value_grids"]) == 1
    np.testing.assert_array_equal(runs[0]["actions"], runs[1]["actions"])
    assert not np.array_equal(runs[0]["values"], runs[1]["values"])
    np.testing.assert_array_equal(runs[0]["value_grids"][0], runs[1]["value_grids"][0])
