"""Port parity, the slice as a whole: steppingstone_tpu_torch's
`TrainConfig` against the JAX package's, and one `Trainer.train_iteration`
on the round-5 Cassie configuration (CassieStepper-v1, LargePlank, the
phase mirror, 2 critics, the KL guard) against JAX's
`Trainer._train_iteration_impl` from the same parameters, optimizer state
and env state, the JAX run's action noise, env draws and minibatch
permutations fed to the port (tests/torch_jax_draws.py). 8 envs x 8
steps, 2 epochs x 2 minibatches.

Tolerances: the rollout is not teacher forced, so fp32 differences
compound through 8 control steps of contact and stable PD (rewards scale
position error by 60): rollout fields are held to 1e-3, episode ends and
hits exactly. The update then runs 4 Adam steps on those batches; the
parameters after it are held to 1e-3."""

import dataclasses
import os

os.environ["STEPPINGSTONE_NO_COMPILE_CACHE"] = "1"  # before the JAX runtime import

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_draws as draws_mod

from steppingstone_tpu.agents.rollout import EpisodeStats as JStats
from steppingstone_tpu.runtime import config as jconfig
from steppingstone_tpu.runtime.train import Trainer as JTrainer
from steppingstone_tpu_torch.agents import networks as tnet
from steppingstone_tpu_torch.agents import ppo as tppo
from steppingstone_tpu_torch.agents.rollout import EpisodeStats as TStats
from steppingstone_tpu_torch.runtime import config as tconfig
from steppingstone_tpu_torch.runtime.train import IterationDraws, Trainer

N, T = 8, 8
CASSIE = dict(env_name="CassieStepper-v1", plank_class="LargePlank", use_phase_mirror=True,
              num_ensembles=2, kl_cutoff=0.12, num_processes=N, episode_steps=N * T,
              mini_batch_size=N * T // 2, ppo_epoch=2, num_tests=0, num_frames=N * T)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_train_config_matches_jax():
    """Every field and default, the derived values, the checks and the
    k=v override grammar of the port's own TrainConfig copy."""
    fj = [(f.name, f.default) for f in dataclasses.fields(jconfig.TrainConfig)]
    ft = [(f.name, f.default) for f in dataclasses.fields(tconfig.TrainConfig)]
    assert ft == fj
    argv = ["with", "env_name=CassieStepper-v1", "plank_class=LargePlank", "num_ensembles=2",
            "use_phase_mirror=True", "kl_cutoff=0.12", "num_processes=4096",
            "episode_steps=409600", "mini_batch_size=4096", "net=none", "num_frames=2e8"]
    cj, ct = jconfig.parse_cli(argv), tconfig.parse_cli(argv)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert (ct.num_steps, ct.num_mini_batch, ct.num_updates) == (
        cj.num_steps, cj.num_mini_batch, cj.num_updates) == (100, 100, 488)
    assert ct.inert_keys() == cj.inert_keys()
    assert ct.reference_divergences() == cj.reference_divergences()
    for bad in (dict(episode_steps=1001, num_processes=100), dict(advance_on_test=True),
                dict(final_logstd=-2.5), dict(final_logstd=-3.5, anneal_updates=10)):
        with pytest.raises(ValueError):
            dataclasses.replace(tconfig.TrainConfig(), **bad).validate()
    with pytest.raises(SystemExit, match="unknown config key"):
        tconfig.parse_cli(["no_such_key=1"])


def test_trainer_refuses_warm_start_and_builds_the_cassie_config():
    tr = Trainer(tconfig.TrainConfig(**CASSIE), device="cpu")
    assert (tr.env.cfg.name, tr.env.cfg.support, tr.env.cfg.plank_hy) == (
        "CassieStepper-v1", "plank", 1.5)
    assert tr.ppo_cfg.mirror is None and tr.ppo_cfg.kl_cutoff == 0.12
    assert tr.ppo_cfg.num_mini_batch == 2 and tr.venv.num_envs == N
    policy = tr.init_params()
    assert len(policy.critics) == 2 and policy.logstd.shape == (10,)
    tr = Trainer(tconfig.TrainConfig(**{**CASSIE, "use_mirror": True, "net": "x.pt"}), device="cpu")
    assert tr.ppo_cfg.mirror is not None
    # warm starts are ported: a `net` that names no checkpoint is refused,
    # naming the path
    with pytest.raises(FileNotFoundError, match="x.pt"):
        tr.init_params()


def test_train_iteration_matches_jax():
    jt = JTrainer(jconfig.TrainConfig(mesh_devices=1, **CASSIE))
    params = jt.init_params(jax.random.PRNGKey(0))
    opt_state = jt.tx.init(params)
    env_state, obs = jt.venv.reset(jax.random.PRNGKey(1))
    env_state = jt.venv.set_mirror(env_state, True)
    # start mid gait cycle (the mirrored half begins at step 3), with two
    # envs 5 steps from the time limit and two 5 steps from the stall
    # timeout, so the rollout holds mirrored steps, time-limit ends
    # (bad_masks) and falls
    i32 = lambda x: jnp.asarray(x, jnp.int32)
    env_state = env_state._replace(
        phase=jnp.full((N,), 0.4, jnp.float32),
        elapsed=i32([995, 995, 300, 300, 0, 0, 0, 0]),
        last_hit=i32([995, 995, 125, 125, 0, 0, 0, 0]))
    key, lr = jax.random.PRNGKey(2), 3e-4
    host = jax.tree.map(np.array, (params, opt_state, env_state, obs))

    out = jax.jit(jt._train_iteration_impl)(params, opt_state, env_state, obs, JStats.init(N),
                                            key, jnp.asarray(lr, jnp.float32))
    p_j, o_j, st_j, obs_j, stats_j, _, m_j, aux_j = jax.tree.map(np.asarray, out)

    # the run's draws: its rollout and update keys split as the JAX impl does
    _, k_roll, k_upd = jax.random.split(key, 3)
    noise, env_draws = draws_mod.rollout_draws(
        k_roll, env_state.key, env_state.cur.sample_prob, aux_j["ep_done"], T, N, 10, 20,
        2 * 14 + 3)
    perms = draws_mod.ppo_perms(k_upd, N * T, 2, N * T)

    tr = Trainer(tconfig.TrainConfig(**CASSIE), device="cpu")
    policy = tr.init_params()
    policy.load_state_dict(tnet.params_from_jax(host[0]))
    opt_t = tppo.adam_state_from_jax(host[1], policy)
    state_t = draws_mod.to_port_state(host[2])
    policy, opt_t, st_t, obs_t, stats_t, m_t, aux_t = tr.train_iteration(
        policy, opt_t, state_t, torch.as_tensor(host[3]), TStats.init(N), lr,
        draws=IterationDraws(noise, env_draws, perms))

    np.testing.assert_array_equal(aux_t["ep_done"].numpy(), aux_j["ep_done"])
    assert int(aux_t["hits"]) == int(aux_j["hits"])
    np.testing.assert_allclose(aux_t["ep_return"].numpy(), aux_j["ep_return"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(obs_t.numpy(), obs_j, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(st_t.phys.q.numpy(), st_j.phys.q, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(st_t.phys.qd.numpy(), st_j.phys.qd, rtol=1e-3, atol=1e-2)
    np.testing.assert_array_equal(st_t.next_step_index.numpy(), st_j.next_step_index)
    np.testing.assert_allclose(st_t.phase.numpy(), st_j.phase, atol=1e-6)
    np.testing.assert_array_equal(stats_t.valid.numpy(), stats_j.valid)
    np.testing.assert_allclose(stats_t.ret.numpy(), stats_j.ret, rtol=1e-3, atol=1e-3)
    for f in m_t._fields:
        np.testing.assert_allclose(float(getattr(m_t, f)), float(getattr(m_j, f)),
                                   rtol=1e-3, atol=1e-3, err_msg=f)
    ref = tnet.params_from_jax(p_j)
    for name, p in policy.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1e-3, atol=1e-3,
                                   err_msg=name)
    assert int(opt_t.count) == 4
    # the run covered both kinds of episode end
    ends = aux_t["ep_done"].sum(dim=0).numpy()
    assert ends[:4].min() >= 1, ends
    np.testing.assert_array_equal(stats_t.length.numpy()[:2], [1000, 1000])
