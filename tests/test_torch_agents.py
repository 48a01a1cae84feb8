"""Port parity, agents and the whole slice: steppingstone_tpu_torch's
distributions, networks (with weights carried over by `params_from_jax`)
and rollout against the JAX package, ending with a 10-step
`collect_rollout` of 8 Walker3D envs from a shared reset with the JAX
package's action noise and env draws fed to the port.

Tolerances: the 256-wide MLPs are fp32 matmuls in two libraries (both at
full fp32 precision), so 1e-5 on means/values and 1e-4 on summed
log-probs. The rollout is not teacher forced: the two simulations run
side by side for 10 control steps, so fp32 differences compound through
the contact dynamics (rewards scale position error by 60, see
test_torch_stepper.py). The gap measured on this test's inputs is ~5e-5;
observations, values and rewards are held to 1e-3, which leaves room for
another CPU's rounding. Episode ends and stone hits must agree exactly."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_draws as draws_mod

from steppingstone_tpu.agents import distributions as jdist
from steppingstone_tpu.agents import rollout as jroll
from steppingstone_tpu.agents.networks import ActorCritic as JActorCritic
from steppingstone_tpu.envs import make_env as jmake_env
from steppingstone_tpu.envs.vector import VecEnv as JVecEnv
from steppingstone_tpu.ops import linalg as jla
from steppingstone_tpu_torch.agents import distributions as tdist
from steppingstone_tpu_torch.agents import rollout as troll
from steppingstone_tpu_torch.agents.networks import (
    ActorCritic as TActorCritic, clamped_logstd, params_from_jax)
from steppingstone_tpu_torch.envs import make_env as tmake_env
from steppingstone_tpu_torch.envs.vector import VecEnv as TVecEnv
from steppingstone_tpu_torch.ops import linalg as tla

N = 8
N_STONES = 20
N_NOISE = 2 * 21 + 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _nets(num_ensembles, seed=0, obs_dim=60, act_dim=21):
    net = JActorCritic(action_dim=act_dim, num_ensembles=num_ensembles)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, obs_dim)))
    policy = TActorCritic(obs_dim, act_dim, num_ensembles=num_ensembles, device="cpu")
    policy.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return net, params, policy


@pytest.mark.parametrize("num_ensembles,obs_dim,act_dim",
                         [(1, 60, 21), (2, 60, 21), (2, 51, 10)], ids=["1", "2", "cassie"])
def test_networks_match_jax_with_carried_weights(num_ensembles, obs_dim, act_dim):
    """Walker3D shapes with 1 and 2 critics, and the round-5 Cassie shapes
    (51 observations, 10 actions, heads c0/c1)."""
    net, params, policy = _nets(num_ensembles, obs_dim=obs_dim, act_dim=act_dim)
    assert sorted(k for k in params["params"] if k.startswith("c")) == [
        f"c{i}" for i in range(num_ensembles)]
    obs = np.random.default_rng(0).standard_normal((32, obs_dim)).astype(np.float32)
    with torch.no_grad():
        mean, logstd, value = policy(torch.as_tensor(obs))
        ens = policy.ensemble_values(torch.as_tensor(obs))
    mean_j, logstd_j, value_j = net.apply(params, jnp.asarray(obs))
    ens_j = net.apply(params, jnp.asarray(obs), method="ensemble_values")
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(value_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ens.numpy(), np.asarray(ens_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(logstd.detach().numpy(), np.asarray(logstd_j))
    # log-probs of the same actions under the carried-over policy
    actions = np.random.default_rng(1).uniform(-1, 1, (32, act_dim)).astype(np.float32)
    lp = tdist.log_prob(mean, clamped_logstd(policy).detach(), torch.as_tensor(actions))
    lp_j = jdist.log_prob(mean_j, logstd_j, jnp.asarray(actions))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-4, atol=1e-4)


def test_fresh_networks_have_reference_init():
    """Fresh port networks: torch-default actor init, orthogonal(sqrt 2)
    critics with zero bias, logstd -1.5, and the full 256 widths."""
    policy = TActorCritic(60, 21, device="cpu", generator=torch.Generator().manual_seed(0))
    shapes = [tuple(l.weight.shape) for l in policy.actor.layers]
    assert shapes == [(256, 60)] + [(256, 256)] * 4 + [(21, 256)]
    w = policy.critics[0].layers[1].weight.detach()
    np.testing.assert_allclose((w @ w.T).numpy(), 2.0 * np.eye(256), atol=1e-4)
    assert torch.all(policy.critics[0].layers[0].bias == 0)
    bound = 1 / np.sqrt(60)
    assert policy.actor.layers[0].weight.abs().max() <= bound
    assert torch.all(policy.logstd == -1.5)
    policy.logstd.data.fill_(-4.0)
    assert torch.all(clamped_logstd(policy) == -3.0)


def test_distributions_match_jax():
    rng = np.random.default_rng(2)
    mean = rng.standard_normal((16, 21)).astype(np.float32)
    logstd = rng.uniform(-3, 0, 21).astype(np.float32)
    key = jax.random.PRNGKey(3)
    a_j = jdist.sample(key, jnp.asarray(mean), jnp.asarray(logstd))
    noise = np.array(jax.random.normal(key, mean.shape))
    a_t = tdist.sample(torch.as_tensor(mean), torch.as_tensor(logstd), noise=torch.as_tensor(noise))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tdist.log_prob(*(torch.as_tensor(x) for x in (mean, logstd, np.array(a_j)))).numpy(),
        np.asarray(jdist.log_prob(jnp.asarray(mean), jnp.asarray(logstd), a_j)), rtol=1e-5)
    np.testing.assert_allclose(tdist.entropy(torch.as_tensor(logstd)).numpy(),
                               np.asarray(jdist.entropy(jnp.asarray(logstd))), rtol=1e-6)


def test_mode_matches_jax():
    mean = np.random.default_rng(4).standard_normal((16, 21)).astype(np.float32)
    np.testing.assert_allclose(tdist.mode(torch.as_tensor(mean)).numpy(),
                               np.asarray(jdist.mode(jnp.asarray(mean))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [6, 27])
def test_cholesky_unrolled_matches_jax(n):
    """The lower factor of SPD matrices (Walker3D's 27 dofs among them)."""
    r = np.random.default_rng(n)
    a = r.standard_normal((8, n, n)).astype(np.float32)
    A = (a @ a.transpose(0, 2, 1) / n + np.eye(n, dtype=np.float32)).astype(np.float32)
    L_j = np.asarray(jla.cholesky_unrolled(jnp.asarray(A)))
    L_t = tla.cholesky_unrolled(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(L_t, L_j, rtol=1e-6, atol=1e-6)
    assert np.all(np.triu(L_t, 1) == 0)
    np.testing.assert_allclose(L_t @ L_t.transpose(0, 2, 1), A, atol=1e-5)


def test_collect_rollout_matches_jax():
    """The whole slice: VecEnv + ActorCritic + collect_rollout, 10 control
    steps from a shared reset, the port fed the JAX run's draws."""
    T = 10
    jenv = jmake_env("Walker3DStepperEnv-v0")
    jv = JVecEnv(jenv, N)
    net, params, policy = _nets(1, seed=4)
    state, obs = jv.reset(jax.random.PRNGKey(5))
    key = jax.random.PRNGKey(6)
    run = jax.jit(partial(jroll.collect_rollout, jv.step, net.apply, num_steps=T))
    st_j, obs_j, stats_j, traj_j, aux_j = run(params, state, obs, jroll.EpisodeStats.init(N), key)

    # the draws of that run: action noise from the rollout's key chain, env
    # draws from each env's key chain (which forks at episode ends)
    action_noise, env_draws = draws_mod.rollout_draws(
        key, state.key, state.cur.sample_prob, aux_j["ep_done"], T, N, 21, N_STONES, N_NOISE)

    tv = TVecEnv(tmake_env("Walker3DStepperEnv-v0", device="cpu"), N, device="cpu")
    st_t, obs_t, stats_t, traj_t, aux_t = troll.collect_rollout(
        tv, policy, draws_mod.to_port_state(state), torch.as_tensor(np.array(obs)),
        troll.EpisodeStats.init(N), T, action_noise=action_noise, env_draws=env_draws)

    traj_j = jax.tree.map(np.asarray, traj_j)
    for f in ("masks", "bad_masks"):
        np.testing.assert_array_equal(getattr(traj_t, f).numpy(), getattr(traj_j, f), err_msg=f)
    for f in ("obs", "actions", "log_probs", "values", "rewards"):
        np.testing.assert_allclose(getattr(traj_t, f).numpy(), getattr(traj_j, f),
                                   rtol=1e-3, atol=1e-3, err_msg=f)
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), rtol=1e-3, atol=1e-3)
    assert int(aux_t["hits"]) == int(aux_j["hits"])
    np.testing.assert_array_equal(aux_t["ep_done"].numpy(), np.asarray(aux_j["ep_done"]))
    np.testing.assert_array_equal(stats_t.valid.numpy(), np.asarray(stats_j.valid))
    np.testing.assert_array_equal(stats_t.length.numpy(), np.asarray(stats_j.length))
    np.testing.assert_allclose(stats_t.ret.numpy(), np.asarray(stats_j.ret), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(st_t.next_step_index.numpy(),
                                  np.asarray(st_j.next_step_index))
    assert int(aux_t["hits"]) > 0


def test_evaluate_is_deterministic():
    tv = TVecEnv(tmake_env("Walker3DStepperEnv-v0", device="cpu"), 4, device="cpu")
    policy = TActorCritic(60, 21, device="cpu", generator=torch.Generator().manual_seed(1))
    state, obs = tv.reset()
    runs = [troll.evaluate(tv, policy, state, obs, 5)[1] for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
