"""The port's forward step as a unit (steppingstone_tpu_torch/entry.py)
against the JAX package's `__graft_entry__.entry`, on the CPU.

The JAX entry's own example arguments (its 128-env fleet, reset from
PRNGKey(0), and its parameters) are carried to the port: the parameters
by `params_from_jax`, the state by `env_state_from_numpy`. Four forward
steps run on each side, each side carrying its own state (not teacher
forced), the port fed each JAX step's draws (the action noise of its key,
the env step's draws of each env's key, tests/torch_jax_draws.py).

Tolerances: the state under `assert_states_close`'s bars (the kernel
parity bars of tests/test_pallas_step.py); obs, reward, value and
log-prob at 1e-3, the bar of tests/test_torch_agents.py's 10-step
collect_rollout; the gap measured on these inputs is at most ~1.5e-5
(obs and reward) and ~1.5e-4 in qd, inside the state's bars."""

import jax
import numpy as np
import pytest
import torch
import torch_jax_draws as draws_mod

import __graft_entry__
from steppingstone_tpu_torch import entry as tentry
from steppingstone_tpu_torch.agents.networks import params_from_jax
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.envs import terrain as terr
from steppingstone_tpu_torch.physics.step_kernel import CONTROL_STEP

N_STONES = 20
N_NOISE = 2 * 21 + 3
CALLS = 4
TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_forward_step_matches_jax_entry():
    fn_j, (params, state_j, obs_j, key) = __graft_entry__.entry()
    step_j = jax.jit(fn_j)
    fn_t, (policy, _, _) = tentry.entry(device="cpu")
    policy.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    state_t = draws_mod.to_port_state(state_j)
    obs_t = torch.as_tensor(np.array(obs_j))
    assert obs_t.shape == (tentry.NUM_ENVS, 60) and state_t.phys.q.shape[0] == tentry.NUM_ENVS
    launches = dict(CONTROL_STEP.launches)
    for call in range(CALLS):
        key, k_call = jax.random.split(key)
        # the JAX step's draws: its action noise (distributions.sample) and
        # each env's step draws from the key its state carries
        noise = torch.as_tensor(np.array(jax.random.normal(k_call, (tentry.NUM_ENVS, 21))))
        env_draws, _, _ = draws_mod.step_draws(state_j.key, state_j.cur.sample_prob, N_STONES,
                                               N_NOISE)
        state_j, obs_j, rew_j, value_j, logp_j = step_j(params, state_j, obs_j, k_call)
        state_t, obs_t, rew_t, value_t, logp_t = fn_t(
            policy, state_t, obs_t, tentry.ForwardDraws(noise, env_draws))
        draws_mod.assert_states_close(state_t, state_j)
        for name, got, want in (("obs", obs_t, obs_j), ("reward", rew_t, rew_j),
                                ("value", value_t, value_j), ("log_p", logp_t, logp_j)):
            assert got.shape == np.asarray(want).shape, name
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=f"{name}, call {call}")
    # the plain version ran on the CPU: no kernel launch
    assert CONTROL_STEP.launches == launches


def test_forward_step_draws_from_its_generator():
    """Without draws the step draws from the fleet's seeded generator: the
    same seed gives the same step, and the draws it made equal
    `draw_forward` from a generator seeded alike (SEED) after the reset."""
    runs = []
    for _ in range(2):
        fn, (policy, state, obs) = tentry.entry(device="cpu")
        runs.append(fn(policy, state, obs))
    for a, b in zip(runs[0][1:], runs[1][1:]):
        assert torch.equal(a, b)
    fn, (policy, state, obs) = tentry.entry(device="cpu")
    env = make_env(tentry.ENV_NAME, device="cpu")
    # the fleet's generator after its reset: replay the reset's draws
    g = torch.Generator().manual_seed(tentry.SEED)
    env.draw_reset(terr.default_curriculum(batch=tentry.NUM_ENVS), g)
    out = fn(policy, state, obs, tentry.draw_forward(env, state, g))
    for a, b in zip(runs[0][1:], out[1:]):
        assert torch.equal(a, b)


def test_entry_runs_on_the_card_by_default():
    """No device means the card; without one entry() raises."""
    if torch.cuda.is_available():
        assert next(tentry.entry()[1][0].parameters()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tentry.entry()
