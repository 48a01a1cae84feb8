"""Port parity, the value-based curricula: steppingstone_tpu_torch's
candidate stones, hypothetical observations (`create_temp_states`), the
curriculum fan-outs, the value grid and the adaptive and threshold
strategies against the JAX package on the same inputs, the JAX draws fed
to the port (tests/torch_jax_draws.py) and the JAX weights carried over
(`params_from_jax`).

Tolerances: candidate geometry and observations are fp32 trigonometry
(1e-5); the fan-outs are exact, but for the normalized sampling grid,
whose 121-term fp32 sum is taken in another order (rel 3e-7, about two
ulps); the value grid is a deterministic 60-step
rollout of 4 Walker3D envs that is not teacher forced, its event count
must be equal and the normalized grid within 1e-4; the strategies'
probabilities are a softmax of the same grid (1e-6)."""

import os

os.environ["STEPPINGSTONE_NO_COMPILE_CACHE"] = "1"  # before the JAX runtime import

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_draws as draws_mod

from steppingstone_tpu.agents import rollout as jroll
from steppingstone_tpu.agents.networks import ActorCritic as JActorCritic
from steppingstone_tpu.envs import make_env as jmake_env
from steppingstone_tpu.envs import stepper as jstepper
from steppingstone_tpu.envs import terrain as jterr
from steppingstone_tpu.envs.vector import VecEnv as JVecEnv
from steppingstone_tpu.physics.engine import PhysicsState as JPhysicsState
from steppingstone_tpu.runtime import curriculum as jcurr
from steppingstone_tpu_torch.agents.networks import ActorCritic, params_from_jax
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.envs import stepper as tstepper
from steppingstone_tpu_torch.envs import terrain as tterr
from steppingstone_tpu_torch.envs.vector import VecEnv
from steppingstone_tpu_torch.runtime import curriculum as tcurr

B = 4
N_STONES = 20
# (env id, kwargs, reset noise draws 2 NJ + 3)
ENVS = {"walker3d": ("Walker3DStepperEnv-v0", {}, 2 * 21 + 3),
        "cassie": ("CassieStepper-v1", {"plank_class": "LargePlank"}, 2 * 14 + 3)}
GRID_ENVS, GRID_STEPS = 4, 60


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def nets():
    """The JAX actor-critic with 2 critics and the port's with its weights."""
    net = JActorCritic(action_dim=21, num_ensembles=2)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 60)))
    policy = ActorCritic(60, 21, 2, device="cpu")
    policy.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return net, params, policy


def _to_jax_state(state, keys):
    """A port EnvState -> the JAX package's EnvState (with env keys)."""
    def a(x):
        x = x.numpy()
        return jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)

    rest = {k: a(v) for k, v in state._asdict().items() if k not in ("phys", "cur")}
    return jstepper.EnvState(phys=JPhysicsState(q=a(state.phys.q), qd=a(state.phys.qd)),
                             cur=jterr.CurriculumState(*(a(x) for x in state.cur)), key=keys,
                             **rest)


def _stepped_states(name):
    """B envs from a JAX reset, stepped 6 times by the port under random
    actions, with next_step_index set to 1, 7, 18 and 19 (the last two clip
    the candidate index at n_stones - 1). Returns (JAX env, port env, JAX
    state, port state)."""
    env_id, kw, n_noise = ENVS[name]
    jenv, tenv = jmake_env(env_id, **kw), make_env(env_id, device="cpu", **kw)
    key = jax.random.PRNGKey(3)
    ref, _ = JVecEnv(jenv, B).reset(key)
    d = draws_mod.reset_draws(draws_mod.vec_reset_keys(key, B), ref.cur.sample_prob, N_STONES,
                              n_noise)
    venv = VecEnv(tenv, B, device="cpu", seed=1)
    state, _ = venv.reset(draws=d)
    g = torch.Generator().manual_seed(2)
    for _ in range(6):
        state, _ = venv.step(state, torch.clamp(0.5 * torch.randn(B, tenv.action_dim,
                                                                  generator=g), -1, 1))
    state = state._replace(next_step_index=torch.tensor([1, 7, 18, 19]))
    return jenv, tenv, _to_jax_state(state, ref.key), state


@pytest.mark.parametrize("name", list(ENVS))
def test_candidates_and_temp_states_match_jax(name):
    """candidate_stones and create_temp_states (the VecEnv's and the
    module function) against JAX on stepped Walker3D and Cassie states,
    1e-5; the candidates move only the lookahead features."""
    jenv, tenv, jstate, state = _stepped_states(name)
    cand_idx = torch.clamp(state.next_step_index + 1, 0, N_STONES - 1)
    np.testing.assert_array_equal(cand_idx.numpy(), [2, 8, 19, 19])
    cands = tterr.candidate_stones(state.terrain, cand_idx)
    ref = jax.vmap(jterr.candidate_stones)(jstate.terrain, jnp.asarray(cand_idx.numpy()))
    assert cands.shape == (B, tterr.GRID * tterr.GRID, 6)
    np.testing.assert_allclose(cands.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    temp = VecEnv(tenv, B, device="cpu").create_temp_states(state)
    ref = jax.jit(jax.vmap(lambda s: jstepper.create_temp_states(jenv.cfg, s)))(jstate)
    assert temp.shape == (B, tterr.GRID * tterr.GRID, tenv.observation_dim)
    np.testing.assert_allclose(temp.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tstepper.create_temp_states(tenv.cfg, state), temp, rtol=0, atol=0)
    base = tstepper.get_temp_state(tenv.cfg, state)
    torch.testing.assert_close(base, tstepper.observe(tenv.cfg, state), rtol=0, atol=0)
    # envs whose next stone is not the candidate (next_step_index 1, 7, 18)
    moved = (temp - base[:, None])[:3].abs().amax(dim=(0, 1))
    lookahead = tenv.observation_dim - (8 if tenv.cfg.clock_period else 10)
    assert moved[:lookahead].max() < 1e-5 and moved[lookahead:].max() > 0.01


class _JState(NamedTuple):
    """Stands in for the JAX EnvState: these fan-outs touch only `cur`."""

    cur: Any


def test_fan_outs_match_jax():
    """update_sample_prob on the env (one grid or one per env) and on the
    VecEnv, set_env_params, set_robot_params and the sample properties:
    the JAX package's, exactly but for the grid's normalization (rel
    3e-7)."""
    jenv, tenv = jmake_env("Walker3DStepperEnv-v0"), make_env("Walker3DStepperEnv-v0",
                                                               device="cpu")
    jvenv, venv = JVecEnv(jenv, B), VecEnv(tenv, B, device="cpu")
    key = jax.random.PRNGKey(4)
    jstate, _ = jvenv.reset(key)
    d = draws_mod.reset_draws(draws_mod.vec_reset_keys(key, B), jstate.cur.sample_prob,
                              N_STONES, 2 * 21 + 3)
    state, _ = venv.reset(draws=d)
    rng = np.random.default_rng(0)
    grid = rng.random((tterr.GRID, tterr.GRID)).astype(np.float32)
    grids = rng.random((B, tterr.GRID, tterr.GRID)).astype(np.float32)

    def same_cur(port, ref):
        for f in tterr.CurriculumState._fields:
            ours, theirs = getattr(port.cur, f).numpy(), np.asarray(getattr(ref.cur, f))
            theirs = np.broadcast_to(theirs, ours.shape)
            if f == "sample_prob":
                # the 121-term fp32 sum is taken in another order: an ulp
                np.testing.assert_allclose(ours, theirs, rtol=3e-7, atol=0)
            else:
                np.testing.assert_array_equal(ours, theirs, err_msg=f)

    same_cur(venv.update_sample_prob(state, grid), jvenv.update_sample_prob(jstate, grid))
    same_cur(venv.update_sample_prob(state, torch.as_tensor(grid)),
             jvenv.update_sample_prob(jstate, grid))
    # the env's method on one env's state (JAX) or a batch (the port)
    one = _JState(jax.tree.map(lambda x: x[0], jstate.cur))
    same_cur(tenv.update_sample_prob(state, grid), jenv.update_sample_prob(one, grid))
    per_env = tenv.update_sample_prob(state, grids)
    for b in range(B):
        ref = jenv.update_sample_prob(one, grids[b])
        np.testing.assert_allclose(per_env.cur.sample_prob[b].numpy(),
                                   np.asarray(ref.cur.sample_prob), rtol=3e-7, atol=0)
    assert per_env.cur.use_prob.all()

    for params in ({"stone_radius": 0.31}, {"stone_radius": np.linspace(0.1, 0.4, B)}, {}):
        ours = venv.set_env_params(state, params)
        ref = jvenv.set_env_params(jstate, params)
        np.testing.assert_array_equal(ours.stone_radius.numpy(), np.asarray(ref.stone_radius))
        assert ours.stone_radius.dtype == torch.float32
    for params in ({"power": 0.75}, {"power": np.arange(B) / 2.0}, {"other": 1.0}):
        ours = venv.set_robot_params(state, params)
        ref = jvenv.set_robot_params(jstate, params)
        np.testing.assert_array_equal(ours.robot_power.numpy(), np.asarray(ref.robot_power))
    # the source state is untouched
    assert torch.all(state.robot_power == 1.0) and not state.cur.use_prob.any()
    for name in ("yaw_samples", "pitch_samples", "r_samples"):
        ours, ref = getattr(tenv, name), getattr(jenv, name)
        np.testing.assert_array_equal(ours, ref)
        assert ours.dtype == ref.dtype == np.float32


def _grid_draws(key, n, steps, net, params, jenv):
    """The JAX value grid's reset (at level 0, split(key, n)) and the draws
    of its `steps` deterministic steps: each env's key chain forks at the
    episode ends of the JAX run, which a deterministic JAX rollout from the
    same reset gives."""
    keys = jax.random.split(key, n)
    state, obs = jax.vmap(jenv.reset, in_axes=(0, None))(keys, jterr.default_curriculum(0))
    run = jax.jit(partial(jroll.collect_rollout, jax.vmap(jenv.step), net.apply,
                          num_steps=steps, deterministic=True))
    aux = run(params, state, obs, jroll.EpisodeStats.init(n), key)[4]
    _, env_draws = draws_mod.rollout_draws(key, state.key, state.cur.sample_prob,
                                           aux["ep_done"], steps, n, 21, N_STONES, 2 * 21 + 3)
    reset = draws_mod.reset_draws(keys, state.cur.sample_prob, N_STONES, 2 * 21 + 3)
    return tcurr.ValueGridDraws(reset, env_draws), int(np.asarray(aux["ep_done"]).sum())


def test_value_grid_matches_jax(nets):
    """make_value_grid_fn: 4 Walker3D envs x 60 deterministic steps from a
    level-0 reset, every step's 121 x 4 candidates scored by the 2-critic
    ensemble, summed over the hit events; the same event count, the grid
    within 1e-4, nonzero and normalized to max |grid| = 1."""
    net, params, policy = nets
    jenv = jmake_env("Walker3DStepperEnv-v0")
    key = jax.random.PRNGKey(1)
    ref, ref_count = jcurr.make_value_grid_fn(jenv, net.apply, max_steps=GRID_STEPS,
                                              n_envs=GRID_ENVS)(params, key)
    draws, dones = _grid_draws(key, GRID_ENVS, GRID_STEPS, net, params, jenv)
    fn = tcurr.make_value_grid_fn(make_env("Walker3DStepperEnv-v0", device="cpu"),
                                  max_steps=GRID_STEPS, n_envs=GRID_ENVS)
    assert fn.venv.num_envs == GRID_ENVS and tcurr.EVAL_ENVS == jcurr.EVAL_ENVS == 16
    assert tcurr.EVAL_STEPS == jcurr.EVAL_STEPS
    grid, count = fn(policy, draws)
    assert grid.shape == (tterr.GRID, tterr.GRID) and count.dtype == torch.long
    assert int(count) == int(ref_count) == fn.last_count
    assert int(count) > 0 and dones > 0  # events to score, and auto-resets on the way
    np.testing.assert_allclose(grid.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    assert float(grid.abs().max()) == pytest.approx(1.0, abs=1e-6)
    assert len(np.unique(np.round(grid.numpy(), 4))) > 10


def _stub_grid(grid):
    """JAX and port value-grid functions that return `grid`."""
    return (lambda params, key: (jnp.asarray(grid), jnp.asarray(3)),
            lambda policy, draws=None: (torch.as_tensor(grid), torch.tensor(3)))


@pytest.mark.parametrize("strategy", ["adaptive", "threshold"])
def test_strategies_match_jax(strategy):
    """AdaptiveSampling and ThresholdSampling (scale 150, uniform_every=3)
    on the same grids: the probabilities within 1e-6, the instrumentation
    and the installed curriculum; the threshold's uniform rounds install
    level 5 with the assist kept and clear the instrumentation, and come
    back every 3 rounds."""
    rng = np.random.default_rng(5)
    grids = [np.clip(rng.normal(0.8, 0.15, (11, 11)), -1, 1).astype(np.float32)
             for _ in range(5)]
    jvenv = JVecEnv(jmake_env("Walker3DStepperEnv-v0"), B)
    venv = VecEnv(make_env("Walker3DStepperEnv-v0", device="cpu"), B, device="cpu")
    jstate, _ = jvenv.reset(jax.random.PRNGKey(0))
    state, _ = venv.reset()
    jstate, state = jvenv.update_assist(jstate, 2.0), venv.update_assist(state, 2.0)
    if strategy == "adaptive":
        js = jcurr.AdaptiveSampling(jvenv, jvenv.env, None, scale=150.0)
        ts = tcurr.AdaptiveSampling(venv, venv.env, scale=150.0)
    else:
        js = jcurr.ThresholdSampling(jvenv, jvenv.env, None, uniform_every=3, scale=150.0)
        ts = tcurr.ThresholdSampling(venv, venv.env, uniform_every=3, scale=150.0)
    uniform = []
    for r, grid in enumerate(grids):
        js.value_grid, ts.value_grid = _stub_grid(grid)
        if strategy == "adaptive":
            jstate = js.pre_update(jstate, None, None)
            state = ts.pre_update(state, None)
        else:
            uniform.append(ts.uniform_sampling)
            assert js.uniform_sampling == ts.uniform_sampling
            jstate = js.pre_update(jstate, None, None, assist=1.5)
            state = ts.pre_update(state, None, assist=1.5)
        if js.last_probs is None:
            assert ts.last_probs is None and ts.last_grid is None
        else:
            assert ts.last_probs.shape == (11, 11) and isinstance(ts.last_grid, np.ndarray)
            np.testing.assert_allclose(ts.last_probs, js.last_probs, rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(ts.last_grid, js.last_grid)
            assert ts.last_probs.max() > 10 * ts.last_probs.min()
        for f in ("level", "use_prob", "assist"):
            np.testing.assert_array_equal(getattr(state.cur, f).numpy(),
                                          np.asarray(getattr(jstate.cur, f)), err_msg=f)
        np.testing.assert_allclose(state.cur.sample_prob.numpy(),
                                   np.asarray(jstate.cur.sample_prob), rtol=1e-6, atol=1e-6)
        if strategy == "threshold":
            js.post_test()
            ts.post_test()
            assert (ts.uniform_counter, ts.uniform_sampling) == (js.uniform_counter,
                                                                 js.uniform_sampling)
    if strategy == "threshold":
        assert uniform == [True, False, False, True, False]
        assert torch.all(state.cur.level == 5) and torch.all(state.cur.assist == 1.5)
    else:
        assert torch.all(state.cur.level == 0) and torch.all(state.cur.assist == 2.0)
    assert state.cur.use_prob.all()
