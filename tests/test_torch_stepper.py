"""Port parity, envs: steppingstone_tpu_torch's terrain, stepper, registry
and VecEnv against the JAX package on Walker3D and on Cassie with
LargePlank support, with the JAX package's random draws fed to the port
(tests/torch_jax_draws.py).

The teacher-forced tests load the JAX state into the port before every
step, so each step is compared from identical inputs and errors cannot
compound; they cover stone hits, resamples, falls with auto-reset and
mirrored episodes (Walker3D) or mirrored half gait cycles (Cassie).

Tolerances: terrain is fp32 trigonometry and running sums (1e-5); the
physics state uses the kernel parity bars of tests/test_pallas_step.py;
obs and reward get 1e-3, because the reward's progress term divides a
distance difference by the 1/60 s control step and so scales q's
rounding by 60. Discrete outcomes (done, timeout, hit, stone index) must
be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_draws as draws_mod

from steppingstone_tpu.envs import make_env as jmake_env
from steppingstone_tpu.envs import terrain as jterr
from steppingstone_tpu.envs import stepper as jstepper
from steppingstone_tpu.envs.vector import VecEnv as JVecEnv
from steppingstone_tpu_torch.envs import make_env as tmake_env
from steppingstone_tpu_torch.envs import stepper as tstepper
from steppingstone_tpu_torch.envs import terrain as tterr
from steppingstone_tpu_torch.envs.vector import VecEnv as TVecEnv

B = 8
N_STONES = 20
N_NOISE = 2 * 21 + 3
CASSIE_NOISE = 2 * 14 + 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def envs():
    return jmake_env("Walker3DStepperEnv-v0"), tmake_env("Walker3DStepperEnv-v0", device="cpu")


@pytest.fixture(scope="module")
def cassie_envs():
    return (jmake_env("CassieStepper-v1", plank_class="LargePlank"),
            tmake_env("CassieStepper-v1", device="cpu", plank_class="LargePlank"))


def _curricula(rng, b):
    """A batch of curricula: uniform mode at fractional levels, and grid
    mode with random categoricals."""
    prob = rng.random((b, jterr.GRID, jterr.GRID)).astype(np.float32)
    prob /= prob.sum(axis=(1, 2), keepdims=True)
    level = rng.uniform(0, 5, b).astype(np.float32)
    use_prob = np.arange(b) % 2 == 1
    jcur = jterr.CurriculumState(level=jnp.asarray(level), sample_prob=jnp.asarray(prob),
                                 use_prob=jnp.asarray(use_prob), assist=jnp.asarray(level))
    tcur = tterr.CurriculumState(level=torch.as_tensor(level), sample_prob=torch.as_tensor(prob),
                                 use_prob=torch.as_tensor(use_prob), assist=torch.as_tensor(level))
    return jcur, tcur


def test_terrain_generation_matches_jax():
    jcur, tcur = _curricula(np.random.default_rng(0), B)
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    # env.reset hands generate_terrain the first of four subkeys
    k_terr = jax.vmap(lambda k: jax.random.split(k, 4)[0])(keys)
    ref = jax.vmap(lambda k, c: jterr.generate_terrain(k, c, N_STONES))(k_terr, jcur)
    d = draws_mod.reset_draws(keys, jcur.sample_prob, N_STONES, N_NOISE)
    out = tterr.generate_terrain(tcur, N_STONES, d.stones)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tterr.level_scale(tcur.level).numpy(),
                               np.asarray(jterr.level_scale(jcur.level)))


def test_stone_params_and_resample_match_jax():
    jcur, tcur = _curricula(np.random.default_rng(2), B)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    terrain = np.array(jax.vmap(lambda k, c: jterr.generate_terrain(k, c, N_STONES))(keys, jcur))
    index = np.array([0, 1, 2, 5, 19, 20, 7, 3])
    k2 = jax.random.split(jax.random.PRNGKey(4), B)
    d, _, _ = draws_mod.step_draws(k2, jcur.sample_prob, N_STONES, N_NOISE)
    # env.step resamples with the first of two subkeys of the env's key
    k2 = jax.vmap(lambda k: jax.random.split(k)[0])(k2)
    params_j = jax.vmap(jterr.sample_step_params)(k2, jcur)
    params_t = tterr.sample_step_params(tcur, d.resample)
    for a, b in zip(params_t, params_j):
        np.testing.assert_allclose(a[:, 0].numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    ref = jax.vmap(jterr.resample_stone)(k2, jnp.asarray(terrain), jnp.asarray(index), jcur)
    out = tterr.resample_stone(torch.as_tensor(terrain), torch.as_tensor(index), tcur, d.resample)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    changed = (out.numpy() != terrain).any(axis=(1, 2))
    np.testing.assert_array_equal(changed, (index >= 2) & (index < N_STONES))


def test_port_draws_follow_the_curriculum():
    """Draws made by the port's own generator land in the curriculum's
    ranges: level 0 is flat and straight, grid mode uses only the cells
    with probability."""
    g = torch.Generator().manual_seed(0)
    cur = tterr.default_curriculum(0, batch=64)
    t = tterr.generate_terrain(cur, N_STONES, tterr.draw_stones(cur, N_STONES - 2, g))
    assert torch.allclose(t[..., 2:], torch.zeros_like(t[..., 2:]), atol=1e-6)
    prob = torch.zeros(64, tterr.GRID, tterr.GRID)
    prob[:, 3, 7] = 1.0
    cur = cur._replace(sample_prob=prob, use_prob=torch.ones(64, dtype=torch.bool))
    r, yaw, pitch, xt, yt = tterr.sample_step_params(cur, tterr.draw_stones(cur, 5, g))
    assert torch.all(yaw == float(tterr.YAW_SAMPLES[3]))
    assert torch.all(pitch == float(tterr.PITCH_SAMPLES[7]))
    assert torch.all((r >= tterr.R_MIN) & (r <= tterr.R_MAX))


def test_reset_matches_jax(envs):
    jenv, tenv = envs
    key = jax.random.PRNGKey(5)
    jv = JVecEnv(jenv, B)
    ref_state, ref_obs = jv.reset(key)
    keys = draws_mod.vec_reset_keys(key, B)
    d = draws_mod.reset_draws(keys, ref_state.cur.sample_prob, N_STONES, N_NOISE)
    tv = TVecEnv(tenv, B, device="cpu")
    state, obs = tv.reset(draws=d)
    np.testing.assert_allclose(obs.numpy(), np.asarray(ref_obs), rtol=1e-5, atol=1e-5)
    draws_mod.assert_states_close(state, ref_state, q_tol=(1e-6, 1e-6), qd_tol=(1e-6, 1e-6))
    assert tenv.standing_height == pytest.approx(jenv.standing_height, abs=1e-6)
    for a, b in zip(tenv.get_mirror_indices(), jenv.get_mirror_indices()):
        np.testing.assert_array_equal(a, b)


def _teacher_forced(jenv, tenv, steps, key, n_noise, rng):
    """`steps` control steps of B envs under random actions with mirroring
    on: at each step the port starts from the JAX state and the JAX draws.
    Returns counts of hits, episode ends and mirrored env-steps."""
    jv = JVecEnv(jenv, B)
    state, _ = jv.reset(key)
    state = jv.set_mirror(state, True)
    step = jax.jit(jv.step)
    counts = dict(hit=0, done=0, mirrored=0)
    for _ in range(steps):
        action = np.clip(0.5 * rng.standard_normal((B, jenv.action_dim)), -1, 1).astype(np.float32)
        d, _, _ = draws_mod.step_draws(state.key, state.cur.sample_prob, N_STONES, n_noise)
        port_state = draws_mod.to_port_state(state)
        next_state, out = step(state, jnp.asarray(action))
        port_next, port_out = tenv.step(port_state, torch.as_tensor(action), draws=d)
        out = jax.tree.map(np.asarray, out)
        for f in ("done", "timeout", "hit", "ep_len"):
            np.testing.assert_array_equal(getattr(port_out, f).numpy(), getattr(out, f), err_msg=f)
        for f in ("obs", "reward", "ep_return"):
            np.testing.assert_allclose(getattr(port_out, f).numpy(), getattr(out, f),
                                       rtol=1e-3, atol=1e-3, err_msg=f)
        draws_mod.assert_states_close(port_next, next_state)
        counts["hit"] += int(out.hit.sum())
        counts["done"] += int(out.done.sum())
        counts["mirrored"] += int(tstepper._mirror_active(tenv.cfg, port_state).sum())
        state = next_state
    return counts


def test_stepper_teacher_forced_matches_jax(envs):
    """60 control steps of 8 Walker3D envs, mirrored episodes."""
    counts = _teacher_forced(*envs, 60, jax.random.PRNGKey(3), N_NOISE, np.random.default_rng(0))
    # the run covered what it is meant to cover
    assert counts["hit"] >= 3 and counts["done"] >= 3 and counts["mirrored"] >= 3, counts


def test_cassie_stepper_teacher_forced_matches_jax(cassie_envs):
    """60 control steps of 8 Cassie envs on LargePlank support (stable PD
    through engine.step's K2+K3 plain version), the phase mirror on: the
    second half of each 30-step gait cycle runs mirrored."""
    counts = _teacher_forced(*cassie_envs, 60, jax.random.PRNGKey(7), CASSIE_NOISE,
                             np.random.default_rng(1))
    assert counts["hit"] >= 2 and counts["done"] >= 2 and counts["mirrored"] >= 100, counts


def test_cassie_obs_layout_and_mirror_tables(cassie_envs):
    """The clocked 51-dim observation at reset, the Cassie mirror index
    lists against get_mirror_indices, the sign/permutation tables, and the
    env constants Cassie overrides."""
    jenv, tenv = cassie_envs
    key = jax.random.PRNGKey(11)
    jv = JVecEnv(jenv, B)
    ref_state, ref_obs = jv.reset(key)
    d = draws_mod.reset_draws(draws_mod.vec_reset_keys(key, B), ref_state.cur.sample_prob,
                              N_STONES, CASSIE_NOISE)
    state, obs = TVecEnv(tenv, B, device="cpu").reset(draws=d)
    assert obs.shape == (B, 51) and tenv.action_dim == 10
    np.testing.assert_allclose(obs.numpy(), np.asarray(ref_obs), rtol=1e-5, atol=1e-5)
    draws_mod.assert_states_close(state, ref_state, q_tol=(1e-6, 1e-6), qd_tol=(1e-6, 1e-6))
    for a, b in zip(tenv.get_mirror_indices(), jenv.get_mirror_indices()):
        np.testing.assert_array_equal(a, b)
    for name in ("mirror_sign_obs", "mirror_perm_obs", "mirror_sign_act", "mirror_perm_act"):
        np.testing.assert_array_equal(getattr(tenv, name).numpy(), getattr(jenv, name), err_msg=name)
    for f in ("actuation", "obs_dim", "termination_height", "clock_period",
              "init_forward_speed", "support", "plank_hy"):
        assert getattr(tenv.cfg, f) == getattr(jenv.cfg, f), f
    assert tenv.standing_height == pytest.approx(jenv.standing_height, abs=1e-6)
    assert tstepper.PLANK_CLASSES == jstepper.PLANK_CLASSES
    # the phase gate: mirroring only in the second half of the clock
    st = state._replace(mirror_enabled=torch.ones(B, dtype=torch.bool),
                        phase=torch.linspace(0, 0.9, B))
    np.testing.assert_array_equal(tstepper._mirror_active(tenv.cfg, st).numpy(),
                                  st.phase.numpy() >= 0.5)


def test_vec_env_curriculum_fanouts(envs):
    _, tenv = envs
    tv = TVecEnv(tenv, 4, device="cpu", seed=1)
    state, obs = tv.reset()
    assert obs.shape == (4, 60) and torch.isfinite(obs).all()
    state = tv.update_curriculum(state, 3, assist=1)
    assert torch.all(state.cur.level == 3) and torch.all(state.cur.assist == 1)
    assert not state.cur.use_prob.any()
    assert tv.set_mirror(state, True).mirror_enabled.all()
    state, out = tv.step(state, torch.zeros(4, 21))
    assert out.obs.shape == (4, 60) and torch.isfinite(out.reward).all()


def test_make_env_ids(envs):
    """The port knows the JAX registry's four ids, with or without the
    `mocca_envs:` prefix, and refuses others naming the known ones."""
    from steppingstone_tpu.envs.registry import ENV_IDS as JENV_IDS
    from steppingstone_tpu_torch.envs.registry import ENV_IDS

    _, tenv = envs
    assert tenv.observation_dim == 60 and tenv.action_dim == 21
    assert ENV_IDS == JENV_IDS and len(ENV_IDS) == 4
    env = tmake_env("mocca_envs:Walker3DStepperEnv-v0", device="cpu")
    assert env.cfg.name == "Walker3DStepperEnv-v0"
    cassie = tmake_env("mocca_envs:CassieStepper-v1", device="cpu", plank_class="Plank",
                       stall_timeout=0)
    assert (cassie.observation_dim, cassie.action_dim) == (51, 10)
    assert (cassie.cfg.support, cassie.cfg.plank_hy, cassie.cfg.stall_timeout) == ("plank", 0.6, 0)
    mike = tmake_env("mocca_envs:MikeStepperEnv-v0", device="cpu")
    assert (mike.cfg.name, mike.cfg.model.name, mike.observation_dim, mike.action_dim) == (
        "MikeStepperEnv-v0", "mike", 60, 21)
    alias = tmake_env("Walker3DMocapStepperEnv-v0", device="cpu")
    assert alias.cfg.name == "Walker3DStepperEnv-v0"
    with pytest.raises(KeyError, match="MikeStepperEnv-v0"):
        tmake_env("HumanoidStepperEnv-v0", device="cpu")
