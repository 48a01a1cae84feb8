"""Port parity, Mike: steppingstone_tpu_torch's `mike()` model and
`MikeStepperEnv-v0` against the JAX package's, and the port's training CLI
on Mike.

Mike is Walker3D's skeleton at 1.45x the mass and 1.04x the length, with
the torque caps and inertias scaled to match; it runs on torques, so on
LargePlank support its control step is kernel K2 on the card and the
plain version here. The model is held exactly (both packages build it
with the same numpy code). The teacher-forced run loads the JAX state into
the port before every step, with the JAX package's random draws
(tests/torch_jax_draws.py), under tests/test_torch_stepper.py's bars:
the physics state at the Pallas kernel's (q 2e-4, qd 2e-3/2e-2), obs and
reward 1e-3 (the reward's progress term scales q's rounding by 60),
discrete outcomes equal. XLA compiles a fresh Walker3D-sized step for
Mike's constants (about half a minute on the CPU)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch_jax_draws as draws_mod
from test_torch_core import _assert_models_equal
from test_torch_stepper import N_NOISE, N_STONES, _teacher_forced

from steppingstone_tpu.envs import make_env as jmake_env
from steppingstone_tpu.envs.vector import VecEnv as JVecEnv
from steppingstone_tpu.physics.robots import walker3d as jwalker
from steppingstone_tpu_torch.envs import make_env as tmake_env
from steppingstone_tpu_torch.envs.vector import VecEnv as TVecEnv
from steppingstone_tpu_torch.physics.robots import REGISTRY as TREGISTRY
from steppingstone_tpu_torch.physics.robots import walker3d as twalker
from steppingstone_tpu_torch.runtime.train import main

B = 8
HEADER = ["iter", "total_num_steps", "fps", "entropy", "value_loss", "action_loss",
          "mean_rew", "median_rew", "min_rew", "max_rew", "test_mean_rew", "test_median_rew",
          "test_min_rew", "test_max_rew"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mike_envs():
    return (jmake_env("MikeStepperEnv-v0", plank_class="LargePlank"),
            tmake_env("MikeStepperEnv-v0", device="cpu", plank_class="LargePlank"))


def test_mike_model_fields_equal():
    mj, mt = jwalker.mike(), twalker.mike()
    _assert_models_equal(mj, mt)
    assert mt.name == "mike" and TREGISTRY["mike"] is twalker.mike
    assert twalker.mike() is mt  # cached, as the kernel's model caches expect
    # Walker3D's skeleton, scaled
    w = twalker.walker3d()
    assert (mt.nbodies, mt.njoints, mt.ndof, mt.nq, mt.ncontacts) == (22, 21, 27, 28, 12)
    np.testing.assert_array_equal(mt.parent, w.parent)
    np.testing.assert_array_equal(mt.torque_limit, w.torque_limit * 1.45)
    np.testing.assert_array_equal(mt.inertia, w.inertia * (1.45 * 1.04 ** 2))
    np.testing.assert_allclose(mt.mass, 1.45 * w.mass, rtol=1e-6)


def test_mike_env_reset_matches_jax(mike_envs):
    """The env's config, standing height, mirror tables and a reset on
    LargePlank against JAX's."""
    jenv, tenv = mike_envs
    assert (tenv.cfg.name, tenv.observation_dim, tenv.action_dim) == ("MikeStepperEnv-v0", 60, 21)
    for f in dataclasses.fields(jenv.cfg):
        if f.name not in ("model", "contact"):
            assert getattr(tenv.cfg, f.name) == getattr(jenv.cfg, f.name), f.name
    assert (tenv.cfg.actuation, tenv.cfg.support, tenv.cfg.plank_hy) == ("torque", "plank", 1.5)
    assert tenv.standing_height == pytest.approx(jenv.standing_height, abs=1e-6)
    assert tenv.standing_height > tmake_env("Walker3DStepperEnv-v0", device="cpu").standing_height
    for name in ("mirror_sign_obs", "mirror_perm_obs", "mirror_sign_act", "mirror_perm_act"):
        np.testing.assert_array_equal(getattr(tenv, name).numpy(), getattr(jenv, name), err_msg=name)
    key = jax.random.PRNGKey(12)
    ref_state, ref_obs = JVecEnv(jenv, B).reset(key)
    d = draws_mod.reset_draws(draws_mod.vec_reset_keys(key, B), ref_state.cur.sample_prob,
                              N_STONES, N_NOISE)
    state, obs = TVecEnv(tenv, B, device="cpu").reset(draws=d)
    np.testing.assert_allclose(obs.numpy(), np.asarray(ref_obs), rtol=1e-5, atol=1e-5)
    draws_mod.assert_states_close(state, ref_state, q_tol=(1e-6, 1e-6), qd_tol=(1e-6, 1e-6))


def test_mike_stepper_teacher_forced_matches_jax(mike_envs):
    """60 control steps of 8 Mike envs on LargePlank support (the round-5
    Mike run's), mirrored episodes."""
    counts = _teacher_forced(*mike_envs, 60, jax.random.PRNGKey(8), N_NOISE,
                             np.random.default_rng(8))
    assert counts["hit"] >= 3 and counts["done"] >= 3 and counts["mirrored"] >= 3, counts


def test_tiny_mike_training_run(tmp_path, capsys):
    """The training CLI on Mike (LargePlank, fixed curriculum): 2 updates
    of 8 envs x 40 steps (long enough for falls, so that each update logs
    its episodes) write progress.csv with the reference header, a row per
    update and every column finite."""
    run = tmp_path / "mike"
    main(["env_name=MikeStepperEnv-v0", "plank_class=LargePlank", "use_curriculum=True",
          "num_processes=8", "episode_steps=320", "mini_batch_size=160", "num_frames=640",
          "num_tests=0", "seed=8", f"experiment_dir={run}"], device="cpu")
    rows = (run / "progress.csv").read_text().strip().splitlines()
    assert rows[0].split(",") == HEADER
    body = [dict(zip(HEADER, r.split(","))) for r in rows[1:]]
    assert [r["iter"] for r in body] == ["1", "2"]
    for r in body:
        assert all(np.isfinite(float(r[c])) for c in HEADER), r
    assert "MikeStepperEnv-v0" in (run / "configs.json").read_text()
    assert "Updates 2, num timesteps 640" in capsys.readouterr().out
