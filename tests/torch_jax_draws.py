"""Shared helpers for the tests that hold steppingstone_tpu_torch against
steppingstone_tpu: the JAX package's random draws, recomputed from its
keys by the same splits its env code makes, and handed to the port as
numpy-built tensors (the two frameworks' generators cannot agree)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from steppingstone_tpu_torch.envs import terrain as tterr
from steppingstone_tpu_torch.envs.stepper import EnvStepDraws, ResetDraws, env_state_from_numpy


def _stone_draw(key, prob):
    """The draws of terrain.sample_step_params(key, cur) for one placement."""
    ku, kg, kr, kt = jax.random.split(key, 4)
    return dict(
        u=jax.random.uniform(ku, (4,), minval=-1.0, maxval=1.0),
        r_u=jax.random.uniform(kr, ()),
        cat=jax.random.categorical(kg, jnp.log(prob.reshape(-1) + 1e-12)),
        r_g=jax.random.uniform(kt, ()),
    )


def _reset_draw(key, prob, n_stones, n_noise):
    """The draws of StepperEnv.reset(key, ...) for one env."""
    k_terr, k_noise, _, k_mir = jax.random.split(key, 4)
    keys = jax.random.split(k_terr, n_stones - 2)
    stones = jax.vmap(_stone_draw, in_axes=(0, None))(keys, prob)
    return dict(stones=stones, noise=jax.random.normal(k_noise, (n_noise,)),
                mirror=jax.random.bernoulli(k_mir))


def _step_draw(key, prob, n_stones, n_noise):
    """The draws of StepperEnv.step for one env whose state key is `key`,
    plus the key the env carries to the next step either way."""
    k_resample, k_next = jax.random.split(key)
    k_reset, k_keep = jax.random.split(k_next)
    resample = jax.tree.map(lambda x: x[None], _stone_draw(k_resample, prob))
    k_state = jax.random.split(k_reset, 4)[2]
    return dict(resample=resample, reset=_reset_draw(k_reset, prob, n_stones, n_noise),
                k_keep=k_keep, k_state=k_state)


_reset_draws = jax.jit(jax.vmap(_reset_draw, in_axes=(0, 0, None, None)), static_argnums=(2, 3))
_step_draws = jax.jit(jax.vmap(_step_draw, in_axes=(0, 0, None, None)), static_argnums=(2, 3))


def _stones(d, device) -> tterr.StoneDraws:
    return tterr.StoneDraws(
        u=torch.as_tensor(np.array(d["u"]), device=device),
        r_u=torch.as_tensor(np.array(d["r_u"]), device=device),
        cat=torch.as_tensor(np.array(d["cat"]), dtype=torch.long, device=device),
        r_g=torch.as_tensor(np.array(d["r_g"]), device=device),
    )


def _reset(d, device) -> ResetDraws:
    return ResetDraws(
        stones=_stones(d["stones"], device),
        noise=torch.as_tensor(np.array(d["noise"]), device=device),
        mirror=torch.as_tensor(np.array(d["mirror"]), device=device),
    )


def reset_draws(keys, prob, n_stones, n_noise, device="cpu") -> ResetDraws:
    """Port draws equal to those of vmap(env.reset) over `keys` (B, 2)."""
    return _reset(_reset_draws(keys, prob, n_stones, n_noise), device)


def step_draws(keys, prob, n_stones, n_noise, device="cpu"):
    """(EnvStepDraws, k_keep, k_state) for a batch of env keys: the port
    draws of one vmap(env.step), and the next key of an env that goes on
    (k_keep) or was reset (k_state)."""
    d = _step_draws(keys, prob, n_stones, n_noise)
    draws = EnvStepDraws(resample=_stones(d["resample"], device), reset=_reset(d["reset"], device))
    return draws, d["k_keep"], d["k_state"]


def vec_reset_keys(key, n):
    """The per-env keys VecEnv.reset(key) hands to env.reset."""
    return jax.random.split(key, n)


def to_port_state(jax_state, device="cpu"):
    """A JAX EnvState (any leaves) -> the port's EnvState."""
    return env_state_from_numpy(jax.tree.map(np.asarray, jax_state), device)


def assert_states_close(port, ref, q_tol=(2e-4, 2e-4), qd_tol=(2e-3, 2e-2)):
    """Port EnvState against a JAX EnvState. Discrete fields must be equal;
    q/qd use the kernel parity tolerances of tests/test_pallas_step.py
    (fp32 sums taken in another order, through four substeps of stiff
    contact); derived distances get 1e-3."""
    r = jax.tree.map(np.asarray, ref)
    np.testing.assert_allclose(port.phys.q.numpy(), r.phys.q, rtol=q_tol[0], atol=q_tol[1])
    np.testing.assert_allclose(port.phys.qd.numpy(), r.phys.qd, rtol=qd_tol[0], atol=qd_tol[1])
    np.testing.assert_allclose(port.terrain.numpy(), r.terrain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.foot_xyz.numpy(), r.foot_xyz, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(port.prev_dist.numpy(), r.prev_dist, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(port.phase.numpy(), r.phase, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(port.robot_power.numpy(), r.robot_power)
    for f in ("next_step_index", "elapsed", "last_hit", "update_terrain", "foot_contact",
              "mirror_enabled", "mirror_episode"):
        np.testing.assert_array_equal(getattr(port, f).numpy(), getattr(r, f), err_msg=f)



def ppo_perms(key, batch_size: int, epochs: int, used: int, device="cpu") -> torch.Tensor:
    """(epochs, used) row orders of the JAX package's ppo_update(key=key)."""
    keys = jax.random.split(key, epochs)
    return torch.stack([torch.as_tensor(np.array(jax.random.permutation(k, batch_size)[:used]),
                                        dtype=torch.long, device=device) for k in keys])


def rollout_draws(key, env_keys, prob, ep_done, steps: int, n_envs: int, action_dim: int,
                  n_stones: int, n_noise: int, device="cpu"):
    """(action noise (T, N, A), [EnvStepDraws] * T) of the JAX package's
    collect_rollout(key=key) from envs whose keys are `env_keys`: action
    noise from the rollout's key chain, env draws from each env's key chain,
    which forks at the episode ends `ep_done` (T, N) of that run."""
    noise, env_draws = [], []
    done = np.asarray(ep_done)
    for t in range(steps):
        key, k_act = jax.random.split(key)
        noise.append(torch.as_tensor(np.array(jax.random.normal(k_act, (n_envs, action_dim))),
                                     device=device))
        d, k_keep, k_state = step_draws(env_keys, prob, n_stones, n_noise, device)
        env_draws.append(d)
        env_keys = jnp.where(done[t][:, None], k_state, k_keep)
    return torch.stack(noise), env_draws


def jax_step_per_env(model, q, qd, tau, stones, sr, ug, pd=None, support_hy=None,
                     substeps=4):
    """JAX engine._step_scan (the jnp path) over a batch, one env at a time:
    jit-compiled once unbatched and called per env, because XLA's CPU
    compile of the vmapped step of a model with rotated joint frames takes
    minutes. pd is None or (target (B, NJ), power (B,)). Returns numpy
    (q, qd, StepInfo) stacked over the batch."""
    from steppingstone_tpu.physics import engine as jeng

    def one(q_, qd_, t_, st_, r_, g_, *pd_):
        s, i = jeng._step_scan(model, jeng.PhysicsState(q_, qd_), t_, st_, r_, g_,
                               pd=pd_ or None, support_hy=support_hy, substeps=substeps)
        return s.q, s.qd, i

    fn = jax.jit(one)
    extra = () if pd is None else tuple(np.asarray(x) for x in pd)
    outs = [fn(*(np.asarray(x)[b] for x in (q, qd, tau, stones, sr, ug) + extra))
            for b in range(np.asarray(q).shape[0])]
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *outs)
