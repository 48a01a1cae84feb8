"""Port parity, learner: steppingstone_tpu_torch's GAE, advantage
normalization, mirror augmentation, logstd helpers and one `ppo_update`
(two critics, mirror on, the KL guard firing, full and value-only) against
the JAX package on the same seeded inputs, with the JAX package's
minibatch permutations fed to the port.

Tolerances: GAE is a fp32 recurrence computed in the same order (1e-6).
The PPO update runs 2 epochs x 4 minibatches of Adam steps through
256-wide fp32 MLPs in two libraries: gradients differ in the last bits
(sums in another order), and Adam divides each by its own running norm, so
parameters and metrics are held to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_draws as draws_mod

from steppingstone_tpu.agents import gae as jgae
from steppingstone_tpu.agents import mirror as jmirror
from steppingstone_tpu.agents import networks as jnet
from steppingstone_tpu.agents import ppo as jppo
from steppingstone_tpu.envs import make_env as jmake_env
from steppingstone_tpu_torch.agents import gae as tgae
from steppingstone_tpu_torch.agents import mirror as tmirror
from steppingstone_tpu_torch.agents import networks as tnet
from steppingstone_tpu_torch.agents import ppo as tppo

OBS, ACT = 51, 10


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mirror_indices():
    return jmake_env("CassieStepper-v1").get_mirror_indices()


def test_gae_and_normalization_match_jax():
    rng = np.random.default_rng(0)
    T, N = 16, 8
    rewards = rng.standard_normal((T, N)).astype(np.float32) * 3
    values = rng.standard_normal((T + 1, N)).astype(np.float32) * 10
    masks = (rng.random((T + 1, N)) > 0.15).astype(np.float32)
    bad = np.where(masks == 0, (rng.random((T + 1, N)) > 0.5), 1).astype(np.float32)
    masks[0] = bad[0] = 1.0
    assert (bad == 0).any() and ((masks == 0) & (bad == 1)).any()
    ret_j, adv_j = jgae.compute_gae(*(jnp.asarray(x) for x in (rewards, values, masks, bad)),
                                    0.99, 0.95)
    ret_t, adv_t = tgae.compute_gae(*(torch.as_tensor(x) for x in (rewards, values, masks, bad)),
                                    0.99, 0.95)
    np.testing.assert_allclose(ret_t.numpy(), np.asarray(ret_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(adv_t.numpy(), np.asarray(adv_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tgae.normalize_advantages(adv_t).numpy(),
                               np.asarray(jgae.normalize_advantages(adv_j)), rtol=1e-6, atol=1e-6)


def test_mirror_minibatch_matches_jax(mirror_indices):
    rng = np.random.default_rng(1)
    mb = dict(obs=rng.standard_normal((6, OBS)), actions=rng.standard_normal((6, ACT)),
              adv=rng.standard_normal((6, 1)), log_probs=rng.standard_normal((6, 1)))
    mb = {k: v.astype(np.float32) for k, v in mb.items()}
    ref = jmirror.mirror_minibatch(jmirror.MirrorSpec(*mirror_indices),
                                   {k: jnp.asarray(v) for k, v in mb.items()})
    spec = tmirror.MirrorSpec(*mirror_indices)
    out = tmirror.mirror_minibatch(spec, {k: torch.as_tensor(v) for k, v in mb.items()})
    assert out.keys() == ref.keys()
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    # mirroring twice is the identity
    x = torch.as_tensor(mb["obs"])
    torch.testing.assert_close(tmirror.mirror_obs(spec, tmirror.mirror_obs(spec, x)), x)


def _nets(seed):
    net = jnet.ActorCritic(action_dim=ACT, num_ensembles=2)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS)))
    policy = tnet.ActorCritic(OBS, ACT, num_ensembles=2, device="cpu")
    policy.load_state_dict(tnet.params_from_jax(jax.tree.map(np.asarray, params)))
    return net, params, policy


def _assert_params_close(policy, params, rtol, atol):
    ref = tnet.params_from_jax(jax.tree.map(np.asarray, params))
    for name, p in policy.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=rtol, atol=atol,
                                   err_msg=name)


def test_logstd_helpers_match_jax():
    net, params, policy = _nets(2)
    raw = np.linspace(-4.0, 0.5, ACT).astype(np.float32)
    params = {"params": {**params["params"], "logstd": jnp.asarray(raw)}}
    cases = [(jnet.project_logstd, tnet.project_logstd, ()),
             (jnet.reinflate_logstd, tnet.reinflate_logstd, (-1.7,)),
             (jnet.cap_logstd, tnet.cap_logstd, (-2.5,)),
             (jnet.reset_logstd, tnet.reset_logstd, (-2.0,))]
    for fj, ft, args in cases:
        with torch.no_grad():
            policy.logstd.copy_(torch.as_tensor(raw))
        out = ft(policy, *args)
        assert out is policy
        np.testing.assert_array_equal(policy.logstd.detach().numpy(),
                                      np.asarray(fj(params, *args)["params"]["logstd"]),
                                      err_msg=fj.__name__)


@pytest.mark.parametrize("value_only", [False, True])
def test_ppo_update_matches_jax(value_only, mirror_indices):
    """One ppo_update from the same parameters, Adam state (taken after a
    first JAX update, so its moments and count are nonzero), batch and
    permutations: 2 critics, mirror on, the KL guard firing on the first
    minibatch and not on all of them."""
    rng = np.random.default_rng(3)
    B, epochs, n_mb = 64, 2, 4
    cfg_kw = dict(ppo_epoch=epochs, num_mini_batch=n_mb, kl_cutoff=0.12)
    jcfg = jppo.PPOConfig(mirror=jmirror.MirrorSpec(*mirror_indices), **cfg_kw)
    tcfg = tppo.PPOConfig(mirror=tmirror.MirrorSpec(*mirror_indices), **cfg_kw)
    net, params, policy = _nets(4)
    tx = jppo.make_optimizer(jcfg)
    obs = rng.standard_normal((B, OBS)).astype(np.float32)
    mean = np.asarray(net.apply(params, jnp.asarray(obs), method="action_mean"))
    actions = (mean + 0.2 * rng.standard_normal((B, ACT))).astype(np.float32)
    logstd = np.asarray(jnet.clamped_logstd(params))
    from steppingstone_tpu.agents import distributions as jdist

    logp = np.asarray(jdist.log_prob(jnp.asarray(mean), jnp.asarray(logstd), jnp.asarray(actions)))
    batch = dict(obs=obs, actions=actions,
                 log_probs=(logp + 0.02 * rng.standard_normal((B, 1))).astype(np.float32),
                 values=rng.standard_normal((B, 1)).astype(np.float32),
                 returns=rng.standard_normal((B, 1)).astype(np.float32),
                 adv=rng.standard_normal((B, 1)).astype(np.float32))
    # a first JAX update makes the Adam moments and count nonzero
    params, opt_state, _ = jppo.ppo_update(net.apply, tx, jcfg, params, tx.init(params),
                                           {k: jnp.asarray(v) for k, v in batch.items()},
                                           jax.random.PRNGKey(5), jnp.asarray(3e-4))
    policy.load_state_dict(tnet.params_from_jax(jax.tree.map(np.asarray, params)))
    opt_t = tppo.adam_state_from_jax(jax.tree.map(np.asarray, opt_state), policy)
    assert int(opt_t.count) == epochs * n_mb and float(opt_t.nu.abs().max()) > 0

    key = jax.random.PRNGKey(6)
    mbs = B // n_mb
    perms = draws_mod.ppo_perms(key, B, epochs, mbs * n_mb)
    # the first minibatch drifted by ~0.5 nats: the guard must skip it
    batch["log_probs"][perms[0, :mbs].numpy()] += 0.5
    lr = 3e-4
    p_j, o_j, m_j = jppo.ppo_update(net.apply, tx, jcfg, params, opt_state,
                                    {k: jnp.asarray(v) for k, v in batch.items()}, key,
                                    jnp.asarray(lr), value_only=value_only)
    before = [p.detach().clone() for p in policy.parameters()]
    o_t, m_t = tppo.ppo_update(policy, opt_t, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()},
                               lr, value_only=value_only, perms=perms)
    _assert_params_close(policy, p_j, rtol=1e-5, atol=1e-5)
    ref_opt = tppo.adam_state_from_jax(jax.tree.map(np.asarray, o_j), policy)
    assert int(o_t.count) == int(ref_opt.count) == 2 * epochs * n_mb
    np.testing.assert_allclose(o_t.mu.numpy(), ref_opt.mu.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(o_t.nu.numpy(), ref_opt.nu.numpy(), rtol=1e-5, atol=1e-10)
    for f in m_t._fields:
        np.testing.assert_allclose(float(getattr(m_t, f)), float(getattr(m_j, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    # every parameter moves (in value-only mode the actor too, on the Adam
    # momentum of the first update, as in JAX)
    assert all(not torch.equal(a, b) for a, b in zip(before, policy.parameters()))
    if not value_only:
        # the first minibatch's ~0.5-nat drift alone lifts the mean past cutoff/steps
        assert float(m_t.approx_kl) > 0.12 / (epochs * n_mb)
