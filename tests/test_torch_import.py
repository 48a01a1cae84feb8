"""Port parity, the reference-checkpoint import: a policy pickled in the
reference's layout (tests/reference_policy.py: a `common.`-named module
saved whole, its classes gone at load time) read by
steppingstone_tpu_torch.runtime.torch_import and by the JAX package's
loader, with 1, 2 and 11 critics and in the legacy single-`critic` layout.

Tolerances: the two networks run the same fp32 weights (the port's exactly
the pickle's, the JAX package's transposed for flax) through 256-wide
layers in two frameworks: action means, ensemble values and logstd within
1e-5."""

import os

os.environ["STEPPINGSTONE_NO_COMPILE_CACHE"] = "1"  # before the JAX runtime import

import jax
import numpy as np
import pytest
import torch
from reference_policy import write_reference_policy

from steppingstone_tpu.agents.networks import ActorCritic as JActorCritic
from steppingstone_tpu.runtime import torch_import as jimport
from steppingstone_tpu_torch.agents.networks import ActorCritic
from steppingstone_tpu_torch.runtime import torch_import as timport

OBS, ACT = 60, 21
LAYOUTS = {"1": (1, False), "2": (2, False), "11": (11, False), "legacy": (1, True)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_reference_pickle_matches_jax_import(tmp_path, layout):
    n, legacy = LAYOUTS[layout]
    path = str(tmp_path / "ref.pt")
    sd = write_reference_policy(path, OBS, ACT, n, legacy, seed=n)

    state, n_t = timport.load_reference_checkpoint(path, ACT, device="cpu")
    params, n_j = jimport.load_reference_checkpoint(path, ACT)
    assert n_t == n_j == n
    # the port's weights are the pickle's, untransposed, and critic c{i}
    # lands on critics.{i} by its number (c10 after c9, not after c1)
    prefix = (lambda i: "critic") if legacy else (lambda i: f"c{i}")
    assert torch.equal(state["actor.layers.0.weight"], sd["actor.fc1.weight"])
    assert torch.equal(state["actor.layers.5.bias"], sd["actor.out.bias"])
    for i in range(n):
        assert torch.equal(state[f"critics.{i}.layers.4.weight"], sd[f"{prefix(i)}.8.weight"])
    assert torch.equal(state["logstd"], sd["dist.logstd._bias"].reshape(-1))

    policy = ActorCritic(OBS, ACT, n, device="cpu")
    policy.load_state_dict(state)
    net = JActorCritic(action_dim=ACT, num_ensembles=n)
    obs = np.random.default_rng(3).normal(size=(8, OBS)).astype(np.float32)
    with torch.no_grad():
        mean_t = policy.action_mean(torch.as_tensor(obs)).numpy()
        values_t = policy.ensemble_values(torch.as_tensor(obs)).numpy()
    mean_j = np.asarray(net.apply(params, obs, method="action_mean"))
    values_j = np.asarray(net.apply(params, obs, method="ensemble_values"))
    np.testing.assert_allclose(mean_t, mean_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(values_t, values_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(policy.logstd.detach().numpy(),
                               np.asarray(params["params"]["logstd"]), rtol=1e-5, atol=1e-5)
    assert np.abs(values_t[:, 0] - values_t[:, -1]).max() > 1e-3 or n == 1


def test_wrong_logstd_width_raises(tmp_path):
    path = str(tmp_path / "ref.pt")
    write_reference_policy(path, OBS, ACT - 1, 2)
    with pytest.raises(ValueError, match=r"logstd has shape \(20,\)"):
        timport.load_reference_checkpoint(path, ACT, device="cpu")
    with pytest.raises(AssertionError):
        jimport.load_reference_checkpoint(path, ACT)


def test_import_defaults_to_the_card_and_refuses_other_files(tmp_path):
    path = str(tmp_path / "ref.pt")
    write_reference_policy(path, OBS, ACT, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            timport.load_reference_checkpoint(path, ACT)
    junk = tmp_path / "junk.pt"
    junk.write_text("not a pickle")
    with pytest.raises(ValueError, match="junk.pt"):
        timport.load_reference_checkpoint(str(junk), ACT, device="cpu")
    torch.save({"policy": {}}, tmp_path / "dict.pt")
    with pytest.raises(ValueError, match="dict.pt"):
        timport.load_reference_checkpoint(str(tmp_path / "dict.pt"), ACT, device="cpu")
    assert jax.default_backend() == "cpu"
