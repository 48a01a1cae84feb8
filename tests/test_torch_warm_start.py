"""Port parity, warm starts: `Trainer.init_params` with `net=` (a port
checkpoint, with or without `.pt`, or a reference-layout pickle with 1, 2,
11 or a legacy critic) and with `load_saved_controller`, against the JAX
package's `Trainer.init_params` on the same pickle; the training CLI run
from a warm start.

Tolerances: the loaded weights are the checkpoint's exactly and every
logstd is `warm_start_logstd`; against the JAX package's warm start (its
flax kernels the pickle's transposed) within 1e-6."""

import csv
import os

os.environ["STEPPINGSTONE_NO_COMPILE_CACHE"] = "1"  # before the JAX runtime import

import jax
import numpy as np
import pytest
import torch
from reference_policy import write_reference_policy

from steppingstone_tpu.runtime import config as jconfig
from steppingstone_tpu.runtime.train import Trainer as JTrainer
from steppingstone_tpu_torch.agents.networks import ActorCritic, params_from_jax
from steppingstone_tpu_torch.runtime import config as tconfig
from steppingstone_tpu_torch.runtime.checkpoint import CheckpointManager
from steppingstone_tpu_torch.runtime.train import Trainer, main

TINY = dict(env_name="Walker3DStepperEnv-v0", num_processes=4, episode_steps=32,
            mini_batch_size=16, num_frames=32, num_tests=0)
LAYOUTS = {"1": (1, False), "2": (2, False), "11": (11, False), "legacy": (1, True)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _trainer(**kw):
    return Trainer(tconfig.TrainConfig(**{**TINY, **kw}), device="cpu")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_warm_start_from_reference_pickle_matches_jax(tmp_path, capsys, layout):
    n, legacy = LAYOUTS[layout]
    path = str(tmp_path / "Walker3DStepperEnv-v0_base.pt")
    sd = write_reference_policy(path, 60, 21, n, legacy, seed=n)
    kw = dict(net=path, num_ensembles=n, warm_start_logstd=-2.0)

    policy = _trainer(**kw).init_params()
    assert f"Loading model {path}" in capsys.readouterr().out
    assert len(policy.critics) == n and policy.logstd.device.type == "cpu"
    assert torch.equal(policy.actor.layers[2].weight.detach(), sd["actor.fc3.weight"])
    last = "critic" if legacy else f"c{n - 1}"
    assert torch.equal(policy.critics[n - 1].layers[0].bias.detach(), sd[f"{last}.0.bias"])
    assert torch.equal(policy.logstd.detach(), torch.full((21,), -2.0))

    params = JTrainer(jconfig.TrainConfig(mesh_devices=1, **TINY, **kw)).init_params(
        jax.random.PRNGKey(0))
    ref = params_from_jax(jax.tree.map(np.asarray, params))
    got = policy.state_dict()
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_warm_start_from_port_checkpoint(tmp_path):
    source = ActorCritic(60, 21, 2, device="cpu", generator=torch.Generator().manual_seed(4))
    ckpt = CheckpointManager(str(tmp_path / "checkpoints"))
    ckpt.save("best", {"policy": source.state_dict(), "update": 3})
    ckpt.save("specialist_2", {"policy": source.state_dict()})
    for net in ("best", "best.pt", "specialist_2"):
        policy = _trainer(net=str(tmp_path / "checkpoints" / net), num_ensembles=2,
                          warm_start_logstd=-2.0).init_params()
        for k, v in source.state_dict().items():
            if k == "logstd":
                assert torch.equal(policy.logstd.detach(), torch.full((21,), -2.0))
            else:
                assert torch.equal(policy.state_dict()[k], v), k
    # the warm start is not an inert key once it is used
    cfg = tconfig.TrainConfig(**TINY, net="x")
    assert "warm_start_logstd" not in cfg.inert_keys()
    assert "warm_start_logstd" in tconfig.TrainConfig(**TINY).inert_keys()


def test_warm_start_refusals(tmp_path, monkeypatch):
    path = str(tmp_path / "ref.pt")
    write_reference_policy(path, 60, 21, 2)
    with pytest.raises(SystemExit, match="checkpoint has 2 critics, config wants 1"):
        _trainer(net=path).init_params()
    # the reference's models are looked for under reference/ in the working
    # directory; without them the warm start names the path it tried
    monkeypatch.chdir(tmp_path)
    default = os.path.join("reference", "playground", "models", "Walker3DStepperEnv-v0_base.pt")
    with pytest.raises(FileNotFoundError, match=default):
        _trainer(load_saved_controller=True).init_params()
    os.makedirs(os.path.dirname(default))
    write_reference_policy(default, 60, 21, 1)
    assert torch.equal(_trainer(load_saved_controller=True).init_params().logstd.detach(),
                       torch.full((21,), -2.5))


def test_cli_trains_from_a_warm_start(tmp_path):
    """A tiny CPU run of the training CLI from a reference pickle writes the
    reference progress.csv; its first checkpoint's policy is the warm
    start after one update."""
    path = str(tmp_path / "ref.pt")
    write_reference_policy(path, 60, 21, 2)
    exp = str(tmp_path / "run")
    main(["env_name=Walker3DStepperEnv-v0", "num_processes=8", "episode_steps=128",
          "mini_batch_size=64", "num_frames=256", "num_tests=0", "num_ensembles=2",
          f"net={path}", "warm_start_logstd=-2.0", "kl_cutoff=0.12", "lr_warmup_updates=20",
          f"experiment_dir={exp}"], device="cpu")
    with open(os.path.join(exp, "progress.csv"), newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["iter", "total_num_steps", "fps", "entropy", "value_loss",
                       "action_loss", "mean_rew", "median_rew", "min_rew", "max_rew",
                       "test_mean_rew", "test_median_rew", "test_min_rew", "test_max_rew"]
    snap = CheckpointManager(os.path.join(exp, "checkpoints")).restore("latest")
    assert snap["update"] == 2
    logstd = snap["policy"]["logstd"]
    assert torch.all((logstd - -2.0).abs() < 0.05) and not torch.equal(logstd, torch.full((21,), -2.0))
