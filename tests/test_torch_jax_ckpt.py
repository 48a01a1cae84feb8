"""The JAX package's checkpoints in the port: scripts/jax_ckpt_to_port.py
converts a JAX `Trainer.train` run's orbax tags into port snapshots, and
the port plays, evaluates and resumes from them; a JAX checkpoint given
to the port unconverted is refused, naming the converter.

One JAX run (Walker3D, 8 envs x 16 steps, 1 update, the fixed
curriculum, no test fleet: tests/test_runtime.py's tiny run) is shared by
the tests of this file. Tolerances: the converted policy against the JAX
network 1e-5; the resumed env state with tests/torch_jax_draws.py's
`assert_states_close` (the values are copied, so q is also held exact);
Adam's moments 1e-7; counters and curriculum keys equal."""

import os
import runpy
import shutil

os.environ["STEPPINGSTONE_NO_COMPILE_CACHE"] = "1"  # before the JAX runtime import

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_draws as draws_mod

from steppingstone_tpu.agents.networks import ActorCritic as JActorCritic
from steppingstone_tpu.envs import terrain as jterr
from steppingstone_tpu.envs.stepper import EnvState as JEnvState
from steppingstone_tpu.physics.engine import PhysicsState as JPhysicsState
from steppingstone_tpu.runtime.checkpoint import CheckpointManager as JCheckpoints
from steppingstone_tpu.runtime.config import parse_cli as jparse_cli
from steppingstone_tpu.runtime.train import Trainer as JTrainer
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.runtime import behavior_eval, enjoy, train
from steppingstone_tpu_torch.runtime.checkpoint import CheckpointManager
from steppingstone_tpu_torch.runtime.config import TrainConfig, parse_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONVERTER = os.path.join(ROOT, "scripts", "jax_ckpt_to_port.py")
# tests/test_runtime.py's tiny run (8 envs, 16 steps an update, no test
# fleet), one process, cut to one update
RUN = ["env_name=Walker3DStepperEnv-v0", "num_processes=8", "episode_steps=128",
       "mini_batch_size=64", "num_tests=0", "use_curriculum=True", "seed=1"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def convert(argv):
    return runpy.run_path(CONVERTER)["main"](argv)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX run's directory after one update, and its `latest` snapshot
    restored with no target."""
    exp = str(tmp_path_factory.mktemp("jax") / "run")
    JTrainer(jparse_cli(RUN + ["mesh_devices=1", "num_frames=128",
                               f"experiment_dir={exp}"])).train()
    snap = JCheckpoints(os.path.join(exp, "checkpoints")).restore("latest")
    return exp, snap


def _jax_env_state(d) -> JEnvState:
    """The JAX EnvState of a snapshot restored without a target."""
    return JEnvState(**{k: JPhysicsState(**v) if k == "phys" else
                        jterr.CurriculumState(**v) if k == "cur" else v for k, v in d.items()})


def _jax_leaf(tree, name: str):
    """The flax leaf behind the port parameter `name`, as the port lays it
    out (torch weights are flax kernels transposed)."""
    p = tree["params"]
    if name == "logstd":
        return np.asarray(p["logstd"])
    parts = name.split(".")
    if parts[0] == "actor":
        layer = p["actor"][f"TorchDense_{parts[2]}"]
    else:
        layer = p[f"c{parts[1]}"][f"Dense_{parts[3]}"]
    return np.asarray(layer["kernel"]).T if parts[-1] == "weight" else np.asarray(layer["bias"])


def _assert_adam_equal(port, jax_opt, policy_names_shapes):
    adam = next(x for x in jax_opt if isinstance(x, dict) and "mu" in x)
    assert int(port.count) == int(adam["count"])
    off = 0
    for name, shape in policy_names_shapes:
        n = int(np.prod(shape))
        for moment in ("mu", "nu"):
            np.testing.assert_allclose(
                getattr(port, moment)[off:off + n].reshape(shape).numpy(),
                _jax_leaf(adam[moment], name), rtol=1e-7, atol=1e-7, err_msg=f"{moment} {name}")
        off += n
    assert off == port.mu.numel()


def test_converted_policy_matches_the_jax_network(jax_run, tmp_path, capsys):
    """Every tag of the run converts; through `load_params`, the policy's
    action mean and critics equal the JAX network's within 1e-5."""
    exp, snap = jax_run
    tags = [t for t in JCheckpoints(os.path.join(exp, "checkpoints")).tags()]
    out = str(tmp_path / "port" / "checkpoints")
    done = convert([os.path.join(exp, "checkpoints"), "--out", out])
    assert sorted(done) == sorted(tags) and "latest" in done
    assert set(done.values()) == {"full"}
    assert "the random streams restart" in capsys.readouterr().out
    env = make_env("Walker3DStepperEnv-v0", device="cpu")
    state, n = enjoy.load_params(os.path.join(out, "latest"), env, 1, "cpu")
    assert n == 1
    policy = enjoy.policy_from_state(state, env, n, "cpu")
    obs = np.random.default_rng(0).standard_normal((16, 60)).astype(np.float32)
    net = JActorCritic(action_dim=21, num_ensembles=1)
    with torch.no_grad():
        for method, port in (("action_mean", policy.action_mean),
                             ("ensemble_values", policy.ensemble_values)):
            ref = np.asarray(net.apply(snap["params"], jnp.asarray(obs), method=method))
            np.testing.assert_allclose(port(torch.as_tensor(obs)).numpy(), ref,
                                       rtol=1e-5, atol=1e-5, err_msg=method)


def _resume(exp, monkeypatch, capsys) -> dict:
    """The port's train.main resumed from `exp`'s converted `latest` for
    one more update; returns the snapshot as `restore_like(make_snapshot)`
    rebuilt it."""
    restored = []
    real = CheckpointManager.restore_like
    monkeypatch.setattr(CheckpointManager, "restore_like",
                        lambda self, tag, template: restored.append(
                            real(self, tag, template)) or restored[-1])
    train.main(RUN + ["num_frames=256", "resume=True", f"experiment_dir={exp}"], device="cpu")
    assert "resumed from update 1" in capsys.readouterr().out
    (got,) = restored
    return got


def test_converted_run_resumes_in_the_port(jax_run, monkeypatch, capsys):
    """The converted `latest`, written beside the orbax tag in the JAX
    run's own checkpoints directory (a port .pt wins there), restores
    through the port's `restore_like(make_snapshot)` equal to the JAX
    snapshot (env state, both Adam states, counters, curriculum keys), and
    the port's train.main resumes it for one more update, continuing the
    run's progress.csv."""
    exp, snap = jax_run
    convert([os.path.join(exp, "checkpoints"), "--tags", "latest", "--out",
             os.path.join(exp, "checkpoints")])
    got = _resume(exp, monkeypatch, capsys)
    draws_mod.assert_states_close(got["env_state"], _jax_env_state(snap["env_state"]))
    np.testing.assert_array_equal(got["env_state"].phys.q.numpy(),
                                  np.asarray(snap["env_state"]["phys"]["q"]))
    np.testing.assert_array_equal(got["obs"].numpy(), np.asarray(snap["obs"]))
    for f in ("ret", "length", "valid"):
        np.testing.assert_array_equal(getattr(got["stats"], f).numpy(),
                                      np.asarray(snap["stats"][f]))
    env = make_env("Walker3DStepperEnv-v0", device="cpu")
    shapes = [(k, tuple(v.shape)) for k, v in
              enjoy.policy_from_state(got["policy"], env, 1, "cpu").named_parameters()]
    _assert_adam_equal(got["opt_state"], snap["opt_state"], shapes)
    _assert_adam_equal(got["value_opt_state"], snap["value_opt_state"], shapes)
    for k in ("update", "frames", "max_ep_reward"):
        assert got[k] == np.asarray(snap[k]).item(), k
    # the JAX key is not carried: the port's generators restart from the run's seeds
    assert got["generators"] == train.Trainer(parse_cli(RUN), device="cpu").generator_seeds()
    assert got["curriculum"] == {k: np.asarray(v).item() for k, v in snap["curriculum"].items()}
    rows = open(os.path.join(exp, "progress.csv")).read().strip().splitlines()
    assert rows[-1].split(",")[0] == "2"


def _write_layout(src_snap, exp, kind):
    """A JAX run directory whose `latest` holds `src_snap` cut to an older
    layout (tests/test_runtime.py's legacy resume)."""
    if kind == "r2-layout":
        cut = {k: v for k, v in src_snap.items() if k != "value_opt_state"}
    else:
        cut = {k: src_snap[k] for k in ("params", "opt_state", "update", "frames",
                                        "max_ep_reward")}
    JCheckpoints(os.path.join(exp, "checkpoints")).save("latest", cut)
    return cut


@pytest.mark.parametrize("kind", ["r2-layout", "params-only"])
def test_legacy_layouts_convert(jax_run, tmp_path, kind, monkeypatch, capsys):
    """The r2 and params-only layouts convert, each missing field filled
    as the JAX resume fills it, and said: a fresh value Adam state; for
    params-only a fresh fleet from the run's seed with the initial
    curricula, no completed episode, no test returns and the strategies'
    initial keys. The port resumes each for one more update; the JAX key is
    never carried."""
    exp, snap = jax_run
    legacy = str(tmp_path / "legacy")
    os.makedirs(legacy)
    shutil.copy(os.path.join(exp, "configs.json"), legacy)
    _write_layout(snap, legacy, kind)
    ckpts = os.path.join(legacy, "checkpoints")
    assert convert([ckpts, "--out", ckpts]) == {"latest": kind}
    said = capsys.readouterr().out
    assert "filled value_opt_state" in said and "the random streams restart" in said
    got = _resume(legacy, monkeypatch, capsys)
    env = make_env("Walker3DStepperEnv-v0", device="cpu")
    shapes = [(k, tuple(v.shape)) for k, v in
              enjoy.policy_from_state(got["policy"], env, 1, "cpu").named_parameters()]
    _assert_adam_equal(got["opt_state"], snap["opt_state"], shapes)
    assert int(got["value_opt_state"].count) == 0
    assert not got["value_opt_state"].mu.any() and not got["value_opt_state"].nu.any()
    assert got["update"] == 1 and got["frames"] == int(snap["frames"])
    if kind == "r2-layout":
        draws_mod.assert_states_close(got["env_state"], _jax_env_state(snap["env_state"]))
        return
    assert "filled env_state" in said and "filled test_rets" in said
    # the fleet the converter drew equals a fresh port start's
    trainer = train.Trainer(parse_cli(RUN), device="cpu")
    strategies = trainer.make_strategies()
    env_state, obs, _, _ = trainer.fresh_fleets(strategies)
    np.testing.assert_array_equal(got["env_state"].phys.q.numpy(), env_state.phys.q.numpy())
    np.testing.assert_array_equal(got["obs"].numpy(), obs.numpy())
    assert got["curriculum"] == strategies.snapshot_keys(-1, trainer.cfg.first_sampling)
    assert torch.isnan(got["test_rets"]).all() and not got["stats"].valid.any()


def test_unconverted_jax_checkpoints_are_refused(jax_run, tmp_path):
    """resume=True, load_params, a warm start (net=) and the behavior
    evaluation on a JAX run's orbax tags raise ValueError naming the
    converter, and the resume writes nothing beside them."""
    exp, snap = jax_run
    run = str(tmp_path / "jaxonly")
    shutil.copytree(os.path.join(exp, "checkpoints"), os.path.join(run, "checkpoints"),
                    ignore=shutil.ignore_patterns("*.pt"))
    latest = os.path.join(run, "checkpoints", "latest")
    env = make_env("Walker3DStepperEnv-v0", device="cpu")
    with pytest.raises(ValueError, match="jax_ckpt_to_port.py"):
        train.main(RUN + ["num_frames=256", "resume=True", f"experiment_dir={run}"],
                   device="cpu")
    assert not [f for f in os.listdir(os.path.join(run, "checkpoints")) if f.endswith(".pt")]
    with pytest.raises(ValueError, match="jax_ckpt_to_port.py"):
        enjoy.load_params(latest, env, 1, "cpu")
    with pytest.raises(ValueError, match="jax_ckpt_to_port.py"):
        enjoy.load_params(latest + os.sep, env, 1, "cpu")
    cfg = TrainConfig(num_processes=8, episode_steps=128, num_tests=0, net=latest)
    with pytest.raises(ValueError, match="jax_ckpt_to_port.py"):
        train.Trainer(cfg, device="cpu").init_params()
    with pytest.raises(ValueError, match="jax_ckpt_to_port.py"):
        behavior_eval.main([run, "--envs", "2", "--steps", "1", "--levels", "0"], device="cpu")
