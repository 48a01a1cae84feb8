"""Port parity, parallel/: the env-sharded trainer over two gloo ranks on
the CPU (steppingstone_tpu_torch.parallel.launch.spawn starts them; they
run tests/torch_parallel_workers.py, which imports no JAX) against the
same work in one process, and its Cassie iteration against the JAX
Trainer at mesh_devices=2 on the virtual CPU devices of tests/conftest.py.

Tolerances: shard, replicate and gather move values and are exact; the
reset and step draws of a shard are its rows of the single process's,
exactly. The global mean and std are fp32 sums taken in another order
(rel 1e-6). A sharded ppo_update sums the ranks' gradients and loss terms
in another order than one process: rel 1e-5 on parameters, Adam state and
metrics, as the port is held to JAX (tests/test_torch_learner.py). The
Cassie iteration keeps tests/test_torch_train.py's 1e-3, and a two-rank
train.main run tests/test_runtime.py's rel 1e-5 / abs 1e-6 on every
progress.csv column but fps and on the value grids; the sampling
probabilities, softmax(-150 x grid), are held to the bound that the
grids' difference puts on them (each log-probability moves by at most
2 x 150 x the largest grid difference)."""

import dataclasses
import os

os.environ["STEPPINGSTONE_NO_COMPILE_CACHE"] = "1"  # before the JAX runtime import

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_draws as draws_mod
import torch_parallel_workers as workers

from steppingstone_tpu.agents.rollout import EpisodeStats as JStats
from steppingstone_tpu.parallel import mesh as jmesh
from steppingstone_tpu.runtime import config as jconfig
from steppingstone_tpu.runtime.train import Trainer as JTrainer
from steppingstone_tpu_torch.agents import networks as tnet
from steppingstone_tpu_torch.agents import ppo as tppo
from steppingstone_tpu_torch.parallel import mesh as pmesh
from steppingstone_tpu_torch.parallel.dryrun import dryrun_multichip
from steppingstone_tpu_torch.parallel.launch import spawn
from steppingstone_tpu_torch.runtime import train as ttrain
from steppingstone_tpu_torch.runtime.config import TrainConfig

WORLD = 2
# each spawn's limit: about 3x the file's longest test in a whole run, so a
# hung rank fails its own test well inside the suite's time limit
RANK_TIMEOUT_S = 300


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=what)


def test_shard_replicate_gather_and_reductions():
    n = 6
    ranks = spawn(workers.trees, WORLD, (n,), timeout=RANK_TIMEOUT_S)
    full, by_time = workers.fleet_tree(n)
    x = by_time.numpy().astype(np.float64)
    single_mean, single_std = pmesh.global_mean_std(pmesh.SINGLE, by_time)
    for r in ranks:
        sl = slice(r["rank"] * n // WORLD, (r["rank"] + 1) * n // WORLD)
        assert r["world"] == WORLD
        np.testing.assert_array_equal(r["local_ret"], full["stats"].ret.numpy()[sl])
        np.testing.assert_array_equal(r["local_t"], by_time.numpy()[:, sl])
        np.testing.assert_array_equal(r["gathered_ret"], full["stats"].ret.numpy())
        np.testing.assert_array_equal(r["gathered_length"], full["stats"].length.numpy())
        np.testing.assert_array_equal(r["gathered_valid"], full["stats"].valid.numpy())
        np.testing.assert_array_equal(r["gathered_terrain"], full["terrain"].numpy())
        np.testing.assert_array_equal(r["gathered_t"], by_time.numpy())
        assert r["label"] == "fleet" and r["bool_dtype"] == "torch.bool"
        np.testing.assert_array_equal(r["replicated"][0], np.zeros((3, 4)))
        np.testing.assert_array_equal(r["replicated"][1], np.arange(5))
        np.testing.assert_array_equal(r["summed"], [3.0, 4.0])
        _rel(r["mean"], x.mean(), 1e-6, 1e-7, "mean")
        _rel(r["std"], x.std(), 1e-6, 0.0, "std")
        _rel(r["mean"], single_mean, 1e-6, 1e-7, "mean against one process")
        _rel(r["std"], single_std, 1e-6, 0.0, "std against one process")
        # the clock counted each collective and its bytes: 5 gathered
        # tensors, 2 broadcast, the mean's, the std's and the summed
        # all-reduce
        n_local = n // WORLD
        assert r["clock"] == {"all_gather": (5, n_local * (4 + 8 + 1 + 20 * 6 * 4 + 7 * 4)),
                              "broadcast": (2, 12 * 4 + 5 * 8), "all_reduce": (3, 4 + 4 + 8)}, (
            r["clock"])


def test_shard_draws_are_its_rows_of_the_fleets():
    """A shard's reset and step draws (the grid cells searched in its own
    envs' probabilities) are its rows of the single-process fleet's, and
    a rollout with action noise follows the single-process rollout."""
    n, steps = 8, 3
    ranks = spawn(workers.fleet_draws, WORLD, (n, steps), timeout=RANK_TIMEOUT_S)
    single = workers.fleet_draws(n, steps, pmesh.SINGLE)
    one = lambda tree: jax.tree.map(lambda x: x.numpy(), tree)
    ref = {k: one(single[k]) for k in ("reset", "step")}
    for rank, r in enumerate(ranks):
        sl = slice(rank * n // WORLD, (rank + 1) * n // WORLD)
        for k in ("reset", "step"):
            jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b[sl]), r[k], ref[k])
        _rel(r["actions"], single["actions"].numpy()[:, sl], 1e-5, 1e-5, "actions")
        _rel(r["rewards"], single["rewards"].numpy()[:, sl], 1e-5, 1e-5, "rewards")
        _rel(r["obs"], single["obs"].numpy()[sl], 1e-5, 1e-5, "obs")
        np.testing.assert_array_equal(r["terrain"], single["terrain"].numpy()[sl])
    # grid mode drew from each env's own cells only
    cells = ref["reset"].stones.cat[::2]
    prob = workers.fleet_curriculum(n).sample_prob.reshape(n, -1).numpy()[::2]
    assert np.all(np.take_along_axis(prob, cells, axis=1) > 0)


@pytest.mark.parametrize("value_only", [False, True])
def test_sharded_ppo_update_equals_one_process(value_only):
    """Mirror on, 2 critics, the KL guard firing on the first minibatch,
    which rank 1 holds no row of."""
    ranks = spawn(workers.ppo_sharded, WORLD, (value_only,), timeout=RANK_TIMEOUT_S)
    policy, opt, cfg, batch, perms = workers.ppo_case()
    opt, metrics = tppo.ppo_update(policy, opt, cfg, batch, 3e-4, value_only=value_only,
                                   perms=perms)
    ref = workers.ppo_result(policy, opt, metrics)
    mbs = batch["obs"].shape[0] // workers.PPO_MB
    assert [r["minibatch_rows"][0] for r in ranks] == [mbs, 0]
    for r in ranks:
        _rel(r["params"], ref["params"], 1e-5, 1e-7, "parameters")
        assert int(r["count"]) == int(ref["count"]) == 3 + workers.PPO_EPOCHS * workers.PPO_MB
        _rel(r["mu"], ref["mu"], 1e-5, 1e-7, "mu")
        _rel(r["nu"], ref["nu"], 1e-5, 1e-10, "nu")
        for f, v in ref["metrics"].items():
            _rel(r["metrics"][f], v, 1e-5, 1e-7, f)
    np.testing.assert_array_equal(ranks[0]["params"], ranks[1]["params"])
    if not value_only:
        # the guard skipped the first minibatch on both ranks alike
        assert ref["metrics"]["approx_kl"] > 0.12 / (workers.PPO_EPOCHS * workers.PPO_MB)


N, T = 8, 8
CASSIE = dict(env_name="CassieStepper-v1", plank_class="LargePlank", use_phase_mirror=True,
              num_ensembles=2, kl_cutoff=0.12, num_processes=N, episode_steps=N * T,
              mini_batch_size=N * T // 2, ppo_epoch=2, num_tests=0, num_frames=N * T)


def test_sharded_cassie_iteration_matches_jax_mesh(tmp_path):
    """tests/test_torch_train.py's Cassie iteration with the JAX Trainer at
    mesh_devices=2 (its env state, observations and stats sharded over two
    devices) and the port on two ranks, each fed its envs' rows of the JAX
    run's draws."""
    jt = JTrainer(jconfig.TrainConfig(mesh_devices=WORLD, **CASSIE))
    assert jt.mesh is not None and len(jt.mesh.devices.flat) == WORLD
    params = jt.init_params(jax.random.PRNGKey(0))
    opt_state = jt.tx.init(params)
    env_state, obs = jt.venv.reset(jax.random.PRNGKey(1))
    env_state = jt.venv.set_mirror(env_state, True)
    i32 = lambda x: jnp.asarray(x, jnp.int32)
    env_state = env_state._replace(
        phase=jnp.full((N,), 0.4, jnp.float32),
        elapsed=i32([995, 995, 300, 300, 0, 0, 0, 0]),
        last_hit=i32([995, 995, 125, 125, 0, 0, 0, 0]))
    key, lr = jax.random.PRNGKey(2), 3e-4
    host = jax.tree.map(np.array, (params, opt_state, env_state, obs))
    out = jt._train_iteration(
        jmesh.replicate_tree(jt.mesh, params), jmesh.replicate_tree(jt.mesh, opt_state),
        jmesh.shard_env_tree(jt.mesh, env_state), jmesh.shard_env_tree(jt.mesh, obs),
        jmesh.shard_env_tree(jt.mesh, JStats.init(N)), key, jnp.asarray(lr, jnp.float32))
    p_j, _, st_j, obs_j, stats_j, _, m_j, aux_j = jax.tree.map(np.asarray, out)

    _, k_roll, k_upd = jax.random.split(key, 3)
    noise, env_draws = draws_mod.rollout_draws(
        k_roll, host[2].key, host[2].cur.sample_prob, aux_j["ep_done"], T, N, 10, 20,
        2 * 14 + 3)
    port = ttrain.Trainer(TrainConfig(**CASSIE), device="cpu")
    policy = port.init_params()
    policy.load_state_dict(tnet.params_from_jax(host[0]))
    case = dict(config=CASSIE, policy=policy.state_dict(), lr=lr,
                opt=tppo.adam_state_from_jax(host[1], policy),
                state=draws_mod.to_port_state(host[2]), obs=torch.as_tensor(host[3]),
                noise=noise, env_draws=env_draws,
                perms=draws_mod.ppo_perms(k_upd, N * T, 2, N * T))
    torch.save(case, tmp_path / "case.pt")
    ranks = spawn(workers.cassie_iteration, WORLD, (str(tmp_path / "case.pt"),),
                  timeout=RANK_TIMEOUT_S)

    cat = lambda k, dim=0: np.concatenate([r[k] for r in ranks], axis=dim)
    np.testing.assert_array_equal(cat("ep_done", 1), aux_j["ep_done"])
    assert sum(int(r["hits"]) for r in ranks) == int(aux_j["hits"])
    _rel(cat("ep_return", 1), aux_j["ep_return"], 1e-3, 1e-3, "ep_return")
    _rel(cat("obs"), obs_j, 1e-3, 1e-3, "obs")
    _rel(cat("q"), st_j.phys.q, 1e-3, 1e-3, "q")
    _rel(cat("qd"), st_j.phys.qd, 1e-3, 1e-2, "qd")
    np.testing.assert_array_equal(cat("next_step_index"), st_j.next_step_index)
    _rel(cat("phase"), st_j.phase, 0.0, 1e-6, "phase")
    np.testing.assert_array_equal(cat("valid"), stats_j.valid)
    _rel(cat("ret"), stats_j.ret, 1e-3, 1e-3, "ret")
    ref = tnet.params_from_jax(p_j)
    for r in ranks:
        for f in m_j._fields:
            _rel(r["metrics"][f], float(getattr(m_j, f)), 1e-3, 1e-3, f)
        for name, p in r["params"].items():
            _rel(p, ref[name].numpy(), 1e-3, 1e-3, name)
        assert int(r["count"]) == 4
    # both kinds of episode end, on both ranks' envs
    ends = cat("ep_done", 1).sum(axis=0)
    assert ends[:4].min() >= 1, ends
    np.testing.assert_array_equal(cat("length")[:2], [1000, 1000])


TINY = ["env_name=Walker3DStepperEnv-v0", "num_processes=8", "episode_steps=128",
        "mini_batch_size=64", "num_tests=0", "use_curriculum=True", "seed=3",
        "checkpoint_interval=1", "episode_log=True"]


def _csv(path):
    rows = path.read_text().strip().splitlines()
    header = rows[0].split(",")
    return header, [dict(zip(header, r.split(","))) for r in rows[1:]]


def test_train_main_over_two_ranks_resumes_and_equals_one_process(tmp_path):
    """tests/test_runtime.py's two-process run through torchrun's
    variables: 2 updates, then a resume to 3; rank 0 alone writes
    progress.csv, episodes.csv and the checkpoints; every column but fps
    equals an unbroken single-process run of the same seed. Three updates,
    not four: the ranks sum the gradients in another order than one
    process, and Adam, which divides each gradient by its own running
    norm, grows that rounding about tenfold an update (value_loss rel
    5e-7, 1.4e-6, 1.5e-5, 1e-4 at updates 2-5 of this run), past rel
    1e-5 at update 4."""
    ttrain.main(TINY + ["num_frames=384", f"experiment_dir={tmp_path / 'one'}"], device="cpu")
    header1, one = _csv(tmp_path / "one" / "progress.csv")
    logged = [r["iter"] for r in one]  # the updates with two or more episodes
    exp = tmp_path / "ranks"
    outs = spawn(workers.train_main, WORLD, (TINY + ["num_frames=256", f"experiment_dir={exp}"],),
                 timeout=RANK_TIMEOUT_S)
    assert all("distributed: process" in o["stdout"] for o in outs)
    assert "Updates 2" in outs[0]["stdout"] and "Updates" not in outs[1]["stdout"]
    assert sorted(os.listdir(exp)) == ["checkpoints", "configs.json", "episodes.csv",
                                       "progress.csv", "run.json"]
    assert sorted(os.listdir(exp / "checkpoints")) == ["10000000.pt", "best.pt", "latest.pt"]
    _, rows = _csv(exp / "progress.csv")
    assert [r["iter"] for r in rows] == [i for i in logged if int(i) <= 2]
    outs = spawn(workers.train_main, WORLD,
                 (TINY + ["num_frames=384", "resume=True", f"experiment_dir={exp}"],),
                 timeout=RANK_TIMEOUT_S)
    assert all("resumed from update 2" in o["stdout"] for o in outs)
    assert not [f for f in os.listdir(exp) if ".bak" in f]
    header, rows = _csv(exp / "progress.csv")
    assert header == header1 and [r["iter"] for r in rows] == logged and "3" in logged
    for a, b in zip(rows, one):
        for col in header:
            if col != "fps":
                assert float(a[col]) == pytest.approx(float(b[col]), rel=1e-5, abs=1e-6), (
                    a["iter"], col)
    # episodes.csv: the gathered fleet's episodes, in the single run's order
    _, eps = _csv(exp / "episodes.csv")
    _, eps1 = _csv(tmp_path / "one" / "episodes.csv")
    assert len(eps) == len(eps1) > 0
    for a, b in zip(eps, eps1):
        assert a["l"] == b["l"] and float(a["r"]) == pytest.approx(float(b["r"]), rel=1e-5,
                                                                  abs=1e-3)


def test_every_strategy_runs_sharded_as_in_one_process(tmp_path):
    """The specialist schedule and the value-based adaptive and threshold
    sampling (the fixed curriculum: the train.main test above) over two
    ranks, with a sharded test fleet every update: each run's
    progress.csv and sampling pickles equal one process's."""
    import pickle

    [ranks, _] = spawn(workers.train_strategies, WORLD, (str(tmp_path / "ranks"),),
                       timeout=RANK_TIMEOUT_S)
    workers.train_strategies(str(tmp_path / "one"), single=True)
    for case in workers.STRATEGIES:
        assert ranks[case] == (4, 1), case
        header, rows = _csv(tmp_path / "ranks" / case / "progress.csv")
        _, one = _csv(tmp_path / "one" / case / "progress.csv")
        assert [r["iter"] for r in rows] == [r["iter"] for r in one] and rows, case
        for a, b in zip(rows, one):
            for col in header:
                if col != "fps":
                    assert float(a[col]) == pytest.approx(float(b[col]), rel=1e-5, abs=1e-6), (
                        case, a["iter"], col)
        pkl = {(run, what): tmp_path / run / case / f"Walker3DStepperEnv-v0_{what}.pkl"
               for run in ("ranks", "one") for what in ("sampling_prob", "value_grid")}
        assert all(p.exists() == (case != "specialist") for p in pkl.values()), case
        if case == "specialist":
            continue
        got = {k: np.stack(pickle.loads(p.read_bytes())) for k, p in pkl.items()}
        grid, grid1 = got["ranks", "value_grid"], got["one", "value_grid"]
        np.testing.assert_allclose(grid, grid1, rtol=1e-5, atol=1e-6, err_msg=case)
        # softmax(-scale x f(grid)), f 1-Lipschitz, moves each log-probability
        # by at most 2 x scale x max |grid difference|
        bound = 2 * TrainConfig().sampling_scale * np.abs(grid - grid1).max()
        np.testing.assert_allclose(got["ranks", "sampling_prob"], got["one", "sampling_prob"],
                                   rtol=np.expm1(bound), atol=1e-12, err_msg=case)


def test_validate_and_fleets_over_the_ranks():
    out = spawn(workers.config_checks, WORLD, timeout=RANK_TIMEOUT_S)[0]
    assert "must divide over 2 ranks" in out["indivisible fleet"]
    assert "contradicts the 2 rank(s)" in out["mesh_devices=1"]
    assert "contradicts the 2 rank(s)" in out["mesh_devices=3"]
    assert out["test fleet divides"] == (4, 2, 2)
    assert out["test fleet whole on each rank"] == (4, 3, 1)
    # one process: mesh_devices names more ranks than run
    with pytest.raises(ValueError, match="contradicts the 1 rank"):
        dataclasses.replace(TrainConfig(), mesh_devices=2).validate()


def test_initialize_is_a_noop_without_torchrun_and_never_falls_back(monkeypatch):
    """Without torchrun's variables no process group starts and the mesh is
    the single process; with them, a rank asked for the card on a host
    without one, or for NCCL where PyTorch has none, raises before it
    joins anything."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert pmesh.maybe_initialize_distributed() is False
    assert pmesh.make_mesh() == pmesh.SINGLE and pmesh.rank_device() is None
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.maybe_initialize_distributed()
    if not torch.distributed.is_nccl_available():
        with pytest.raises(RuntimeError, match="nccl"):
            pmesh.maybe_initialize_distributed("nccl", device="cpu")
    assert not torch.distributed.is_initialized()


def test_dryrun_multichip_on_the_cpu():
    """parallel.dryrun at 16 envs x 2 steps over two gloo ranks: the losses
    within the JAX package's rel 1e-3 of one process (here within 1e-5),
    the ranks' learners equal."""
    out = dryrun_multichip(WORLD, device="cpu", n_envs=16)
    assert max(out["rel"].values()) < 1e-5
    np.testing.assert_allclose(out["ranks"][0]["params"], out["single"]["params"], rtol=1e-5,
                               atol=1e-7)
