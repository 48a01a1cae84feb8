"""The port's value-based curriculum against the benchmark's plain
reference (benchmark/reference/curriculum.py), on the CPU, on weights drawn
from a seed: the value grid of Walker3D on LargePlank over an eval fleet
of 4 envs x 24 steps, with the benchmark's draws and episodes cut to 12
steps so that the fleet resets itself inside the grid (grid within 1e-4,
the same count of hit events); threshold sampling's probabilities at
scale 150 within the bound a grid gap g allows (relative exp(2 x 150 x g)
- 1); its uniform round and the install of a grid on a fleet, exact. And
`Trainer.curriculum`, the training loop's pre-update hooks, against the
inline block of `Trainer.train` it replaced: the same fan-out calls and
the same installed curricula over 3 updates."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import draws as bdraws
from benchmark.harness import seeds, system, tree
from benchmark.reference import curriculum as rcurr
from benchmark.reference import stepper as rstep
from benchmark.reference import terrain as rterr
from steppingstone_tpu_torch.agents.networks import ActorCritic
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.envs import terrain as tterr
from steppingstone_tpu_torch.envs.vector import VecEnv
from steppingstone_tpu_torch.runtime import config as tconfig
from steppingstone_tpu_torch.runtime import curriculum as tcurr
from steppingstone_tpu_torch.runtime.train import Trainer

ENV = "Walker3DStepperEnv-v0"
B, STEPS, SEED = 4, 24, 2 ** 31 + 11
CONFIG = dict(hidden=256, actor_layers=5, critic_layers=4, num_ensembles=1)
FAN_OUTS = ("update_curriculum", "update_assist", "update_specialist", "update_sample_prob")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _envs():
    port = make_env(ENV, device="cpu", plank_class="LargePlank")
    ref = rstep.walker3d_stepper(device="cpu", plank_class="LargePlank")
    port.cfg = dataclasses.replace(port.cfg, max_episode_steps=12)
    ref.cfg = dataclasses.replace(ref.cfg, max_episode_steps=12)
    return port, ref


def _policies(port_env, ref_env, seed):
    shapes = system.policy_shapes(CONFIG, port_env.observation_dim, port_env.action_dim)
    flat = seeds.weights(shapes, "cpu", seed, -1.5)
    port = ActorCritic(port_env.observation_dim, port_env.action_dim, 1, device="cpu")
    system.load(port, flat, shapes)
    ref = system.reference_policy(CONFIG, ref_env, "cpu")
    system.load(ref, flat, shapes)
    return port, ref


def _grid_draws(ref_env, seed):
    cur = rterr.default_curriculum(0, batch=B)
    nj = ref_env.cfg.model.njoints
    reset = bdraws.reset_draws(seed, cur, ref_env.cfg.n_stones, nj, "grid")
    steps = bdraws.step_draws(seed, cur, STEPS, ref_env.cfg.n_stones, nj, "grid")
    types = tree.port_types()
    port = tcurr.ValueGridDraws(tree.convert(reset, types), [tree.convert(d, types) for d in steps])
    return port, reset, steps


@pytest.fixture(scope="module")
def grids():
    """The port's and the reference's grid over the same fleet and draws."""
    torch.set_num_threads(1)
    port_env, ref_env = _envs()
    port_pol, ref_pol = _policies(port_env, ref_env, SEED)
    port_draws, reset, steps = _grid_draws(ref_env, SEED)
    vg = tcurr.ValueGrid(port_env, max_steps=STEPS, n_envs=B)
    port_grid, port_count = vg(port_pol, port_draws)
    ref_grid, ref_count, states = rcurr.value_grid(ref_env, ref_pol, B, reset, steps)
    return dict(port_env=port_env, ref_env=ref_env, port_pol=port_pol, ref_pol=ref_pol,
                port_draws=port_draws, vg=vg, port_grid=port_grid, port_count=port_count,
                ref_grid=ref_grid, ref_count=ref_count, states=states)


def test_value_grid_equals_the_reference(grids):
    g = grids
    assert int(g["port_count"]) == int(g["ref_count"]) == g["vg"].last_count > 0
    # the fleet reset itself inside the grid: some env's step count fell
    elapsed = torch.stack([s.elapsed for s in g["states"]])
    assert bool((elapsed[1:] < elapsed[:-1]).any())
    gap = float((g["port_grid"] - g["ref_grid"]).abs().max())
    assert gap <= 1e-4 and float(g["ref_grid"].abs().max()) == pytest.approx(1.0, abs=1e-6)


def test_threshold_probabilities_within_the_grid_gap_bound(grids):
    g = grids
    venv = VecEnv(g["port_env"], B, device="cpu", seed=1)
    state, _ = venv.reset()
    thr = tcurr.ThresholdSampling(venv, g["port_env"], threshold=0.85, scale=150.0,
                                  value_grid=g["vg"])
    thr.uniform_sampling = False
    state = thr.pre_update(state, g["port_pol"], draws=g["port_draws"])
    ref_probs = rcurr.threshold_probs(g["ref_grid"], 150.0, 0.85)
    want = rcurr.install(tree.convert(state.cur, tree.reference_types()), ref_probs)
    grid_gap = float((g["port_grid"] - g["ref_grid"]).abs().max())
    rel = ((state.cur.sample_prob - want.sample_prob).abs() / want.sample_prob).max()
    assert float(rel) <= np.expm1(2 * 150.0 * grid_gap) + 1e-6
    assert bool(state.cur.use_prob.all())
    np.testing.assert_allclose(thr.last_grid, g["port_grid"].numpy())


def test_uniform_round_equals_the_reference():
    port_env, _ = _envs()
    venv = VecEnv(port_env, B, device="cpu", seed=2)
    state, _ = venv.reset(tterr.default_curriculum(0, batch=B))
    state = venv.update_specialist(state, 1)  # a grid installed before the round
    thr = tcurr.ThresholdSampling(venv, port_env, value_grid=object())
    got = thr.pre_update(state, policy=None, assist=0.4).cur
    want = rcurr.uniform_round(tree.convert(state.cur, tree.reference_types()), 0.4)
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert thr.last_probs is None and thr.last_grid is None


def test_install_on_a_fleet_equals_the_reference():
    port_env, _ = _envs()
    venv = VecEnv(port_env, B, device="cpu", seed=3)
    state, _ = venv.reset(tterr.default_curriculum(2, batch=B))
    probs = torch.rand((tterr.GRID, tterr.GRID), generator=torch.Generator().manual_seed(4))
    got = venv.update_sample_prob(state, probs).cur
    want = rcurr.install(tree.convert(state.cur, tree.reference_types()), probs)
    for name in got._fields:
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=1e-9)


def _old_block(trainer, strategies, policy, env_state, test_state, j, first_sampling):
    """`Trainer.train`'s pre-update block as it stood before `Trainer.curriculum`."""
    cfg = trainer.cfg
    fixed, assist, _, adaptive, threshold = strategies
    if fixed:
        env_state = fixed.tick(env_state)
    if assist:
        env_state = assist.tick(env_state)
    value_only = cfg.use_value_update and j % 2 == 1
    if value_only and threshold:
        env_state = trainer.venv.update_curriculum(env_state, tterr.N_LEVELS - 1,
                                                   assist=assist.frac if assist else None)
    elif not value_only and threshold and first_sampling:
        env_state = trainer.venv.update_specialist(env_state, 0)
        first_sampling = False
    if threshold:
        env_state = threshold.pre_update(env_state, policy, assist=assist.frac if assist else None)
    if adaptive:
        env_state = adaptive.pre_update(env_state, policy)
    if cfg.test_curriculum and trainer.test_venv is not None and fixed:
        test_state = trainer.test_venv.update_curriculum(test_state, fixed.frac)
    if assist and trainer.test_venv is not None:
        test_state = trainer.test_venv.update_assist(test_state, assist.frac)
    return env_state, test_state, value_only, first_sampling


def _spied_trainer(args, calls):
    cfg = tconfig.parse_cli([f"env_name={ENV}", "num_processes=4", "episode_steps=16",
                             "mini_batch_size=8", "num_tests=2", "seed=5",
                             "level_ramp_updates=2", *args])
    trainer = Trainer(cfg, device="cpu")
    trainer.value_grid = tcurr.make_value_grid_fn(trainer.env, max_steps=8, n_envs=4,
                                                  seed=cfg.seed + 2)
    for fleet, venv in (("train", trainer.venv), ("test", trainer.test_venv)):
        for name in FAN_OUTS:
            def spy(state, *a, _name=name, _fn=getattr(venv, name), _fleet=fleet, **kw):
                calls.append((_fleet, _name) + tuple(float(x) for x in a if not torch.is_tensor(x))
                             + tuple(None if v is None else float(v) for v in kw.values()))
                return _fn(state, *a, **kw)
            setattr(venv, name, spy)
    return trainer


@pytest.mark.parametrize("args", [
    ["use_threshold_sampling=True"],
    ["use_threshold_sampling=True", "use_value_update=True", "first_sampling=True"],
    ["use_adaptive_sampling=True"],
], ids=["threshold", "threshold_value_update", "adaptive"])
def test_trainer_curriculum_is_the_block_it_replaced(args):
    runs = []
    for new in (True, False):
        calls, log = [], []
        trainer = _spied_trainer(args, calls)
        trainer.seed_generators()
        policy = trainer.init_params()
        strategies = trainer.make_strategies()
        env_state, _, test_state, _ = trainer.fresh_fleets(strategies)
        first_sampling = trainer.cfg.first_sampling
        for j in range(3):
            calls.clear()
            if new:
                out = trainer.curriculum(strategies, policy, env_state, test_state, j,
                                         first_sampling)
            else:
                out = _old_block(trainer, strategies, policy, env_state, test_state, j,
                                 first_sampling)
            env_state, test_state, value_only, first_sampling = out
            if strategies.threshold:
                strategies.threshold.post_test()
            # the assist ladder advances after every update, so its ramp ticks
            env_state, _ = strategies.assist.post_update(env_state, 1e9)
            log.append((list(calls), value_only, first_sampling,
                        [x.clone() for x in env_state.cur], [x.clone() for x in test_state.cur]))
        runs.append(log)
    new, old = runs
    assert len(new) == len(old) == 3
    for a, b in zip(new, old):
        assert a[:3] == b[:3]
        for x, y in zip(a[3] + a[4], b[3] + b[4]):
            assert torch.equal(x, y)
    assert any(("train", "update_sample_prob") in u[0] for u in new)
