"""The threshold kind (kinds/threshold.py) driven through the port at a
tiny size on the CPU, where the port runs its plain control step, against
the reference: every answer right and the numbers at rounding; each fault
of harness/grid_faults.py planted in the port makes `correct` false; a
traced run reads the per-layer metrics it can without a device. On the
card: the control (the reference in TF32 in the program's place) comes
out not correct."""

import functools
import time

import pytest
import torch

from benchmark import run as bench
from benchmark.harness import curriculum, grid_faults
from benchmark.harness.manifest import Cell

NAME = "walker3d_thr150.threshold"
GRID_ENVS, GRID_STEPS = 4, 16


@pytest.fixture(autouse=True)
def small_grid(monkeypatch):
    """The trainer's value grid at the tiny configuration's size."""
    from steppingstone_tpu_torch.runtime import curriculum as curr
    monkeypatch.setattr(curr, "make_value_grid_fn", functools.partial(
        curr.make_value_grid_fn, max_steps=GRID_STEPS, n_envs=GRID_ENVS))


def tiny() -> Cell:
    c = Cell(NAME)
    c.config.update(num_processes=8, episode_steps=32, mini_batch_size=8, ppo_epoch=2,
                    value_grid_envs=GRID_ENVS, value_grid_steps=GRID_STEPS)
    c.traffic.update(check_iterations=2, check_block_steps=2, grid_block_steps=4)
    return c


def run(c=None, seed=2 ** 31 + 17, trace=False, device="cpu", make_system=None):
    torch.set_num_threads(2)
    return bench.run(c or tiny(), seed, 0.0, trace, device, time.perf_counter(), make_system)


def test_threshold_cell_is_correct_at_a_tiny_size():
    res = run()
    assert res["correct"], res["checks"]
    assert res["checks"]["answers_wrong"]["value"] == 0.0
    assert res["checks"]["event_gap"]["value"] == 0.0
    for k, c in res["checks"].items():
        assert c["value"] <= 1e-6, (k, c)
    assert set(res["metrics"]) == {"train_env_steps_per_s", "setup_s"}
    cur = res["detail"]["curriculum"]
    assert cur["events"] and cur["events"][0] > 0 and cur["wrong"] == 0


def test_traced_run_reads_the_per_layer_metrics_it_can():
    res = run(trace=True)
    # no device on the CPU: the host clock's, the spans' and the counters' readings
    assert set(res["metrics"]) == {"curriculum_s.threshold", "grid_step_host_ms.threshold",
                                   "syncs_per_grid_step.threshold", "mfu.threshold"}
    assert res["metrics"]["syncs_per_grid_step.threshold"]["value"] == 0.0


@pytest.mark.parametrize("fault", list(grid_faults.FAULTS))
def test_fault_is_not_correct(fault):
    with grid_faults.FAULTS[fault]():
        res = run()
    assert not res["correct"], res["checks"]


def test_grid_flops_count_every_candidate():
    cfg = Cell(NAME).config
    m = 60 * 256 + 3 * 256 * 256 + 256  # a critic's multiply-adds a row
    a = 60 * 256 + 4 * 256 * 256 + 256 * 21
    got = curriculum.grid_flops(cfg, 60, 21, 112_736)
    assert got == 160 * 16 * (2 * a + 112_736 + 2 * m * 121)


@pytest.mark.card
def test_tf32_control_is_not_correct(card):
    c = tiny()
    res = run(c, device="cuda", make_system=curriculum.RefThreshold)
    assert not res["correct"], res["checks"]
