"""The train_ranks kind (kinds/train_ranks.py) over 2 gloo ranks at a tiny
size on the CPU, against the reference: every answer right and the
numbers at the rounding that sharded sums reorder; the fault of
harness/ranks.py planted in the ranks makes `correct` false; a traced run
reads the per-layer metrics it can without a device. The four-card cell
is withheld from BENCHMARK.json (benchmark/withheld/): it runs here from
BENCHMARK.json with its entries added. And the new cells' files, found by
name. On two cards or more: the control (the reference in TF32 in the
program's place on every rank) comes out not correct."""

import functools
import time

import pytest
import torch

from benchmark import run as bench
from benchmark.harness import ranks, record
from benchmark.harness.cell import driver
from benchmark.harness.manifest import BENCH, Cell, load_json, manifest

NAME = "walker3d_plank.train.4gpu"
NEW = ("walker3d_thr150.threshold", NAME)


def with_withheld() -> dict:
    """BENCHMARK.json with the withheld four-card cell's entries added."""
    spec, add = manifest(), load_json(BENCH / "withheld" / f"{NAME}.json")
    spec["workloads"].append(add["workload"])
    spec["per_layer"].extend(add["per_layer"])
    for m in spec["end_to_end"]:
        if m["name"] in add["end_to_end"]:
            m["workloads"].append(NAME)
    return spec


def tiny() -> Cell:
    c = Cell(NAME, with_withheld())
    c.config.update(num_processes=8, episode_steps=32, mini_batch_size=8, ppo_epoch=2)
    c.traffic.update(ranks=2, check_iterations=2, check_block_steps=2, check_update_steps=3, timeout_s=600)
    return c


def run(c=None, trace=False, device="cpu", make_system=None):
    torch.set_num_threads(2)
    return bench.run(c or tiny(), 2 ** 31 + 17, 0.0, trace, device, time.perf_counter(),
                     make_system)


def test_ranks_cell_is_correct_at_a_tiny_size():
    res = run()
    assert res["correct"], res["checks"]
    assert res["checks"]["answers_wrong"]["value"] == 0.0
    for k, c in res["checks"].items():
        assert c["value"] <= 1e-6, (k, c)
    assert set(res["metrics"]) == {"train_env_steps_per_s", "setup_s"}
    assert res["detail"]["ranks"] == 2 and res["attempted"] >= 1


def test_traced_run_reads_the_per_layer_metrics_it_can():
    res = run(trace=True)
    assert set(res["metrics"]) == {"allreduce_ms.train.4gpu", "ppo_step_ms.train.4gpu",
                                   "rollout_s.train.4gpu"}
    assert res["metrics"]["allreduce_ms.train.4gpu"]["value"] > 0


@pytest.mark.parametrize("fault", ranks.FAULTS)
def test_fault_is_not_correct(fault):
    res = run(make_system=functools.partial(ranks.planted, fault))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", NEW)
def test_new_cells_files_are_found_by_name(name):
    c = Cell(name, with_withheld())
    assert callable(driver(c.traffic["kind"]))
    assert c.config["num_processes"] == 1024 and set(c.limits["limits"])
    assert [m["name"] for m in c.end_to_end] == ["train_env_steps_per_s", "setup_s"]
    names = {m["name"] for m in c.per_layer}
    assert names and all(n.split(".", 1)[1] in name for n in names)
    for n in names:
        assert (BENCH / "metrics" / f"{n}.py").exists()
        # a run of another kind leaves every new metric out
        assert c.reader(n)(record.Record("train")) is None


@pytest.mark.card
def test_tf32_control_is_not_correct(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    res = run(device="cuda", make_system=ranks.RefTrainRanks)
    assert not res["correct"], res["checks"]
