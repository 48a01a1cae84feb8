"""The check sees a broken timed path: each fault a cell can have
(harness/faults.py) is planted in the port underneath a tiny CPU run,
and `correct` must come out false. (The exchange between chips does not
exist on one chip.)"""

import pytest

from tiny import cell, run

from benchmark.harness import faults

CASES = ([(c, f) for c in ("walker3d_plank.train", "cassie_plank.train") for f in faults.TRAIN]
         + [("walker3d_plank.eval", f) for f in faults.EVAL])


@pytest.mark.parametrize("name, fault", CASES)
def test_fault_is_not_correct(name, fault):
    c = cell(name)
    every = (c.config["episode_steps"] // c.config["num_processes"]
             if c.traffic["kind"] == "train" else c.traffic["steps"])
    with faults.FAULTS[fault](every):
        res = run(name, c=c)
    assert not res["correct"], res["checks"]
