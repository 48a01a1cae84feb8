"""The control on the card: the plain reference in the program's place,
computed in TF32 (the precision below the float32 the configurations
state), must come out not correct. At a small size that the test run
holds; benchmark/control.py reads it at the cells' own sizes."""

import pytest

from tiny import cell, run

from benchmark.control import factory


@pytest.mark.card
@pytest.mark.parametrize("name", ["walker3d_plank.train", "cassie_plank.train",
                                  "walker3d_plank.eval"])
def test_tf32_control_is_not_correct(card, name):
    c = cell(name)
    if c.traffic["kind"] == "train":
        c.config.update(num_processes=256, episode_steps=256 * 16, mini_batch_size=256, ppo_epoch=4)
        seconds = -1.0
    else:
        c.traffic.update(envs=64, steps=20)
        seconds = 0.0
    res = run(name, seconds=seconds, device="cuda", make_system=factory(c, "tf32"), c=c)
    assert not res["correct"], res["checks"]
