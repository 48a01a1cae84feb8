"""The yardstick's frozen counts against hand counts and against the
port's own functions."""

import pytest

from benchmark.harness import counts
from benchmark.reference import cassie, walker3d

CONFIG = dict(hidden=256, actor_layers=5, critic_layers=4)


@pytest.mark.parametrize("obs, act, critics, macs", [(60, 21, 1, 495_104), (51, 10, 2, 697_600)])
def test_network_macs(obs, act, critics, macs):
    m = counts.network_macs(CONFIG, obs, act)
    # [obs]+[256]*5+[act] and [obs]+[256]*4+[1]
    assert m["actor"] == obs * 256 + 4 * 256 * 256 + 256 * act
    assert m["critic"] == obs * 256 + 3 * 256 * 256 + 256
    assert m["actor"] + critics * m["critic"] == macs


def test_control_step_counts_fixed_and_as_the_port_counts():
    from steppingstone_tpu_torch.physics import step_kernel
    from steppingstone_tpu_torch.physics.robots import cassie as port_cassie
    from steppingstone_tpu_torch.physics.robots import walker3d as port_walker3d
    w, c = walker3d.walker3d(), cassie.cassie()
    assert counts.control_step_flops(w, 20, 4) == 105_396
    assert counts.control_step_flops(c, 20, 4, pd=True, support_hy=1.5) == 65_940
    assert counts.control_step_bytes(w, 20) == 1_124
    assert counts.control_step_bytes(c, 20, pd=True) == 1_016
    assert step_kernel.control_step_flops(port_walker3d.walker3d(), 20, 4) == 105_396
    assert step_kernel.control_step_flops(port_cassie.cassie(), 20, 4, pd=True,
                                          support_hy=1.5) == 65_940
    # Walker3D on planks (K2), the walker3d_plank cells
    assert counts.control_step_flops(w, 20, 4, support_hy=1.5) == 112_736
    assert step_kernel.control_step_flops(port_walker3d.walker3d(), 20, 4,
                                          support_hy=1.5) == 112_736


def test_train_flops_per_frame():
    cfg = dict(CONFIG, num_ensembles=1, episode_steps=409_600, num_processes=4096,
               mini_batch_size=4096, use_mirror=True, ppo_epoch=10)
    fwd, first = 495_104, 2 * 60 * 256
    update = (3 * fwd - first) * 2 * 10
    rollout = fwd + 212_224 / 100
    assert counts.train_flops_per_frame(cfg, 60, 21, 105_396) == pytest.approx(
        2 * (rollout + update) + 105_396)
