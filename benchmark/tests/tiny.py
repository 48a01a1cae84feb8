"""Tiny sizes of the cells for the CPU tests."""

import time

import torch

from benchmark import run as bench
from benchmark.harness.manifest import Cell


def cell(name: str) -> Cell:
    c = Cell(name)
    if c.traffic["kind"] == "train":
        c.config.update(num_processes=8, episode_steps=32, mini_batch_size=8, ppo_epoch=2)
        c.traffic.update(check_iterations=2, check_block_steps=2)
    else:
        c.traffic.update(envs=8, steps=6, warmup_steps=2, trace_steps=3, check_rounds=2)
    return c


def run(name: str, seed: int = 2 ** 31 + 17, seconds: float = 0.0, trace: bool = False,
        device="cpu", make_system=None, c: Cell | None = None) -> dict:
    torch.set_num_threads(2)
    return bench.run(c or cell(name), seed, seconds, trace, device, time.perf_counter(),
                     make_system)
