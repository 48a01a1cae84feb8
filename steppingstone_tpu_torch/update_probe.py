"""The PPO update's cost alone (counterpart of scripts/update_probe.py).

    python3 -m steppingstone_tpu_torch.update_probe

Times `ppo_update` on synthetic data of B = 409,600 rows (bench.py's 4096
envs x 100 steps) over scripts/update_probe.py's grid: minibatches of
10778, 2048, 4096, 8192 and 12800 rows, each with mirror augmentation on
and off, 10 epochs each. The batch comes from a seeded generator on the
device; every grid point starts from the same freshly initialised
Walker3D actor-critic (one critic) and a fresh Adam state. A warm-up of
WARMUP_STEPS minibatch steps of the point's size runs before its timed
update, which ends on `torch.cuda.synchronize`. Prints one JSON line per
grid point: its seconds and frames/s (B over the seconds, as the JAX
script prints), and its seconds per minibatch step, the unit the update's
cost scales with.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import time

import torch

from steppingstone_tpu_torch.agents.mirror import MirrorSpec
from steppingstone_tpu_torch.agents.networks import ActorCritic
from steppingstone_tpu_torch.agents.ppo import PPOConfig, init_optimizer, ppo_update
from steppingstone_tpu_torch.device import resolve_device
from steppingstone_tpu_torch.envs import make_env

B = 409_600  # 4096 envs x 100 steps
OBS, ACT = 60, 21
GRID = (10778, 2048, 4096, 8192, 12800)
MIRRORS = (True, False)
WARMUP_STEPS = 3
SEED = 0
LR = 3e-4


def synthetic_batch(rows: int, device) -> dict:
    """A PPO batch of `rows` rows drawn from a generator seeded with SEED on
    `device` (the JAX script's fields and scales): obs, then actions, then
    advantages."""
    g = torch.Generator(device=device).manual_seed(SEED)
    randn = lambda *shape: torch.randn(shape, generator=g, device=device)
    return dict(obs=randn(rows, OBS), actions=randn(rows, ACT) * 0.1,
                log_probs=torch.zeros((rows, 1), device=device),
                values=torch.zeros((rows, 1), device=device),
                returns=torch.ones((rows, 1), device=device), adv=randn(rows, 1))


def run(rows: int = B, grid=GRID, mirrors=MIRRORS, device=None) -> list:
    """Each (minibatch rows, mirror) point of `grid` x `mirrors` on `rows`
    synthetic rows on `device` (None means the card); prints a JSON line a
    point and returns them as dicts."""
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    mirror = MirrorSpec.from_env(make_env("Walker3DStepperEnv-v0", device=dev))
    batch = synthetic_batch(rows, dev)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
    results = []
    for mini, use_mirror in itertools.product(grid, mirrors):
        nmb = rows // mini
        cfg = PPOConfig(num_mini_batch=nmb, mirror=mirror if use_mirror else None)
        policy = ActorCritic(OBS, ACT, num_ensembles=1, device=dev,
                             generator=torch.Generator().manual_seed(SEED))
        opt_state = init_optimizer(policy)
        generator = torch.Generator(device=dev).manual_seed(SEED)
        # the warm-up: the first WARMUP_STEPS minibatches of one epoch
        warm = min(WARMUP_STEPS, nmb)
        ppo_update(policy, opt_state, dataclasses.replace(cfg, ppo_epoch=1, num_mini_batch=warm),
                   {k: v[:warm * (rows // nmb)] for k, v in batch.items()}, LR,
                   generator=generator)
        sync()
        t0 = time.perf_counter()
        opt_state, metrics = ppo_update(policy, opt_state, cfg, batch, LR, generator=generator)
        sync()
        dt = time.perf_counter() - t0
        if not torch.isfinite(torch.stack(list(metrics))).all():
            raise RuntimeError(f"non-finite losses at mini={mini} mirror={use_mirror}: {metrics}")
        steps = cfg.ppo_epoch * nmb
        got = dict(mini=mini, num_mini_batch=nmb, mirror=use_mirror, rows=rows, seconds=dt,
                   frames_per_s=rows / dt, minibatch_steps=steps,
                   seconds_per_minibatch_step=dt / steps, device=str(dev), card=card)
        print(json.dumps(got), flush=True)
        results.append(got)
    return results


if __name__ == "__main__":
    run()
