"""The random draws of the cells, made by the benchmark from the seed in
a few large calls and handed to the program and to the reference alike:
the reset draws, each control step's `EnvStepDraws`, the action noise and
the minibatch permutations. They have the reference's types
(`harness.tree.convert` makes the port's)."""

from __future__ import annotations

import torch

from benchmark.harness import seeds
from benchmark.harness.tree import index
from benchmark.reference import stepper as ref_stepper
from benchmark.reference import terrain as ref_terrain


def _stones(g, cur, lead: tuple, k: int) -> ref_terrain.StoneDraws:
    """StoneDraws with leading axes `lead` + (B, k): the grid cell is one
    uniform a placement turned into a cell by the env's cumulative
    `sample_prob`, as the steppers draw it."""
    B, dev = cur.level.shape[0], cur.level.device
    shape = lead + (B, k)
    rand = lambda *extra: torch.rand(shape + extra, generator=g, device=dev)
    cdf = torch.cumsum(cur.sample_prob.reshape(B, -1), dim=1)
    u = rand()
    flat = u.movedim(-2, 0).reshape(B, -1) * cdf[:, -1:]
    cat = torch.searchsorted(cdf, flat.contiguous(), right=True)
    cat = cat.reshape((B,) + lead + (k,)).movedim(0, -2)
    return ref_terrain.StoneDraws(u=2.0 * rand(4) - 1.0, r_u=rand(),
                                  cat=torch.clamp(cat, max=ref_terrain.GRID ** 2 - 1),
                                  r_g=rand())


def _reset(g, cur, lead: tuple, n_stones: int, njoints: int) -> ref_stepper.ResetDraws:
    B, dev = cur.level.shape[0], cur.level.device
    return ref_stepper.ResetDraws(
        stones=_stones(g, cur, lead, n_stones - 2),
        noise=torch.randn(lead + (B, 2 * njoints + 3), generator=g, device=dev),
        mirror=torch.rand(lead + (B,), generator=g, device=dev) < 0.5)


def reset_draws(seed: int, cur, n_stones: int, njoints: int, *names) -> ref_stepper.ResetDraws:
    """One fleet reset's draws, from the stream `names` of `seed`."""
    g = seeds.generator(cur.level.device, seed, "reset", *names)
    return _reset(g, cur, (), n_stones, njoints)


def step_draws(seed: int, cur, steps: int, n_stones: int, njoints: int, *names) -> list:
    """`steps` control steps' EnvStepDraws, from the stream `names`."""
    g = seeds.generator(cur.level.device, seed, "steps", *names)
    bulk = ref_stepper.EnvStepDraws(resample=_stones(g, cur, (steps,), 1),
                                    reset=_reset(g, cur, (steps,), n_stones, njoints))
    return [index(bulk, t) for t in range(steps)]


def action_noise(seed: int, steps: int, n_envs: int, act_dim: int, device, *names):
    """(steps, n_envs, act_dim) standard normals."""
    g = seeds.generator(device, seed, "noise", *names)
    return torch.randn((steps, n_envs, act_dim), generator=g, device=device)


def permutations(seed: int, epochs: int, rows: int, used: int, device, *names):
    """(epochs, used): each epoch's minibatch row order over `rows` rows."""
    g = seeds.generator(device, seed, "perms", *names)
    return torch.argsort(torch.rand((epochs, rows), generator=g, device=device), dim=1)[:, :used]
