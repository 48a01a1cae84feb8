"""NamedTuple trees (env states, step outputs, draws) moved between the
port's types and the reference's, between devices, and stacked over
steps. The two families have the same classes with the same fields, so
a tree is rebuilt by class name."""

from __future__ import annotations

import torch

NAMES = ("EnvState", "PhysicsState", "CurriculumState", "StepOut", "StoneDraws", "ResetDraws",
         "EnvStepDraws")


def reference_types() -> dict:
    from benchmark.reference import engine, stepper, terrain
    mods = (stepper, engine, terrain)
    return {n: next(getattr(m, n) for m in mods if hasattr(m, n)) for n in NAMES}


def port_types() -> dict:
    from steppingstone_tpu_torch.envs import stepper, terrain
    from steppingstone_tpu_torch.physics import engine
    mods = (stepper, engine, terrain)
    return {n: next(getattr(m, n) for m in mods if hasattr(m, n)) for n in NAMES}


def convert(x, types: dict | None = None, leaf=None):
    """`x` with every NamedTuple rebuilt from `types` (by class name; None
    keeps each class) and every tensor passed through `leaf`."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        cls = type(x) if types is None else types[type(x).__name__]
        return cls(*(convert(v, types, leaf) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(convert(v, types, leaf) for v in x)
    if isinstance(x, torch.Tensor) and leaf is not None:
        return leaf(x)
    return x


def to(x, device, types: dict | None = None):
    return convert(x, types, lambda t: t.detach().to(device))


def leaves(x) -> list:
    """The tensors of a tree, in field order."""
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in leaves(v)]
    return [x] if isinstance(x, torch.Tensor) else []


def rebuild(template, tensors):
    """`template` with its tensors replaced, in order, by `tensors`."""
    it = iter(tensors)
    return convert(template, None, lambda _: next(it))


def cat(trees: list):
    """Trees of (B, ...) tensors joined along the env axis."""
    cols = zip(*(leaves(t) for t in trees))
    return rebuild(trees[0], [torch.cat(c, dim=0) for c in cols])


def index(tree, t: int):
    """Step `t` of a tree of (T, ...) tensors."""
    return rebuild(tree, [x[t] for x in leaves(tree)])
