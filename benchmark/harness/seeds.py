"""Everything random comes from `--seed`: a stream per purpose, named,
so that the same seed gives the same inputs in every run and on both
sides of a comparison."""

from __future__ import annotations

import hashlib

import torch


def stream(seed: int, *names) -> int:
    """A 63-bit seed for the stream `names` of run seed `seed` (any whole
    number)."""
    key = ":".join(str(x) for x in (seed, *names)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(device, seed: int, *names) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream(seed, *names))
    return g


def layer_shapes(obs_dim: int, act_dim: int, hidden: int, actor_layers: int,
                 critic_layers: int, ensembles: int) -> list:
    """(name, shape) of every parameter of the actor-critic, in the order
    of its `named_parameters()`: logstd, the actor's linear layers, then
    each critic's."""
    shapes = [("logstd", (act_dim,))]

    def mlp(prefix, dims):
        for k, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            shapes.extend([(f"{prefix}.layers.{k}.weight", (b, a)),
                           (f"{prefix}.layers.{k}.bias", (b,))])

    mlp("actor", [obs_dim] + [hidden] * actor_layers + [act_dim])
    for i in range(ensembles):
        mlp(f"critics.{i}", [obs_dim] + [hidden] * critic_layers + [1])
    return shapes


def weights(shapes: list, device, seed: int, logstd: float) -> torch.Tensor:
    """The flat parameter vector, made on `device` from the seed in one
    draw: every weight and bias uniform in +-1/sqrt(fan-in) (torch's
    default for a linear layer), logstd at `logstd`."""
    fan_in = {name.rsplit(".", 1)[0]: shape[1] for name, shape in shapes
              if name.endswith("weight")}
    sizes = [int(torch.Size(shape).numel()) for _, shape in shapes]
    scales = [0.0 if name == "logstd" else fan_in[name.rsplit(".", 1)[0]] ** -0.5
              for name, _ in shapes]
    scale = torch.repeat_interleave(torch.tensor(scales, device=device),
                                    torch.tensor(sizes, device=device))
    unit = torch.rand(sum(sizes), generator=generator(device, seed, "weights"), device=device)
    flat = (2.0 * unit - 1.0) * scale
    flat[:sizes[0]] = logstd
    return flat
