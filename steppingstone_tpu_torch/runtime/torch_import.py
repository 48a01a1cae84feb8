"""Import of the reference's pickled PyTorch policies (port of
steppingstone_tpu/runtime/torch_import.py).

The reference ships whole pickled `Policy` modules (`playground/models/*.pt`,
saved by `torch.save(actor_critic, ...)`). Their classes live in the
reference repo, so they are unpickled with stub classes (an empty
`nn.Module` subclass made on the fly for every class under `common.`,
`playground.`, `algorithms.` or `mocca_envs`; no reference code is imported
or copied), and the state dict is mapped onto the port's `ActorCritic`:

    actor.fc1..fc5,out      -> actor.layers.0..5
    c{i}.0,2,4,6,8          -> critics.{i}.layers.0..4
    critic.* (legacy attr)  -> critics.0 (reference fallback
                               `controller.py:127-128`)
    dist.logstd._bias (A,1) -> logstd (A,)

Both sides hold torch weights (out, in): nothing is transposed. These
pickles hold classes, so they are read with `weights_only=False`, which,
as for any pickle, may run code the file names: read only policies you
trust. The port's own checkpoints never are (runtime/checkpoint.py).
"""

from __future__ import annotations

import os
import pickle

import torch

from steppingstone_tpu_torch.device import resolve_device

# where the reference's trained policies are looked for by default: its
# `playground/models`, checked out as `reference/` in the working directory
REFERENCE_MODELS = os.path.join("reference", "playground", "models")

_ACTOR = ("fc1", "fc2", "fc3", "fc4", "fc5", "out")
_CRITIC = (0, 2, 4, 6, 8)  # the Linear layers of a reference critic Sequential


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith(("common.", "playground.", "algorithms.", "mocca_envs")):
            # an empty nn.Module subclass; unpickling restores its __dict__
            # (_parameters, _modules), so state_dict() works without the
            # original source
            return type(name, (torch.nn.Module,), {})
        return super().find_class(module, name)


class _PickleShim:
    """The pickle-module interface torch.load takes, with the stub
    Unpickler."""

    __name__ = "pickle"
    Unpickler = _StubUnpickler
    load = staticmethod(pickle.load)
    loads = staticmethod(pickle.loads)
    __version__ = pickle.format_version


def load_torch_module_state(path: str) -> dict:
    """The state dict of a whole pickled reference module, on the host.
    Raises ValueError, naming the path, for a file that holds no module."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False,
                         pickle_module=_PickleShim())
    except (pickle.UnpicklingError, EOFError, KeyError, RuntimeError) as e:
        raise ValueError(f"{path} is not a pickled torch module: {e}") from e
    if not isinstance(obj, torch.nn.Module):
        raise ValueError(f"{path} holds a {type(obj).__name__}, not a pickled torch module")
    return {k: v.detach() for k, v in obj.state_dict().items()}


def _critic_number(name: str) -> int | None:
    return int(name[1:]) if name[:1] == "c" and name[1:].isdigit() else None


def count_critics(sd: dict) -> int:
    """Critics in a reference state dict: its `c{i}` modules, else 1 for
    the legacy single `critic`."""
    names = {k.split(".")[0] for k in sd}
    n = sum(1 for name in names if _critic_number(name) is not None)
    return 1 if n == 0 and "critic" in names else n


def reference_to_state_dict(sd: dict, action_dim: int) -> dict:
    """A reference Policy state dict as a state dict of `ActorCritic`.
    Critic `c{i}` goes to `critics.{i}` by the number in its name (sorting
    the names as strings would put c10 before c2)."""
    out = {}
    for k, layer in enumerate(_ACTOR):
        for p in ("weight", "bias"):
            out[f"actor.layers.{k}.{p}"] = sd[f"actor.{layer}.{p}"]
    numbers = sorted({n for n in (_critic_number(k.split(".")[0]) for k in sd) if n is not None})
    if numbers:
        if numbers != list(range(len(numbers))):
            raise ValueError(f"reference critics c{numbers} are not numbered 0..{len(numbers) - 1}")
        prefixes = [(f"c{i}", i) for i in numbers]
    elif any(k.startswith("critic.") for k in sd):
        prefixes = [("critic", 0)]
    else:
        prefixes = []
    for prefix, i in prefixes:
        for k, sid in enumerate(_CRITIC):
            for p in ("weight", "bias"):
                out[f"critics.{i}.layers.{k}.{p}"] = sd[f"{prefix}.{sid}.{p}"]
    logstd = sd["dist.logstd._bias"].reshape(-1)
    if logstd.shape != (action_dim,):
        raise ValueError(f"reference logstd has shape {tuple(logstd.shape)}, the env's action "
                         f"space is ({action_dim},)")
    out["logstd"] = logstd
    return {k: v.to(torch.float32) for k, v in out.items()}


def load_reference_checkpoint(path: str, action_dim: int, device=None) -> tuple[dict, int]:
    """A reference .pt as (state dict of `ActorCritic` on `device`, None
    meaning the card; number of critics)."""
    dev = resolve_device(device)
    sd = load_torch_module_state(path)
    missing = [k for k in ("actor.fc1.weight", "dist.logstd._bias") if k not in sd]
    if missing:
        raise ValueError(f"{path} is not a reference policy: no {missing}")
    state = reference_to_state_dict(sd, action_dim)
    return {k: v.to(dev) for k, v in state.items()}, count_critics(sd)
