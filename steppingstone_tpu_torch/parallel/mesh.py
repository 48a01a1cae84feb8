"""The env-batch data-parallel layout over torch.distributed ranks (port of
steppingstone_tpu/parallel/mesh.py).

The JAX package lays a 1-D `env` mesh over its devices: the stacked env
state, observations and episode stats shard their leading axis, params
and optimizer state are replicated, and XLA inserts the gradient
all-reduce. The port runs one process per GPU (`torchrun`'s contract) and
makes the same computation explicit:

- `Mesh` describes this process's part: rank `rank` of `world`, holding
  the `env_slice` of every sharded fleet;
- `shard_env_tree` takes the local slice of a full-fleet tree,
  `replicate_tree` broadcasts a tree from rank 0, `gather_env_tree`
  concatenates every rank's slice (the counterpart of the JAX package's
  `process_allgather` before a host read);
- `all_reduce_sum` and `global_mean_std` are the reductions the learner
  needs.

Randomness is drawn at the global batch from a generator seeded alike on
every rank, and each rank keeps its rows (`Mesh.local`), so a sharded run
draws what the single-process run draws. DDP is not used: its gradient
averaging does not reproduce a global minibatch whose rows fall unevenly
on the ranks (agents/ppo.py divides local sums by the global count).

Model-parallel axes are absent, as in the JAX package: the networks are
256-wide MLPs.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time

import torch
import torch.distributed as dist

ENV_AXIS = "env"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the `env` axis as one process sees it: rank `rank`
    of `world`. `distributed` says whether collectives go through the
    default torch.distributed process group (also at world 1, which holds
    the NCCL path against the plain one); without it every collective is
    the identity."""

    rank: int = 0
    world: int = 1
    distributed: bool = False

    def env_slice(self, n_global: int) -> slice:
        """This rank's rows of a fleet of `n_global` envs."""
        if n_global % self.world:
            raise ValueError(f"{n_global} envs do not divide over {self.world} ranks")
        n = n_global // self.world
        return slice(self.rank * n, (self.rank + 1) * n)

    def local(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of `x`, whose axis `dim` spans the whole fleet."""
        if self.world == 1:
            return x
        s = self.env_slice(x.shape[dim])
        return x.narrow(dim, s.start, s.stop - s.start)


SINGLE = Mesh()


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The default process group's size, 1 when there is none."""
    return dist.get_world_size() if _initialized() else 1


def make_mesh(n_devices: int = 0) -> Mesh:
    """The mesh over the default process group's ranks (0 = all of them);
    without a process group, the single process. Raises ValueError when
    `n_devices` names another number of ranks."""
    world = world_size()
    if n_devices not in (0, world):
        raise ValueError(f"mesh_devices={n_devices} contradicts the {world} rank(s) that run: "
                         f"set mesh_devices=0 or {world}, or launch {n_devices} ranks "
                         "(torchrun --nproc_per_node)")
    if not _initialized():
        return SINGLE
    return Mesh(rank=dist.get_rank(), world=world, distributed=True)


def rank_device(device=None):
    """The device this process runs on: `device` when given, else with a
    process group cuda:LOCAL_RANK, else None (the entry points' default,
    the card)."""
    if device is not None or not _initialized():
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def maybe_initialize_distributed(backend: str | None = None, device=None) -> bool:
    """Join the process group that `torchrun`'s variables describe (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); a no-op returning
    False when RANK or WORLD_SIZE is absent, so single-process runs are
    unchanged. Rank r runs on cuda:LOCAL_RANK unless `device` names
    another device. The backend is `nccl` on CUDA and `gloo` on the CPU
    unless `backend` names another; a missing NCCL raises, nothing falls
    back."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if _initialized():
        return True
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = torch.device("cuda", local) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("torchrun's variables are set but no CUDA device is available; "
                               "pass device='cpu' to run the ranks on the CPU")
        torch.cuda.set_device(dev if dev.index is not None else local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("the nccl backend is not available in this PyTorch build")
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


# ----------------------------------------------------------------------
# instrumentation
# ----------------------------------------------------------------------

class CollectiveClock:
    """Time, calls and bytes of this process's collectives, by kind. Off by
    default; when on, each collective is timed on the host clock between
    two synchronizations of its tensor's device, so the time is the
    collective's own and not the work queued before it."""

    def __init__(self):
        self.enabled = False
        self.reset()

    def reset(self) -> None:
        self.seconds = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)
        self.bytes = collections.defaultdict(int)

    @contextlib.contextmanager
    def time(self, kind: str, x: torch.Tensor):
        if not self.enabled:
            yield
            return
        sync = torch.cuda.synchronize if x.is_cuda else (lambda *_: None)
        sync(x.device)
        t0 = time.perf_counter()
        yield
        sync(x.device)
        self.seconds[kind] += time.perf_counter() - t0
        self.calls[kind] += 1
        self.bytes[kind] += x.numel() * x.element_size()


CLOCK = CollectiveClock()


# ----------------------------------------------------------------------
# trees and collectives
# ----------------------------------------------------------------------

def _map(fn, tree):
    """`fn` on every tensor of a tree of NamedTuples, dicts, lists and
    tuples; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def all_reduce_sum(mesh: Mesh, x: torch.Tensor, kind: str = "all_reduce") -> torch.Tensor:
    """`x` summed over the ranks, in place (returned)."""
    if mesh.distributed:
        with CLOCK.time(kind, x):
            dist.all_reduce(x)
    return x


def global_mean_std(mesh: Mesh, x: torch.Tensor):
    """(mean, population std) of every element of every rank's `x`, each a
    0-dim tensor: two passes of all-reduces (the sum, then the sum of
    squared deviations from the global mean)."""
    count = x.numel() * mesh.world
    mean = all_reduce_sum(mesh, x.sum().reshape(1)) / count
    var = all_reduce_sum(mesh, torch.square(x - mean).sum().reshape(1)) / count
    return mean[0], torch.sqrt(var)[0]


def shard_env_tree(mesh: Mesh, tree, dim: int = 0):
    """The local slice of a full-fleet tree: each tensor's axis `dim`
    (the env axis) cut to this rank's rows."""
    if mesh.world == 1:
        return tree
    return _map(lambda x: mesh.local(x, dim).clone(), tree)


def replicate_tree(mesh: Mesh, tree):
    """Every tensor of `tree` overwritten in place with rank 0's copy
    (returned); parameters take it through `policy.state_dict()`."""
    if mesh.distributed:
        def bcast(x):
            with CLOCK.time("broadcast", x):
                dist.broadcast(x, src=0)
            return x

        _map(bcast, tree)
    return tree


def _all_gather(x: torch.Tensor, dim: int, world: int) -> torch.Tensor:
    dtype = x.dtype
    y = x.to(torch.uint8) if dtype == torch.bool else x
    # gloo gathers host tensors only: stage a device tensor through the host
    staged = dist.get_backend() == "gloo" and y.device.type != "cpu"
    src = (y.cpu() if staged else y).contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src)
    out = torch.cat(parts, dim=dim)
    out = out.to(x.device) if staged else out
    return out.to(dtype) if dtype == torch.bool else out


def gather_env_tree(mesh: Mesh, tree, dim: int = 0):
    """Every rank's slice concatenated along `dim` (the env axis): the
    full-fleet tree, on every rank (a collective: call it from every
    rank)."""
    if not mesh.distributed:
        return tree

    def gather(x):
        with CLOCK.time("all_gather", x):
            return _all_gather(x, dim, mesh.world)

    return _map(gather, tree)


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's `obj` (any picklable value) on every rank."""
    if not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (before one reads what rank 0 wrote)."""
    if mesh.distributed:
        dist.barrier()
