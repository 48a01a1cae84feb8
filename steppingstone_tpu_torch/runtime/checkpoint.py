"""Checkpoints: full-resume snapshots under tags (port of
steppingstone_tpu/runtime/checkpoint.py on torch.save / torch.load).

A snapshot is a tree of dicts, lists, NamedTuples, tensors and Python
scalars. `save` copies every tensor to the host first and writes
`<directory>/<tag>.pt` through a temporary file and an atomic rename, on
the caller's thread (a save takes well under a second, against about a
minute per update, so `TrainConfig.checkpoint_async` is recorded but
inert). NamedTuples are stored as dicts, so files load with `weights_only=True`; `restore_like`
rebuilds them from a template snapshot and raises, naming the file and the
field, where the layout differs. Tags the training loop writes: `latest`,
`best`, numbered frame counts, `crash` and `specialist_<k>`.

Only this layout is read. A checkpoint of the JAX package is an orbax
directory under the same tag (`<directory>/<tag>/`); the port does not
decode it, and every reader of a tag (resume, `enjoy.load_params` and so
warm starts, the behavior evaluation) refuses one with a ValueError that
names the converter, `scripts/jax_ckpt_to_port.py`, run where JAX is
installed. A port file `<tag>.pt` beside such a directory is read as
usual. Warm starts and `enjoy` read a snapshot's `"policy"` from any file
of this layout (`CheckpointManager.read`); the reference's pickled
policies go through runtime/torch_import.py instead.
"""

from __future__ import annotations

import os
import tempfile

import torch

from steppingstone_tpu_torch.parallel.mesh import SINGLE, Mesh, barrier, broadcast_object

CONVERTER = "scripts/jax_ckpt_to_port.py"
# files orbax writes into every checkpoint directory
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt")


def is_orbax_checkpoint(path: str) -> bool:
    """Whether `path` is a directory that orbax wrote (a tag of the JAX
    package's CheckpointManager)."""
    return os.path.isdir(path) and any(os.path.exists(os.path.join(path, m))
                                       for m in ORBAX_MARKERS)


def _orbax_error(path: str) -> ValueError:
    return ValueError(
        f"{path} is a checkpoint of the JAX package (orbax), which the port does not "
        f"read; convert it where JAX is installed: python {CONVERTER} "
        f"{os.path.dirname(path) or '.'} --out <port run>/checkpoints")


def refuse_orbax(path: str) -> None:
    """Raise ValueError, naming the converter, where `path` (a tag without
    `.pt`) is a JAX package checkpoint and no port file `<path>.pt` is
    beside it."""
    if not os.path.isfile(f"{path}.pt") and is_orbax_checkpoint(path):
        raise _orbax_error(path)


def to_host(tree):
    """A copy of `tree` with every tensor detached and copied to the host
    and every NamedTuple turned into a dict."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: to_host(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _rebuild(template, saved, where: str):
    """`saved` in the structure of `template`: NamedTuples rebuilt, tensors
    moved to the template's device; raises ValueError naming `where` on a
    missing or extra key, a shape or a dtype that differs."""
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"{where}: expected a tensor, found {type(saved).__name__}")
        if saved.shape != template.shape or saved.dtype != template.dtype:
            raise ValueError(f"{where}: saved {tuple(saved.shape)} {saved.dtype}, expected "
                             f"{tuple(template.shape)} {template.dtype}")
        return saved.to(template.device)
    is_named = isinstance(template, tuple) and hasattr(template, "_fields")
    if is_named or isinstance(template, dict):
        fields = template._asdict() if is_named else template
        if not isinstance(saved, dict) or set(saved) != set(fields):
            got = sorted(saved) if isinstance(saved, dict) else type(saved).__name__
            raise ValueError(f"{where}: keys {got}, expected {sorted(fields)}")
        values = {k: _rebuild(v, saved[k], f"{where}.{k}") for k, v in fields.items()}
        return type(template)(**values) if is_named else values
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(template):
            raise ValueError(f"{where}: expected {len(template)} items")
        return type(template)(_rebuild(t, s, f"{where}[{i}]")
                              for i, (t, s) in enumerate(zip(template, saved)))
    return saved


class CheckpointManager:
    """Snapshots under `directory`. Over the ranks of `mesh` only rank 0
    writes (the training loop hands it the gathered full-fleet snapshot)
    and reads: `exists` and `restore` are collectives that wait at a
    barrier for every rank, so that none reads before rank 0 has written,
    and hand rank 0's answer to all (no rank needs the files)."""

    def __init__(self, directory: str, mesh: Mesh = SINGLE):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)

    def path(self, tag: str) -> str:
        return os.path.join(self.directory, f"{tag}.pt")

    def save(self, tag: str, state) -> None:
        """Save a snapshot under `tag` (e.g. 'latest', 'best', '10000000');
        a no-op on every rank but 0."""
        if self.mesh.rank != 0:
            return
        host = to_host(state)
        fd, tmp = tempfile.mkstemp(suffix=".pt.tmp", dir=self.directory)
        os.close(fd)
        try:
            torch.save(host, tmp)
            os.replace(tmp, self.path(tag))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    @staticmethod
    def read(path: str):
        """The tree saved in the file `path`, on the host (NamedTuples as
        dicts); a file holding anything but tensors and plain containers is
        refused with pickle.UnpicklingError."""
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, tag: str):
        """The saved tree, on the host (NamedTuples as dicts)."""
        barrier(self.mesh)
        return broadcast_object(self.mesh, self.read(self.path(tag))
                                if self.mesh.rank == 0 else None)

    def restore_like(self, tag: str, template):
        """The snapshot under `tag` in the structure of `template`, tensors
        on the template's devices; raises ValueError naming the file where
        the layout differs."""
        return _rebuild(template, self.restore(tag), self.path(tag))

    def _status(self, tag: str) -> str:
        if os.path.isfile(self.path(tag)):
            return "port"
        return "orbax" if is_orbax_checkpoint(os.path.join(self.directory, tag)) else "none"

    def exists(self, tag: str) -> bool:
        """Whether a port snapshot is saved under `tag`; raises ValueError
        naming the converter where only the JAX package's is."""
        barrier(self.mesh)
        status = broadcast_object(self.mesh, self._status(tag) if self.mesh.rank == 0 else None)
        if status == "orbax":
            raise _orbax_error(os.path.join(self.directory, tag))
        return status == "port"

    def tags(self) -> list:
        return sorted(f[:-3] for f in os.listdir(self.directory) if f.endswith(".pt"))
