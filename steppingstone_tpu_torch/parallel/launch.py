"""Start the ranks of one torch.distributed job on this host from Python:
the processes `torchrun --nproc_per_node=N` would start, each with
torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), for callers that must drive several ranks themselves (the
dry run, the tests, chip_smoke.py).

    results = spawn(fn, world=2, args=(...))

runs fn(*args) in `world` fresh processes (the spawn start method, so the
caller may hold a CUDA context) and returns each rank's result, tensors
turned into numpy arrays. A rank that raises or dies fails the call with
its traceback, and every process it started is ended before it returns.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import torch


def free_port() -> int:
    """A TCP port on localhost that no one listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def host_values(tree):
    """`tree` with every tensor turned into a numpy array (on the host)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(host_values(v) for v in tree))
    if isinstance(tree, dict):
        return {k: host_values(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_values(v) for v in tree)
    return tree


def _rank_main(fn, args, rank: int, world: int, port: int, local_rank: int, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        results.put((rank, True, host_values(fn(*args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (), local_rank: int | None = None,
          timeout: float = 1800.0) -> list:
    """[fn(*args) of rank 0, ..., of rank world - 1]. Rank r gets LOCAL_RANK
    r, or `local_rank` for all (ranks that pose as one-GPU hosts sharing a
    card). `fn` must be importable by name; it joins the process group
    itself (parallel.mesh.maybe_initialize_distributed)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, args, r, world, port,
                                                  r if local_rank is None else local_rank,
                                                  results))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code {dead[0][1]}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks did not finish within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == world else 0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
