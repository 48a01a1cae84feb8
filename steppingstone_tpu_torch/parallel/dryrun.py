"""The multi-rank dry run (counterpart of `__graft_entry__.py`
`dryrun_multichip`): one full training iteration at real shape, its env
fleet sharded over `n` torch.distributed ranks and its learner replicated,
held against the same iteration in one process.

    python -m steppingstone_tpu_torch.parallel.dryrun N [--device cpu] [--backend gloo]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from steppingstone_tpu_torch.parallel import launch
from steppingstone_tpu_torch.parallel import mesh as pmesh

LOSSES = ("value_loss", "action_loss", "dist_entropy")
STEPS = 2  # control steps of the iteration
# the JAX package's bar between the sharded and the single-device losses
LOSS_RTOL = 1e-3


def one_train_iteration(n_envs: int, mesh_devices: int, device=None) -> dict:
    """One Trainer.train_iteration of Walker3D on discs (kernel K1 on the
    card) at `n_envs` envs x STEPS steps, mirror on, minibatches of half
    the frames, no test fleet; over the default process group's ranks when
    there is one. Returns this rank's metrics, its parameters after the
    update (flat), its K1 launches and its observations."""
    from steppingstone_tpu_torch.agents.ppo import init_optimizer
    from steppingstone_tpu_torch.agents.rollout import EpisodeStats
    from steppingstone_tpu_torch.physics.step_kernel import CONTROL_STEP
    from steppingstone_tpu_torch.runtime.config import TrainConfig
    from steppingstone_tpu_torch.runtime.train import Trainer

    cfg = TrainConfig(env_name="Walker3DStepperEnv-v0", num_processes=n_envs,
                      episode_steps=n_envs * STEPS, mini_batch_size=n_envs * STEPS // 2,
                      num_frames=n_envs * STEPS, num_tests=0, mesh_devices=mesh_devices,
                      use_mirror=True)
    trainer = Trainer(cfg, device=device)
    policy = trainer.init_params()
    opt_state = init_optimizer(policy)
    env_state, obs = trainer.venv.reset()
    stats = EpisodeStats.init(trainer.venv.num_envs, trainer.device)
    trainer.replicate_learner(policy, opt_state)
    CONTROL_STEP.reset_counts()
    policy, opt_state, env_state, obs, stats, metrics, _ = trainer.train_iteration(
        policy, opt_state, env_state, obs, stats, 3e-4)
    launches = dict(CONTROL_STEP.launches)
    return dict(rank=trainer.mesh.rank, world=trainer.mesh.world,
                metrics={f: float(getattr(metrics, f)) for f in metrics._fields},
                params=torch.cat([p.detach().reshape(-1) for p in policy.parameters()]),
                obs=obs, launches=launches)


def rank_iteration(n_envs: int, device=None, backend=None) -> dict:
    """one_train_iteration on a rank that joins the process group of
    torchrun's variables (`backend`, by default nccl on the card) over all
    its ranks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    pmesh.maybe_initialize_distributed(backend, device)
    return dict(one_train_iteration(n_envs, pmesh.world_size(), device),
                backend=dist.get_backend())


def dryrun_multichip(n_devices: int, device=None, backend=None, n_envs: int = 1024,
                     local_rank: int | None = None) -> dict:
    """One training iteration at `n_envs` (at least 2 per rank) x STEPS
    sharded over `n_devices` ranks started here (`backend` by default nccl
    on the card, gloo on the CPU; `local_rank` 0 puts every rank on the
    first card), against the same iteration in this process: the losses
    within rel 1e-3 (the JAX package's bar), every rank's metrics and
    parameters equal. Returns the ranks' and the single run's results and
    the largest relative difference of the losses."""
    n_envs = max(n_envs, 2 * n_devices)
    ranks = launch.spawn(rank_iteration, n_devices, (n_envs, device, backend),
                         local_rank=local_rank)
    single = launch.host_values(one_train_iteration(n_envs, 1, device))
    ref = single["metrics"]
    rel = {f: abs(ranks[0]["metrics"][f] - ref[f]) / max(1.0, abs(ref[f])) for f in LOSSES}
    for f, r in rel.items():
        if not np.isfinite(ranks[0]["metrics"][f]) or r > LOSS_RTOL:
            raise AssertionError(f"sharded-vs-single mismatch on {f}: "
                                 f"{ranks[0]['metrics'][f]} vs {ref[f]}")
    for r in ranks[1:]:
        if r["metrics"] != ranks[0]["metrics"] or not np.array_equal(r["params"],
                                                                      ranks[0]["params"]):
            raise AssertionError(f"rank {r['rank']} holds another learner than rank 0")
    print(f"dryrun_multichip({n_devices}): ok - value_loss={ranks[0]['metrics']['value_loss']:.4f} "
          f"action_loss={ranks[0]['metrics']['action_loss']:.4f} (parity vs single process "
          f"passed, largest relative difference {max(rel.values()):.3g}; control-step "
          f"launches a rank {[r['launches'] for r in ranks]})", flush=True)
    return dict(ranks=ranks, single=single, rel=rel)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", default=None, help="cpu, or the card by default")
    parser.add_argument("--backend", default=None, help="nccl on the card, gloo on the CPU")
    parser.add_argument("--envs", type=int, default=1024)
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device, args.backend, n_envs=args.envs)


if __name__ == "__main__":
    main()
