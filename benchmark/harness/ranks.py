"""What the train_ranks kind (kinds/train_ranks.py) runs inside its rank
processes besides the port: the control of its check, and the fault it
plants, each given to the kind as the `make_system` its ranks build (a
class or a partial of a module-level function, so that it pickles into a
fresh process).

- `RefTrainRanks`: the plain reference in the program's place on each
  rank, in TF32: each rank steps its env rows, the advantages are
  normalized over the whole fleet, and every rank runs the reference's
  PPO update over the gathered global batch with the global
  permutations.
- `planted(fault, ...)`: the port with `fault` planted in the process
  ("rank_gradient_dropped": rank 1's share of the flat gradient is left
  out of every minibatch step's sum)."""

from __future__ import annotations

import torch
import torch.distributed as dist

from benchmark.harness import system
from benchmark.reference import drivers as ref_drivers
from benchmark.reference import gae as ref_gae
from benchmark.reference import ppo as ref_ppo

FAULTS = ("rank_gradient_dropped",)


def _gathered(x: torch.Tensor) -> list:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return parts


class RefTrainRanks(system.RefTrain):
    """The reference over the ranks of the default process group, in TF32."""

    @torch.no_grad()
    def rollout(self, noise, env_draws: list) -> dict:
        cfg, rows = self.config, []
        with system.tf32():
            for t, d in enumerate(env_draws):
                out = ref_drivers.act(self.policy, self.obs, noise[t])
                self.state, step = self.env.step(self.state, out.action, draws=d)
                rows.append((self.obs, out, step.reward, step.done, step.timeout))
                self.obs = step.obs
            obs = torch.stack([r[0] for r in rows])
            outs = ref_drivers.PolicyOut(*(torch.stack(x) for x in zip(*(r[1] for r in rows))))
            reward, done, timeout = (torch.stack([r[i] for r in rows]) for i in (2, 3, 4))
            last = self.policy.value(self.obs)
        T, N = reward.shape
        values = torch.cat([outs.value[..., 0], last.T], dim=0)
        ones = torch.ones_like(reward[:1])
        returns, adv = ref_gae.compute_gae(reward, values,
                                           torch.cat([ones, 1.0 - done.to(torch.float32)]),
                                           torch.cat([ones, 1.0 - timeout.to(torch.float32)]),
                                           cfg["gamma"], cfg["gae_lambda"])
        # normalized over the whole fleet: the population mean and std
        everything = torch.cat(_gathered(adv))
        mean = everything.sum() / everything.numel()
        std = torch.sqrt(torch.square(everything - mean).sum() / everything.numel())
        adv = (adv - mean) / (std + 1e-5)
        flat = lambda x: x.reshape(T * N, *x.shape[2:])
        return dict(obs=flat(obs), actions=flat(outs.action), log_probs=flat(outs.log_prob),
                    values=flat(outs.value), returns=flat(returns[..., None]),
                    adv=flat(adv[..., None]), rewards=reward)

    def update(self, batch: dict, perms, lr: float) -> tuple:
        """The reference's update over every rank's rows in the global
        batch's order (T, world x N), flat, env fastest."""
        T = self.config["episode_steps"] // self.config["num_processes"]
        glob = {}
        for k, v in batch.items():
            if k == "rewards":
                continue
            parts = [p.view(T, -1, *p.shape[1:]) for p in _gathered(v)]
            glob[k] = torch.cat(parts, dim=1).reshape(-1, *v.shape[1:])
        with system.tf32():
            self.opt_state, metrics = ref_ppo.ppo_update(self.policy, self.opt_state, self.ppo,
                                                         glob, lr, perms=perms)
        return tuple(metrics)


def planted(fault: str, config: dict, device, flat: torch.Tensor):
    """The port's training iteration with `fault` planted for the rest of
    this process."""
    from steppingstone_tpu_torch.agents import ppo
    if fault != "rank_gradient_dropped":
        raise ValueError(f"unknown fault {fault!r}")
    original = ppo.all_reduce_sum

    def all_reduce_sum(mesh, x, kind="all_reduce"):
        if kind == "gradient" and mesh.rank == 1:
            x = torch.cat([torch.zeros_like(x[:-4]), x[-4:]])  # the loss terms kept
        return original(mesh, x, kind)
    ppo.all_reduce_sum = all_reduce_sum
    return system.PortTrain(config, device, flat)
