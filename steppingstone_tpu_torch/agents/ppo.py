"""PPO learner (port of steppingstone_tpu/agents/ppo.py).

Clipped surrogate + (optionally clipped) value loss over the critic
ensemble, `ppo_epoch` x `num_mini_batch` steps over equal-sized minibatches
(batch // num_mini_batch rows, the remainder dropped), optional
mirror-augmented minibatches, the value-only variant, and an approximate-KL
trust guard. The optimizer is the JAX package's optax chain
`clip_by_global_norm(max_grad_norm)` -> `scale_by_adam(eps=eps)` followed by
`params -= lr * update`, written out here over one flat vector of all
parameters so that its arithmetic is optax's: the clip divides by the
global norm itself (torch.nn.utils.clip_grad_norm_ adds 1e-6), and when
the KL guard fires the step size is 0 but the Adam moments still advance.

Sharded over the ranks of a mesh (parallel/mesh.py) the learner is
replicated and the minibatches stay global: every rank draws the same
permutations, takes the rows it holds, divides its sums by the global
counts and all-reduces the flat gradient, so each step is the
single-process step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from steppingstone_tpu_torch.agents import distributions as dist
from steppingstone_tpu_torch.agents.mirror import MirrorSpec, mirror_minibatch
from steppingstone_tpu_torch.agents.networks import (
    ActorCritic, clamped_logstd, params_from_jax, project_logstd)
from steppingstone_tpu_torch.parallel.mesh import SINGLE, Mesh, all_reduce_sum
from steppingstone_tpu_torch.tracing import span

ADAM_B1, ADAM_B2 = 0.9, 0.999


@dataclasses.dataclass(frozen=True, eq=False)
class PPOConfig:
    """PPO hyperparameters (reference `train.py:77-87`)."""

    clip_param: float = 0.2
    ppo_epoch: int = 10
    num_mini_batch: int = 39
    value_loss_coef: float = 1.0
    entropy_coef: float = 0.0
    max_grad_norm: float = 2.0
    eps: float = 1e-5
    use_clipped_value_loss: bool = False
    mirror: Optional[MirrorSpec] = None
    # approximate-KL trust guard: when > 0, a minibatch whose mean approx
    # KL (old_logp - new_logp, unmirrored rows) exceeds the cutoff applies
    # no parameter update
    kl_cutoff: float = 0.0


class PPOMetrics(NamedTuple):
    value_loss: torch.Tensor
    action_loss: torch.Tensor
    dist_entropy: torch.Tensor
    grad_norm: torch.Tensor
    clip_frac: torch.Tensor
    approx_kl: torch.Tensor


class AdamState(NamedTuple):
    """optax ScaleByAdamState over `policy.parameters()` flattened in order."""

    count: torch.Tensor  # () int32 steps taken
    mu: torch.Tensor     # (P,) first moment
    nu: torch.Tensor     # (P,) second moment


def init_optimizer(policy: ActorCritic) -> AdamState:
    n = sum(p.numel() for p in policy.parameters())
    dev = policy.logstd.device
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=torch.zeros(n, device=dev), nu=torch.zeros(n, device=dev))


def adam_state_from_jax(opt_state, policy: ActorCritic) -> AdamState:
    """The port's AdamState from the JAX package's optax state (as numpy):
    the `make_optimizer` chain's state `(EmptyState(), ScaleByAdamState)` or
    the ScaleByAdamState itself, whose mu and nu are flax parameter trees."""
    adam = opt_state
    if not hasattr(adam, "mu"):
        adam = next(x for x in opt_state if hasattr(x, "mu"))
    dev = policy.logstd.device

    def flat(tree):
        sd = params_from_jax(tree)
        return torch.cat([sd[name].reshape(-1) for name, _ in policy.named_parameters()]).to(dev)

    return AdamState(count=torch.as_tensor(np.array(adam.count), dtype=torch.int32, device=dev),
                     mu=flat(adam.mu), nu=flat(adam.nu))


def _losses(policy: ActorCritic, cfg: PPOConfig, mb: dict, m_global: int):
    """The losses of a minibatch of `m_global` rows in all, of which `mb`
    holds this rank's (mirrored with `cfg.mirror`): each mean is this
    rank's sum over the global count, so the ranks' terms add up to the
    global mean."""
    mean = policy.action_mean(mb["obs"])
    logstd = clamped_logstd(policy)
    values = policy.ensemble_values(mb["obs"])                   # (B, E)
    log_probs = dist.log_prob(mean, logstd, mb["actions"])       # (B, 1)
    # the same on every row: the mean over rows is the entropy of logstd
    entropy = dist.entropy(logstd)
    # with mirror augmentation the second half are mirrored rows carrying
    # the original rows' log-probs, so only the first half measures drift
    n_orig = log_probs.shape[0] // 2 if cfg.mirror is not None else log_probs.shape[0]
    rows = 2 * m_global if cfg.mirror is not None else m_global
    approx_kl = torch.sum(mb["log_probs"][:n_orig] - log_probs[:n_orig]) / m_global
    ratio = torch.exp(log_probs - mb["log_probs"])
    surr1 = ratio * mb["adv"]
    surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param) * mb["adv"]
    action_loss = -torch.sum(torch.minimum(surr1, surr2)) / rows
    clip_frac = torch.sum((torch.abs(ratio - 1.0) > cfg.clip_param).to(torch.float32)) / rows
    # value loss over the ensemble against the shared target
    if cfg.use_clipped_value_loss:
        v_clip = mb["values"] + torch.clamp(values - mb["values"], -cfg.clip_param,
                                            cfg.clip_param)
        vl = torch.square(values - mb["returns"])
        vl_c = torch.square(v_clip - mb["returns"])
        value_loss = 0.5 * torch.sum(torch.maximum(vl, vl_c)) / (rows * values.shape[1])
    else:
        value_loss = 0.5 * torch.sum(torch.square(mb["returns"] - values)) / (
            rows * values.shape[1])
    return action_loss, value_loss, entropy, clip_frac, approx_kl


def _minibatch_step(policy: ActorCritic, params: list, opt: AdamState, cfg: PPOConfig,
                    mb: dict, lr: torch.Tensor, value_only: bool, mesh: Mesh, m_global: int):
    """One optimizer step on one minibatch of `m_global` rows, `mb` this
    rank's; updates `policy` in place and returns (new AdamState,
    PPOMetrics of this step). Over several ranks one all-reduce sums the
    flat gradient and the loss terms, so every rank clips, guards and
    steps on the global values and stays identical."""
    with span("ppo.forward"):
        if cfg.mirror is not None:
            mb = mirror_minibatch(cfg.mirror, mb)
        action_loss, value_loss, entropy, clip_frac, approx_kl = _losses(policy, cfg, mb,
                                                                         m_global)
        total = value_loss * cfg.value_loss_coef
        if not value_only:
            total = total + action_loss
            if mesh.rank == 0:
                # the entropy depends on no row: it enters the global loss once
                total = total - entropy * cfg.entropy_coef
    with span("ppo.backward"):
        grads = torch.autograd.grad(total, params, allow_unused=True)
        g = torch.cat([(torch.zeros_like(p) if gr is None else gr).reshape(-1)
                       for p, gr in zip(params, grads)])
    value_loss, action_loss, clip_frac, approx_kl = (
        value_loss.detach(), action_loss.detach(), clip_frac, approx_kl.detach())
    if mesh.distributed:
        terms = torch.stack([value_loss, action_loss, clip_frac, approx_kl])
        summed = all_reduce_sum(mesh, torch.cat([g, terms]), kind="gradient")
        g = summed[:-4]
        value_loss, action_loss, clip_frac, approx_kl = summed[-4:]
    with span("ppo.optimizer"):
        gnorm = torch.sqrt(torch.sum(g * g))
        # optax.clip_by_global_norm
        g = torch.where(gnorm < cfg.max_grad_norm, g, (g / gnorm) * cfg.max_grad_norm)
        # optax.scale_by_adam
        mu = (1 - ADAM_B1) * g + ADAM_B1 * opt.mu
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * opt.nu
        count = opt.count + 1
        c = count.to(torch.float32)
        update = (mu / (1 - ADAM_B1 ** c)) / (torch.sqrt(nu / (1 - ADAM_B2 ** c)) + cfg.eps)
        step_lr = lr
        if cfg.kl_cutoff > 0.0 and not value_only:
            # trust guard: a minibatch that drifted too far applies no update
            step_lr = torch.where(approx_kl > cfg.kl_cutoff, torch.zeros_like(lr), lr)
        with torch.no_grad():
            flat = torch.cat([p.reshape(-1) for p in params]) - step_lr * update
            for p, x in zip(params, flat.split([p.numel() for p in params])):
                p.copy_(x.view_as(p))
        project_logstd(policy)
    metrics = PPOMetrics(value_loss, action_loss, entropy.detach(), gnorm, clip_frac, approx_kl)
    return AdamState(count, mu, nu), metrics


def local_minibatches(mesh: Mesh, rows: torch.Tensor, num_mini_batch: int,
                      num_envs: int) -> tuple:
    """This rank's rows of each of the `num_mini_batch` equal minibatches
    of `rows`, one epoch's global row order over the flat (T, world x
    num_envs) batch (Trainer.rollout's flattening, env fastest): a global
    row (t, n) is held by rank n // num_envs as its local row t x num_envs
    + n mod num_envs. The order within a minibatch is kept; a rank may hold
    none of a minibatch's rows. One host read of the order per epoch."""
    order = rows.cpu().numpy()
    n_glob = num_envs * mesh.world
    t, n = np.divmod(order, n_glob)
    mine = n // num_envs == mesh.rank
    local = torch.as_tensor(t[mine] * num_envs + n[mine] - mesh.rank * num_envs,
                            device=rows.device)
    counts = mine.reshape(num_mini_batch, -1).sum(axis=1)
    return local.split(counts.tolist())


def ppo_update(policy: ActorCritic, opt_state: AdamState, cfg: PPOConfig, batch: dict, lr,
               value_only: bool = False, perms: torch.Tensor | None = None,
               generator: torch.Generator | None = None, mesh: Mesh = SINGLE,
               num_envs: int | None = None):
    """`ppo_epoch` epochs of shuffled minibatch steps over `batch`, a dict of
    (B, .) tensors: obs, actions, log_probs (B, 1), values (B, 1), returns
    (B, 1), adv (B, 1). Over the ranks of `mesh` the batch is this rank's
    rows of a global batch of world x B rows, flat over (T, world x
    `num_envs`), and the minibatches are global. `perms` (ppo_epoch, used)
    holds each epoch's global row order (used = global batch //
    num_mini_batch * num_mini_batch); when None it is drawn from
    `generator`, seeded alike on every rank. Updates `policy` in place and
    returns (AdamState, PPOMetrics averaged over all steps)."""
    B = batch["obs"].shape[0] * mesh.world
    mbs = B // cfg.num_mini_batch
    used = mbs * cfg.num_mini_batch
    dev = batch["obs"].device
    if mesh.world > 1 and num_envs is None:
        raise ValueError("a sharded ppo_update needs num_envs, this rank's envs")
    with span("trainer.update"):
        if perms is None:
            perms = torch.stack([torch.randperm(B, generator=generator, device=dev)[:used]
                                 for _ in range(cfg.ppo_epoch)])
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        params = list(policy.parameters())
        history = []
        for epoch in range(cfg.ppo_epoch):
            if mesh.world == 1:
                minibatches = perms[epoch].view(cfg.num_mini_batch, mbs)
            else:
                minibatches = local_minibatches(mesh, perms[epoch], cfg.num_mini_batch, num_envs)
            for rows in minibatches:
                with span("ppo.minibatch"):
                    mb = {k: v[rows] for k, v in batch.items()}
                    opt_state, m = _minibatch_step(policy, params, opt_state, cfg, mb, lr,
                                                   value_only, mesh, mbs)
                history.append(m)
        return opt_state, PPOMetrics(*(torch.stack(x).mean() for x in zip(*history)))
