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

Every minibatch step reads and writes only buffers that live as long as
the step (`_StepBuffers`): the batch, the update's row order, the lr and
Adam's state are copied in once per update, and each step picks its rows
by a step index on the device and writes its metrics into a history. On a
CUDA device in one process that step is captured once as a CUDA graph
(after a few eager steps on a side stream) and replayed for every later
minibatch step, of this update and the next ones; the graph is kept per
policy and captured anew when the batch's shapes, the config, value_only
or the parameters' storage change. On the CPU and over several ranks the
same step runs eagerly. The arithmetic is the same on every path.

With the mirror, the batch's mirror image is made once an update, beside
the batch (`_StepBuffers.load`), and each step gathers its rows and the
same rows of the image: the tensors the losses see are those of mirroring
each minibatch (a mirror is a permutation and signs, exact). The optimizer
is one launch of the hand-written `adam_step` kernel on a card
(physics/step_kernel.py `ADAM_STEP`, bit for bit the plain version) and the
plain tensor ops (`_adam_plain`) on the CPU.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from steppingstone_tpu_torch import tracing
from steppingstone_tpu_torch.agents import distributions as dist
from steppingstone_tpu_torch.agents.mirror import MirrorSpec, mirror_minibatch
from steppingstone_tpu_torch.agents.networks import (
    ActorCritic, clamped_logstd, params_from_jax, project_logstd)
from steppingstone_tpu_torch.parallel.mesh import SINGLE, Mesh, all_reduce_sum
from steppingstone_tpu_torch.physics.step_kernel import ADAM_STEP, AdamTable
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


def _adam_plain(params: list, opt: AdamState, cfg: PPOConfig, g: torch.Tensor,
                gnorm: torch.Tensor, approx_kl: torch.Tensor, lr: torch.Tensor,
                kl_cutoff: float | None) -> None:
    """The optimizer in tensor ops (what `adam_step` computes on the card):
    optax's clip_by_global_norm -> scale_by_adam -> params -= lr * update
    with the KL guard (`kl_cutoff`, None: off); `opt.count` already counts
    this step. Writes mu, nu and the parameters in place."""
    # optax.clip_by_global_norm
    g = torch.where(gnorm < cfg.max_grad_norm, g, (g / gnorm) * cfg.max_grad_norm)
    # optax.scale_by_adam
    mu = (1 - ADAM_B1) * g + ADAM_B1 * opt.mu
    nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * opt.nu
    c = opt.count.to(torch.float32)
    update = (mu / (1 - ADAM_B1 ** c)) / (torch.sqrt(nu / (1 - ADAM_B2 ** c)) + cfg.eps)
    step_lr = lr
    if kl_cutoff is not None:
        # trust guard: a minibatch that drifted too far applies no update
        step_lr = torch.where(approx_kl > kl_cutoff, torch.zeros_like(lr), lr)
    with torch.no_grad():
        flat = torch.cat([p.reshape(-1) for p in params]) - step_lr * update
        for p, x in zip(params, flat.split([p.numel() for p in params])):
            p.copy_(x.view_as(p))
    opt.mu.copy_(mu)
    opt.nu.copy_(nu)


def _minibatch_step(policy: ActorCritic, params: list, opt: AdamState, cfg: PPOConfig,
                    mb: dict, lr: torch.Tensor, value_only: bool, mesh: Mesh, m_global: int,
                    table: AdamTable | None) -> PPOMetrics:
    """One optimizer step on one minibatch of `m_global` rows, `mb` this
    rank's (its mirrored rows already after its own with `cfg.mirror`);
    updates `policy` and Adam's state `opt` in place and returns the
    PPOMetrics of this step. Over several ranks one all-reduce sums the flat
    gradient and the loss terms, so every rank clips, guards and steps on
    the global values and stays identical. CPU tensors run the plain
    optimizer, CUDA tensors the `adam_step` kernel through `table` (the
    parameters' `ADAM_STEP.table`)."""
    with span("ppo.forward"):
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
        opt.count.add_(1)
        kl_cutoff = cfg.kl_cutoff if cfg.kl_cutoff > 0.0 and not value_only else None
        if g.device.type == "cpu":
            _adam_plain(params, opt, cfg, g, gnorm, approx_kl, lr, kl_cutoff)
        elif g.device.type == "cuda":
            ADAM_STEP.launch(table, g, opt.mu, opt.nu, opt.count, gnorm, approx_kl, lr,
                             cfg.max_grad_norm, ADAM_B1, ADAM_B2, cfg.eps, kl_cutoff)
        else:
            raise ValueError(f"unsupported device {g.device}")
        project_logstd(policy)
    return PPOMetrics(value_loss, action_loss, entropy.detach(), gnorm, clip_frac, approx_kl)


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


def _captures(device: torch.device, mesh: Mesh) -> bool:
    """Whether `ppo_update` replays a captured step: on a CUDA device in one
    process. Over ranks (or with a process group of one) each rank holds its
    own ragged share of a minibatch and the all-reduce stays outside any
    graph, so the step runs eagerly, as it does on the CPU."""
    return device.type == "cuda" and mesh.world == 1 and not mesh.distributed


class _StepBuffers:
    """What one minibatch step reads and writes, in tensors that live as long
    as the step does (and a graph captured from it): the batch (with
    `cfg.mirror` followed by its mirror image: obs and actions mirrored, the
    other fields repeated), the update's row order (steps, mbs; with the
    mirror each step's rows then the same rows of the image), the lr, Adam's
    count, mu and nu, the step index and a (steps, 6) history of each step's
    PPOMetrics; on a card the parameters' table for `adam_step`. `load`
    fills them for an update, `step` runs one minibatch step on them and
    `result` reads the update's outcome."""

    def __init__(self, policy: ActorCritic, cfg: PPOConfig, batch: dict, value_only: bool,
                 steps: int, mbs: int, mesh: Mesh):
        dev = batch["obs"].device
        self.cfg, self.value_only, self.mesh, self.mbs = cfg, value_only, mesh, mbs
        # the tensors, not the module: a graph cache keyed weakly by the
        # policy must not hold it
        self.params = list(policy.parameters())
        self.table = ADAM_STEP.table(self.params) if dev.type == "cuda" else None
        n = sum(p.numel() for p in self.params)
        self.rows = batch["obs"].shape[0]
        fold = 1 if cfg.mirror is None else 2
        self.batch = {k: torch.empty((fold * v.shape[0], *v.shape[1:]), dtype=v.dtype, device=dev)
                      for k, v in batch.items()}
        self.perms = torch.empty((steps, fold * mbs), dtype=torch.long, device=dev)
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.mu = torch.zeros(n, device=dev)
        self.nu = torch.zeros(n, device=dev)
        self.index = torch.zeros(1, dtype=torch.long, device=dev)
        self.history = torch.zeros((steps, len(PPOMetrics._fields)), device=dev)

    def load(self, batch: dict, perms: torch.Tensor | None, opt_state: AdamState, lr) -> None:
        """Copies an update's inputs in, with the mirror the batch's mirror
        image too (`perms` None: the rows are given to each step); none of
        these synchronizes with the host."""
        if self.cfg.mirror is not None:
            batch = mirror_minibatch(self.cfg.mirror, batch)
        for k, v in batch.items():
            self.batch[k].copy_(v)
        if perms is not None:
            perms = perms.reshape(self.perms.shape[0], -1)
            if self.cfg.mirror is not None:
                perms = torch.cat([perms, perms + self.rows], dim=1)
            self.perms.copy_(perms)
        self.lr.fill_(lr)
        self.count.copy_(opt_state.count)
        self.mu.copy_(opt_state.mu)
        self.nu.copy_(opt_state.nu)
        self.index.zero_()

    def step(self, policy: ActorCritic, rows: torch.Tensor | None = None) -> None:
        """One minibatch step on rows `rows` of the batch (with the mirror,
        and the same rows of its image), by default the row order's row at
        the step index; Adam's state, the parameters and the history row
        are written in place and the index advances."""
        if rows is None:
            rows = self.perms.index_select(0, self.index).view(-1)
        elif self.cfg.mirror is not None:
            rows = torch.cat([rows, rows + self.rows])
        mb = {k: v[rows] for k, v in self.batch.items()}
        m = _minibatch_step(policy, self.params, AdamState(self.count, self.mu, self.nu),
                            self.cfg, mb, self.lr, self.value_only, self.mesh, self.mbs,
                            self.table)
        self.history.index_copy_(0, self.index, torch.stack(m).view(1, -1))
        self.index.add_(1)

    def result(self) -> tuple:
        """(AdamState, PPOMetrics averaged over the steps), copies that share
        no storage with the buffers; each mean over a contiguous copy of its
        column, as `torch.stack(...).mean()` takes it."""
        metrics = PPOMetrics(*(self.history[:, j].contiguous().mean()
                               for j in range(self.history.shape[1])))
        return AdamState(self.count.clone(), self.mu.clone(), self.nu.clone()), metrics


GRAPH_WARMUP_STEPS = 3  # eager steps on a side stream before a capture (torch.cuda.graphs)


class _GraphedStep:
    """One minibatch step captured as a CUDA graph over `_StepBuffers`: the
    first GRAPH_WARMUP_STEPS calls run the step eagerly on a side stream, the
    next captures it and replays it, every later call replays it. Each call
    is one real step of the update. `ADAM_STEP.launches` counts what ran: an
    eager step its launch, a capture none, a replay the launches its graph
    holds."""

    def __init__(self, key: tuple, buffers: _StepBuffers):
        self.key, self.buffers, self.graph, self.warm = key, buffers, None, 0
        self.adam_launched = 0
        self.side = torch.cuda.Stream(buffers.lr.device)

    def __call__(self, policy: ActorCritic) -> None:
        if self.graph is None and self.warm < GRAPH_WARMUP_STEPS:
            main = torch.cuda.current_stream(self.buffers.lr.device)
            self.side.wait_stream(main)
            with torch.cuda.stream(self.side), span("ppo.minibatch"):
                self.buffers.step(policy)
            main.wait_stream(self.side)
            self.warm += 1
            return
        if self.graph is None:
            before = ADAM_STEP.launches
            graph = torch.cuda.CUDAGraph()
            with span("ppo.graph.capture"), torch.cuda.graph(graph):
                self.buffers.step(policy)
            self.adam_launched = ADAM_STEP.launches - before
            ADAM_STEP.launches = before  # the capture ran nothing
            self.graph = graph
            tracing.count("ppo.graph.captures")
        with span("ppo.minibatch"):
            self.graph.replay()
        ADAM_STEP.launches += self.adam_launched
        tracing.count("ppo.graph.replays")


# policy -> {value_only: _GraphedStep}; an entry goes with its policy
_GRAPHS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _graph_key(policy: ActorCritic, cfg: PPOConfig, batch: dict, value_only: bool) -> tuple:
    """What a captured step depends on and the code can observe: the config
    (by identity), value_only, the device, the batch's field shapes and
    dtypes, and the parameters' storage."""
    return (cfg, value_only, batch["obs"].device,
            tuple((k, v.shape, v.dtype) for k, v in batch.items()),
            tuple(p.data_ptr() for p in policy.parameters()))


def _graphed_step(policy: ActorCritic, cfg: PPOConfig, batch: dict, value_only: bool,
                  steps: int, mbs: int) -> _GraphedStep:
    """The policy's captured step for these inputs, made anew when its key
    (`_graph_key`) changed."""
    key = _graph_key(policy, cfg, batch, value_only)
    graphs = _GRAPHS.setdefault(policy, {})
    got = graphs.get(value_only)
    if got is None or got.key != key:
        got = graphs[value_only] = None  # the old graph and its pool go before the new ones come
        got = graphs[value_only] = _GraphedStep(
            key, _StepBuffers(policy, cfg, batch, value_only, steps, mbs, SINGLE))
    return got


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
        steps = cfg.ppo_epoch * cfg.num_mini_batch
        if _captures(dev, mesh):
            step = _graphed_step(policy, cfg, batch, value_only, steps, mbs)
            step.buffers.load(batch, perms, opt_state, lr)
            for _ in range(steps):
                step(policy)
            return step.buffers.result()
        buffers = _StepBuffers(policy, cfg, batch, value_only, steps, mbs, mesh)
        buffers.load(batch, perms if mesh.world == 1 else None, opt_state, lr)
        for epoch in range(cfg.ppo_epoch):
            if mesh.world == 1:
                minibatches = [None] * cfg.num_mini_batch
            else:
                minibatches = local_minibatches(mesh, perms[epoch], cfg.num_mini_batch, num_envs)
            for rows in minibatches:
                with span("ppo.minibatch"):
                    buffers.step(policy, rows)
        return buffers.result()
