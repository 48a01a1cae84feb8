"""The yardstick's counts of work, from shapes: frozen copies of the
port's `control_step_flops` and `control_step_bytes`
(physics/step_kernel.py, counted section by section from
csrc/control_step.cu) on the reference's models, the networks' multiply-
adds, and the peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W,
dense)."""

from __future__ import annotations

import numpy as np

from benchmark.reference.dynamics import _ancestor_mask

PEAK_FP32 = 67e12     # FLOP/s outside the tensor cores
PEAK_TF32 = 495e12    # FLOP/s, tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s


def control_step_bytes(model, n_stones: int, pd: bool = False) -> int:
    """Bytes a control step must move per env: every input read once,
    every output written once (f32); stable PD adds the targets and the
    power."""
    inputs = model.nq + model.ndof + model.njoints + 6 * n_stones + 2
    if pd:
        inputs += model.njoints + 1
    outputs = model.nq + model.ndof + model.njoints + 7
    return 4 * (inputs + outputs)


def _rotated_rows(model) -> int:
    rot = np.asarray(model.joint_rot, np.float32)
    return sum(1 for i in range(model.nbodies)
               if not np.array_equal(rot[i], np.array([1, 0, 0, 0], np.float32)))


def control_step_flops(model, n_stones: int, substeps: int, pd: bool = False,
                       support_hy=None, rot: bool = False) -> int:
    """fp32 operations one env's control step needs: each add, multiply,
    divide, min/max, abs, sqrt, rsqrt and sin/cos counts one (an FMA
    counts two); the Cholesky factor and solves at the ancestor sparsity
    of the mass matrix."""
    nb, nj, nd, nc, S = model.nbodies, model.njoints, model.ndof, model.ncontacts, n_stones
    mask = _ancestor_mask(model)
    pairs = int(mask.sum())
    fk = nj * 67 + nb * 96
    vel = nj * 54
    per_stone = 24 if support_hy is None else 31
    contact = nc * (33 + per_stone * S + 2 + 53)
    joints = nj * 22
    if pd:
        joints += 13 * int(np.count_nonzero((model.kp != 0) | (model.kd != 0)))
    crba = nb * 32 + nj * 10 + nd * 42 + pairs * 12
    rnea = nj * 42 + nb * 126 + nj * 6 + nd * 12
    chol = 0
    for j in range(nd):
        col = [i for i in range(j, nd) if mask[i, j]]
        chol += 2 + len(col)
        for k in col[1:]:
            chol += 2 * sum(1 for i in col if i >= k)
    solves = 2 * (2 * (pairs - nd) + nd)
    euler = 3 * nd + 40 + 2 * nc
    if rot:
        fk += 28 * _rotated_rows(model)
    per_substep = fk + vel + contact + joints + crba + rnea + nd * 5 + chol + solves + euler
    per_step = 7 * S + (31 * S if support_hy is not None else 0)
    return substeps * per_substep + per_step


def mlp_macs(dims: list) -> tuple:
    """(multiply-adds of a forward pass, those of its first layer)."""
    macs = [a * b for a, b in zip(dims[:-1], dims[1:])]
    return sum(macs), macs[0]


def network_macs(config: dict, obs_dim: int, act_dim: int) -> dict:
    """Forward multiply-adds a row of the actor, of one critic, and of
    their first layers."""
    h = config["hidden"]
    actor, actor_first = mlp_macs([obs_dim] + [h] * config["actor_layers"] + [act_dim])
    critic, critic_first = mlp_macs([obs_dim] + [h] * config["critic_layers"] + [1])
    return dict(actor=actor, actor_first=actor_first, critic=critic, critic_first=critic_first)


def train_flops_per_frame(config: dict, obs_dim: int, act_dim: int, step_flops: int) -> float:
    """FLOPs an iteration spends per frame (env-step): the rollout's actor
    and critics forward, the control step, the bootstrap value over the
    frames of a step, and the update's forward and backward over every
    (mirrored) row in every epoch. A backward pass is the weight
    gradients of every layer plus the input gradients of every layer but
    the first."""
    m = network_macs(config, obs_dim, act_dim)
    E = config["num_ensembles"]
    fwd = m["actor"] + E * m["critic"]
    bwd = 2 * fwd - m["actor_first"] - E * m["critic_first"]
    steps = config["episode_steps"] // config["num_processes"]
    rows = (config["episode_steps"] // config["mini_batch_size"]) * config["mini_batch_size"]
    mirror = 2 if config["use_mirror"] else 1
    update = (fwd + bwd) * mirror * config["ppo_epoch"] * rows / config["episode_steps"]
    return 2.0 * (fwd + E * m["critic"] / steps + update) + step_flops


def eval_flops_per_step(config: dict, obs_dim: int, act_dim: int, step_flops: int) -> float:
    """FLOPs an env-step of the behavior evaluation spends: the actor's
    mean and the control step."""
    return 2.0 * network_macs(config, obs_dim, act_dim)["actor"] + step_flops
