"""The physics engine step: actuation + contact + dynamics + integration
(port of steppingstone_tpu/physics/engine.py).

One 60 Hz control step = SUBSTEPS x 240 Hz substeps. `_step_scan` is the
plain batched PyTorch version, with optional stable-PD actuation (`pd`),
plank support (`support_hy`) and rotated joint frames (a model with
`joint_rot`); `step` is the entry point, which runs the hand-written CUDA
kernel for CUDA tensors (K1 torque/disc, K2 plank, K3 stable PD, K4
rotated frames, or their combination) and `_step_scan` for CPU tensors
(physics/step_kernel.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from steppingstone_tpu_torch.core import quaternion as qt
from steppingstone_tpu_torch.core.quaternion import cross
from steppingstone_tpu_torch.physics import contact as ct
from steppingstone_tpu_torch.physics import dynamics as dyn
from steppingstone_tpu_torch.physics import kinematics as kin_mod
from steppingstone_tpu_torch.physics.model import RobotModel, tensor

SIM_DT = 1.0 / 240.0
SUBSTEPS = 4  # -> 60 Hz control rate

LIMIT_K = 600.0   # joint-limit spring (stiff; handled implicitly)
LIMIT_C = 20.0    # joint-limit damper
MAX_QD = 150.0    # hard velocity clamp, a NaN firewall for pathological states
REG = 1e-5        # diagonal regularization of the mass matrix


class PhysicsState(NamedTuple):
    q: torch.Tensor   # (B, nq)
    qd: torch.Tensor  # (B, ndof)


class StepInfo(NamedTuple):
    foot_contact: torch.Tensor       # (B, 2) bool right/left foot touching anything
    foot_stone: torch.Tensor         # (B, 2) long stone index under each foot (-1 none)
    foot_normal_force: torch.Tensor  # (B, 2) peak normal force per foot over substeps
    joint_at_limit: torch.Tensor     # (B, NJ) bool at the final substep
    contact_force_sum: torch.Tensor  # (B,) total normal force summed over substeps


def joint_limit_torque(model: RobotModel, qj, qdj, k=LIMIT_K, c=LIMIT_C):
    lo = tensor(model, "joint_lower", qj.device)
    hi = tensor(model, "joint_upper", qj.device)
    below = torch.clamp(qj - lo, max=0.0)
    above = torch.clamp(qj - hi, min=0.0)
    out = (below < 0) | (above > 0)
    return -k * (below + above) - c * qdj * out, out


def passive_torque(model: RobotModel, qj, qdj):
    damp = tensor(model, "joint_damping", qj.device)
    stiff = tensor(model, "joint_stiffness", qj.device)
    ref = tensor(model, "joint_spring_ref", qj.device)
    return -damp * qdj - stiff * (qj - ref)


def torque_actuation(model: RobotModel, action: torch.Tensor) -> torch.Tensor:
    """Direct torque control: action (B, A) in [-1, 1] scales the per-joint
    torque limits of the actuated joints; returns (B, NJ)."""
    idx = tensor(model, "actuated_idx", action.device, torch.long)
    lim = tensor(model, "torque_limit", action.device)[idx]
    tau = action.new_zeros((action.shape[0], model.njoints))
    tau[:, idx] = torch.clamp(action, -1.0, 1.0) * lim
    return tau


def pd_target_from_action(model: RobotModel, action: torch.Tensor) -> torch.Tensor:
    """PD target angles from a policy action (B, A) in [-1, 1]: the middle of
    each actuated joint's range plus action x its half-range; returns the
    full (B, NJ) joint vector (non-actuated entries 0, their gains are 0)."""
    idx = tensor(model, "actuated_idx", action.device, torch.long)
    lo = tensor(model, "joint_lower", action.device)[idx]
    hi = tensor(model, "joint_upper", action.device)[idx]
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    target = action.new_zeros((action.shape[0], model.njoints))
    target[:, idx] = mid + torch.clamp(action, -1.0, 1.0) * half
    return target


def pd_actuation(model: RobotModel, action: torch.Tensor, qj: torch.Tensor,
                 qdj: torch.Tensor) -> torch.Tensor:
    """Explicit PD control held over the substeps: tau = kp (target - q) -
    kd qd on the actuated joints, clamped to their limits, with the target
    of `pd_target_from_action`; returns (B, NJ). The steppers use the
    stable PD inside each substep (`step(..., pd=...)`) instead: held
    torques are unstable on light links."""
    idx = tensor(model, "actuated_idx", action.device, torch.long)
    target = pd_target_from_action(model, action)[:, idx]
    kp = tensor(model, "kp", action.device)[idx]
    kd = tensor(model, "kd", action.device)[idx]
    lim = tensor(model, "torque_limit", action.device)[idx]
    tau = action.new_zeros((action.shape[0], model.njoints))
    tau[:, idx] = torch.clamp(kp * (target - qj[:, idx]) - kd * qdj[:, idx], -lim, lim)
    return tau


def pd_gains(model: RobotModel, device):
    """(kp, kd, torque limit) per joint, zero on joints the policy does not
    drive: the stable-PD gains of `_substep` and kernel K3."""
    act = tensor(model, "actuated", device).to(torch.float32)
    return (tensor(model, "kp", device) * act, tensor(model, "kd", device) * act,
            tensor(model, "torque_limit", device) * act)


def _substep(model, state, tau_j, stones, stone_radius, use_ground, cparams,
             pd=None, support_hy=None):
    q, qd = state.q, state.qd
    dev = q.device
    kin = kin_mod.forward_kinematics(model, q)
    vel = kin_mod.body_velocities(model, kin, qd)
    root = kin.pos[:, 0]

    pts = kin_mod.contact_points(model, kin)
    pvel = kin_mod.contact_point_velocities(model, kin, vel, pts)
    cout = ct.compute_contacts(pts, pvel, tensor(model, "contact_radius", dev),
                               stones, stone_radius, use_ground, cparams, support_hy)
    f_ext = ct.contact_forces_to_bodies(
        model.nbodies, tensor(model, "contact_body", dev, torch.long), pts, root,
        cout.force,
    )

    qj, qdj = q[:, 7:], qd[:, 6:]
    tau_lim, at_limit = joint_limit_torque(model, qj, qdj)
    pd_kp = pd_kd = 0.0
    if pd is not None:
        # stable PD: the explicit torque from the current substep state,
        # kp and kd on the implicit diagonals (holding one PD torque over
        # the four substeps rings Cassie's light links)
        target, power = pd
        kp_j, kd_j, lim_j = pd_gains(model, dev)
        tau_pd = torch.clamp(kp_j * (target - qj) - kd_j * qdj, -lim_j, lim_j)
        tau_j = tau_j + power[:, None] * tau_pd
        pd_kp, pd_kd = power[:, None] * kp_j, power[:, None] * kd_j
    zeros6 = q.new_zeros((q.shape[0], 6))
    tau_full = torch.cat([zeros6, tau_j + passive_torque(model, qj, qdj) + tau_lim], dim=1)
    # implicit per-joint spring-dampers: joint damping + limit dampers (+ PD
    # kd) on the D diagonal, passive springs + active limit springs (+ PD
    # kp) on K
    damp_j = tensor(model, "joint_damping", dev) + LIMIT_C * at_limit + pd_kd
    stiff_j = tensor(model, "joint_stiffness", dev) + LIMIT_K * at_limit + pd_kp
    qdd = dyn.forward_dynamics(
        model, kin, vel, tau_full, f_ext, reg=REG,
        damping_diag=torch.cat([zeros6, damp_j], dim=1),
        stiffness_diag=torch.cat([zeros6, stiff_j], dim=1),
        dt=SIM_DT,
    )

    # ---- semi-implicit Euler ------------------------------------------
    qd_new = torch.clamp(qd + SIM_DT * qdd, -MAX_QD, MAX_QD)
    omega, v_o = qd_new[:, 0:3], qd_new[:, 3:6]
    root_new = root + SIM_DT * v_o
    # re-reference the root linear velocity to the new root position
    v_root = v_o + cross(omega, root_new - root)
    quat_new = qt.integrate(q[:, 3:7], omega, SIM_DT)
    qj_new = qj + SIM_DT * qd_new[:, 6:]
    q_new = torch.cat([root_new, quat_new, qj_new], dim=1)
    qd_new = torch.cat([omega, v_root, qd_new[:, 6:]], dim=1)

    # per-foot diagnostics: each foot's strongest contact this substep
    foot_ids = tensor(model, "foot_of_contact", dev, torch.long)
    f_c, s_c = [], []
    for foot in range(2):
        mask = foot_ids == foot
        f = torch.where(mask, cout.normal_force, 0.0).max(dim=1).values
        best = torch.where(mask, cout.normal_force, -1.0).argmax(dim=1, keepdim=True)
        s = torch.gather(cout.stone_index, 1, best)[:, 0]
        f_c.append(f)
        s_c.append(torch.where(f > 0.0, s, -1))
    f_c = torch.stack(f_c, dim=1)
    info = StepInfo(
        foot_contact=f_c > 0.0,
        foot_stone=torch.stack(s_c, dim=1),
        foot_normal_force=f_c,
        joint_at_limit=at_limit,
        contact_force_sum=cout.normal_force.sum(dim=1),
    )
    return PhysicsState(q=q_new, qd=qd_new), info


def _step_scan(
    model: RobotModel,
    state: PhysicsState,
    tau_j: torch.Tensor,         # (B, NJ) joint torques held over the control step
    stones: torch.Tensor,        # (B, S, 6)
    stone_radius: torch.Tensor,  # (B,)
    use_ground: torch.Tensor,    # (B,) bool
    cparams: ct.ContactParams = ct.ContactParams(),
    substeps: int = SUBSTEPS,
    pd=None,                     # None, or (target (B, NJ), power (B,)): stable PD
    support_hy=None,             # None: disc support; a float: plank half-width
):
    """One control step = `substeps` dynamics substeps: the plain PyTorch
    version of kernels K1 (torque, disc), K2 (plank), K3 (stable PD), K4
    (rotated joint frames, from the model) and their combinations. Contact flags/forces are OR/max-aggregated over substeps so
    brief touchdowns are not missed."""
    B = state.q.shape[0]
    acc = StepInfo(
        foot_contact=torch.zeros((B, 2), dtype=torch.bool, device=state.q.device),
        foot_stone=torch.full((B, 2), -1, dtype=torch.long, device=state.q.device),
        foot_normal_force=state.q.new_zeros((B, 2)),
        joint_at_limit=torch.zeros((B, model.njoints), dtype=torch.bool,
                                   device=state.q.device),
        contact_force_sum=state.q.new_zeros((B,)),
    )
    for _ in range(substeps):
        state, info = _substep(model, state, tau_j, stones, stone_radius,
                               use_ground, cparams, pd, support_hy)
        acc = StepInfo(
            foot_contact=acc.foot_contact | info.foot_contact,
            foot_stone=torch.where(info.foot_stone >= 0, info.foot_stone, acc.foot_stone),
            foot_normal_force=torch.maximum(acc.foot_normal_force, info.foot_normal_force),
            joint_at_limit=info.joint_at_limit,
            contact_force_sum=acc.contact_force_sum + info.contact_force_sum,
        )
    return state, acc


def step(
    model: RobotModel,
    state: PhysicsState,
    tau_j: torch.Tensor,
    stones: torch.Tensor,
    stone_radius,
    use_ground,
    cparams: ct.ContactParams = ct.ContactParams(),
    substeps: int = SUBSTEPS,
    pd_target=None,
    pd_power=None,
    support_hy=None,
):
    """One 60 Hz control step for a batch of envs. CUDA tensors run the
    kernel (csrc/control_step.cu) in its specialization: K1 torque/disc,
    K2 with `support_hy` (plank), K3 with `pd_target` (stable PD toward the
    target, torques scaled by `pd_power`, default 1), K4 for a model with
    `joint_rot`, or their combination; CPU tensors run `_step_scan`. Unbatched tau_j (NJ,), pd_target (NJ,),
    stone_radius, use_ground and pd_power are broadcast over the batch."""
    from steppingstone_tpu_torch.physics import step_kernel  # it imports this module

    q, qd, info = step_kernel.control_step(
        model, state.q, state.qd, tau_j, stones, stone_radius, use_ground,
        cparams, substeps, target=pd_target, power=pd_power, support_hy=support_hy,
    )
    return PhysicsState(q, qd), info


def default_state(model: RobotModel, batch: int = 1, device="cpu") -> PhysicsState:
    """The model's initial pose at its root height, repeated `batch` times."""
    q = torch.cat([
        torch.tensor([0.0, 0.0, model.root_height], dtype=torch.float32),
        qt.identity(torch.float32),
        torch.as_tensor(model.init_q_joints, dtype=torch.float32),
    ]).to(device)
    return PhysicsState(q=q.expand(batch, -1).clone(),
                        qd=q.new_zeros((batch, model.ndof)))
