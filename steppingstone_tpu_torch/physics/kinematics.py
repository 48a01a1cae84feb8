"""Forward kinematics for RobotModel trees (port of
steppingstone_tpu/physics/kinematics.py).

Batched over a leading env axis: q (B, nq), qd (B, ndof). The body loop is
a Python loop over the static tree; every outer op runs on the whole batch.
All outputs are in world coordinates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from steppingstone_tpu_torch.core import quaternion as qt
from steppingstone_tpu_torch.core.quaternion import cross
from steppingstone_tpu_torch.physics.model import RobotModel, tensor


class Kin(NamedTuple):
    """Per-body world-frame kinematics (axes B, NB, ...)."""

    pos: torch.Tensor        # (B, NB, 3) body frame origin
    quat: torch.Tensor       # (B, NB, 4) body orientation
    axis: torch.Tensor       # (B, NB, 3) world joint axis (row 0 zero)
    com: torch.Tensor        # (B, NB, 3) world CoM position
    R: torch.Tensor          # (B, NB, 3, 3) rotation matrices
    inertia_w: torch.Tensor  # (B, NB, 3, 3) rotational inertia about CoM, world axes


def split_q(model: RobotModel, q: torch.Tensor):
    """(root position (B, 3), root quaternion (B, 4), joint angles (B, NJ))."""
    return q[:, 0:3], q[:, 3:7], q[:, 7:]


def split_qd(model: RobotModel, qd: torch.Tensor):
    """(root angular (B, 3), root linear (B, 3), joint velocities (B, NJ)):
    the root's spatial velocity [w; v] split, then the joints."""
    return qd[:, 0:3], qd[:, 3:6], qd[:, 6:]


def forward_kinematics(model: RobotModel, q: torch.Tensor) -> Kin:
    dev = q.device
    anchor = tensor(model, "joint_anchor", dev)
    ax_local = tensor(model, "joint_axis", dev)
    # fixed parent -> joint frame rotations (URDF <origin rpy>), or None
    jrot = None if model.joint_rot is None else tensor(model, "joint_rot", dev)
    root_pos, root_quat, qj = split_q(model, q)

    pos = [root_pos]
    quat = [root_quat]
    axis = [torch.zeros_like(root_pos)]
    for i in range(1, model.nbodies):
        p = int(model.parent[i])
        pos.append(pos[p] + qt.rotate(quat[p], anchor[i]))
        q_parent = quat[p] if jrot is None else qt.mul(quat[p], jrot[i])
        q_i = qt.mul(q_parent, qt.from_axis_angle(ax_local[i], qj[:, i - 1]))
        quat.append(q_i)
        # rotating about its own axis leaves it fixed in the body frame
        axis.append(qt.rotate(q_i, ax_local[i]))

    pos = torch.stack(pos, dim=1)
    quat = torch.stack(quat, dim=1)
    axis = torch.stack(axis, dim=1)
    R = qt.to_matrix(quat)
    com = pos + (R * tensor(model, "com", dev)[None, :, None, :]).sum(-1)
    inertia = tensor(model, "inertia", dev)  # principal moments, body axes
    # R diag(I) R^T
    inertia_w = torch.matmul(R * inertia[None, :, None, :], R.transpose(-1, -2))
    return Kin(pos=pos, quat=quat, axis=axis, com=com, R=R, inertia_w=inertia_w)


def body_velocities(model: RobotModel, kin: Kin, qd: torch.Tensor) -> torch.Tensor:
    """Spatial velocities [w; v_O] of every body, origin at the root: (B, NB, 6)."""
    root = kin.pos[:, 0]
    omega0, v0, qdj = split_qd(model, qd)
    v = [torch.cat([omega0, v0], dim=-1)]
    for i in range(1, model.nbodies):
        p = int(model.parent[i])
        a = kin.axis[:, i]
        phi = torch.cat([a, cross(kin.pos[:, i] - root, a)], dim=-1)
        v.append(v[p] + phi * qdj[:, i - 1:i])
    return torch.stack(v, dim=1)


def contact_points(model: RobotModel, kin: Kin) -> torch.Tensor:
    """World positions of all contact sphere centers: (B, NC, 3)."""
    b = tensor(model, "contact_body", kin.pos.device, torch.long)
    offs = tensor(model, "contact_offset", kin.pos.device)
    return kin.pos[:, b] + (kin.R[:, b] * offs[None, :, None, :]).sum(-1)


def contact_point_velocities(
    model: RobotModel, kin: Kin, vel: torch.Tensor, points: torch.Tensor
) -> torch.Tensor:
    """World velocities of contact sphere centers: (B, NC, 3)."""
    b = tensor(model, "contact_body", kin.pos.device, torch.long)
    vb = vel[:, b]
    return vb[..., 3:] + cross(vb[..., :3], points - kin.pos[:, 0:1])
