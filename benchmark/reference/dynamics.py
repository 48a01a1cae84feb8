"""Articulated forward dynamics: CRBA mass matrix + RNEA bias forces (port
of steppingstone_tpu/physics/dynamics.py).

World-aligned frame re-centered at the robot root: each dof k has a 6D
motion axis Phi_k, the mass matrix is the ancestor-masked product
M = Phi I^C Phi^T, and bias forces come from a two-pass RNEA with qdd = 0.
Batched over a leading env axis; body loops are Python loops over the
static tree.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import spatial as sp
from .quaternion import cross
from .linalg import cholesky_solve
from .kinematics import Kin
from .model import RobotModel, tensor

GRAVITY = 9.8


@lru_cache(maxsize=None)
def _ancestor_mask(model: RobotModel) -> np.ndarray:
    """(ndof, ndof) float mask: A[k, l] = 1 iff dof l is an ancestor-or-self
    of dof k (root dofs use lower-triangular ordering among themselves)."""
    nd = model.ndof
    A = np.zeros((nd, nd), dtype=np.float32)
    A[:6, :6] = np.tril(np.ones((6, 6)))
    # the joint dof of body i (> 0) is 5 + i
    for i in range(1, model.nbodies):
        k = 5 + i
        A[k, 0:6] = 1.0
        for b in model.ancestors(i):
            if b > 0:
                A[k, 5 + b] = 1.0
    return A


@lru_cache(maxsize=None)
def _mask_tensor(model: RobotModel, device: str) -> torch.Tensor:
    return torch.as_tensor(_ancestor_mask(model), device=device)


def dof_axes(model: RobotModel, kin: Kin) -> torch.Tensor:
    """Motion axes Phi: (B, ndof, 6) in root-centered world Plücker coords."""
    B = kin.pos.shape[0]
    eye = torch.eye(6, dtype=kin.pos.dtype, device=kin.pos.device).expand(B, 6, 6)
    a = kin.axis[:, 1:]
    p_rel = kin.pos[:, 1:] - kin.pos[:, 0:1]
    joint_rows = torch.cat([a, cross(p_rel, a)], dim=-1)
    return torch.cat([eye, joint_rows], dim=1)


def mass_matrix(model: RobotModel, kin: Kin, phi: torch.Tensor) -> torch.Tensor:
    """Joint-space inertia matrix via world-frame CRBA: (B, ndof, ndof)."""
    dev = kin.pos.device
    mass = tensor(model, "mass", dev)
    I_all = sp.inertia_matrix(
        mass.expand(kin.pos.shape[0], -1), kin.com - kin.pos[:, 0:1], kin.inertia_w
    )                                                   # (B, NB, 6, 6)
    # composite inertias, leaves -> root
    I_comp = list(I_all.unbind(1))
    for i in range(model.nbodies - 1, 0, -1):
        p = int(model.parent[i])
        I_comp[p] = I_comp[p] + I_comp[i]
    # per-dof composite inertia: root dofs use body 0, joint dof of body i uses i
    Ic = torch.stack([I_comp[0]] * 6 + I_comp[1:], dim=1)    # (B, nd, 6, 6)
    F = (Ic * phi[:, :, None, :]).sum(-1)                      # (B, nd, 6)
    L = torch.matmul(F, phi.transpose(1, 2)) * _mask_tensor(model, str(dev))
    return L + L.transpose(1, 2) - torch.diag_embed(torch.diagonal(L, dim1=1, dim2=2))


def bias_forces(
    model: RobotModel,
    kin: Kin,
    vel: torch.Tensor,
    phi: torch.Tensor,
    f_ext: torch.Tensor | None = None,
) -> torch.Tensor:
    """RNEA with qdd=0: generalized bias forces C(q, qd) - tau_ext, (B, ndof).

    vel: (B, NB, 6) body spatial velocities; f_ext: (B, NB, 6) external
    spatial forces (root-centered Plücker) on each body, or None."""
    mass = tensor(model, "mass", kin.pos.device)
    # forward pass: velocity-product accelerations, gravity as a base
    # acceleration of +g
    g = vel.new_tensor([0, 0, 0, 0, 0, GRAVITY]).expand(vel.shape[0], 6)
    acc = [g]
    for i in range(1, model.nbodies):
        p = int(model.parent[i])
        acc.append(acc[p] + sp.cross_motion(vel[:, i], vel[:, i] - vel[:, p]))
    acc = torch.stack(acc, dim=1)

    # net body forces for all bodies at once, then accumulate toward the root
    m = mass.expand(vel.shape[0], -1)
    com_rel = kin.com - kin.pos[:, 0:1]
    Iv = sp.inertia_mul(m, com_rel, kin.inertia_w, vel)
    f_all = sp.inertia_mul(m, com_rel, kin.inertia_w, acc) + sp.cross_force(vel, Iv)
    if f_ext is not None:
        f_all = f_all - f_ext
    f = list(f_all.unbind(1))
    for i in range(model.nbodies - 1, 0, -1):
        p = int(model.parent[i])
        f[p] = f[p] + f[i]

    f_joints = torch.stack(f[1:], dim=1)                       # (B, NJ, 6)
    C_joints = (phi[:, 6:] * f_joints).sum(-1)
    return torch.cat([f[0], C_joints], dim=-1)


def forward_dynamics(
    model: RobotModel,
    kin: Kin,
    vel: torch.Tensor,
    tau: torch.Tensor,
    f_ext: torch.Tensor | None = None,
    reg: float = 1e-5,
    damping_diag: torch.Tensor | None = None,
    stiffness_diag: torch.Tensor | None = None,
    dt: float = 0.0,
) -> torch.Tensor:
    """Solve (M + diag(reg + dt*D + dt^2*K)) qdd = tau - C, (B, ndof).

    damping_diag / stiffness_diag (B, ndof) make per-joint spring-dampers
    implicit (their explicit forces are already inside `tau`), which keeps
    stiff dampers stable at 240 Hz on very light links."""
    phi = dof_axes(model, kin)
    M = mass_matrix(model, kin, phi)
    C = bias_forces(model, kin, vel, phi, f_ext)
    rhs = tau - C
    lhs_diag = reg * torch.ones_like(rhs)
    if damping_diag is not None:
        lhs_diag = lhs_diag + dt * damping_diag
    if stiffness_diag is not None:
        lhs_diag = lhs_diag + (dt * dt) * stiffness_diag
    return cholesky_solve(M + torch.diag_embed(lhs_diag), rhs)
