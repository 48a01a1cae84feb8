"""Quaternion and SO(3) primitives (port of steppingstone_tpu/core/quaternion.py).

Shape-polymorphic over leading batch dims: `(..., 4)` quaternions and
`(..., 3)` vectors. Convention: `(w, x, y, z)`, unit-norm, rotating
vectors from the local frame into the world frame.
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting 3-vector cross product over the last axis."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b (apply b's rotation first, then a's)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


# (dtype, device) -> the conjugate's signs (1, -1, -1, -1), made on first use
_CONJUGATE: dict = {}


def inv(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion (the conjugate)."""
    sign = _CONJUGATE.get((q.dtype, q.device))
    if sign is None:
        sign = _CONJUGATE[(q.dtype, q.device)] = q.new_tensor([1.0, -1.0, -1.0, -1.0])
    return q * sign


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """world_v = R(q) @ v, in the expanded 15-multiply form."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """local_v = R(q)^T @ v."""
    return rotate(inv(q), v)


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit quaternion for a rotation of `angle` (...,) about unit `axis` (..., 3)."""
    half = 0.5 * angle[..., None]
    axis, half = torch.broadcast_tensors(axis, half)
    return torch.cat([torch.cos(half[..., :1]), axis * torch.sin(half)], dim=-1)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def from_euler_zyx(yaw: torch.Tensor, pitch: torch.Tensor, roll: torch.Tensor) -> torch.Tensor:
    """Intrinsic Z(yaw)-Y(pitch)-X(roll) Euler angles (...,) -> quaternion (..., 4)."""
    cz, sz = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cy, sy = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cx, sx = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    return torch.stack(
        [
            cz * cy * cx + sz * sy * sx,
            cz * cy * sx - sz * sy * cx,
            cz * sy * cx + sz * cy * sx,
            sz * cy * cx - cz * sy * sx,
        ],
        dim=-1,
    )


def to_euler_zyx(q: torch.Tensor):
    """Quaternion -> (yaw, pitch, roll), intrinsic Z-Y-X."""
    w, x, y, z = q.unbind(-1)
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    sinp = torch.clamp(2 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(sinp)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    return yaw, pitch, roll


def integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """q(t+dt) = normalize(q + dt/2 * [0, omega] * q) (first order)."""
    omega_q = torch.cat([torch.zeros_like(omega_world[..., :1]), omega_world], dim=-1)
    dq = 0.5 * mul(omega_q, q)
    return normalize(q + dt * dq)


def heading(q: torch.Tensor) -> torch.Tensor:
    """Heading (yaw) of the body x axis projected onto the ground, (...,)."""
    fwd = rotate(q, q.new_tensor([1.0, 0.0, 0.0]))
    return torch.atan2(fwd[..., 1], fwd[..., 0])
