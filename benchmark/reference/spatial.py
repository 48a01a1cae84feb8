"""6D spatial-vector algebra, Featherstone convention (port of
steppingstone_tpu/core/spatial.py).

Motion vectors are `[omega; v_O]`, force vectors `[n_O; f]`, in a
world-aligned frame whose origin is re-centered at the robot root. All
functions broadcast over leading batch dims.
"""

from __future__ import annotations

import torch

from .quaternion import cross


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]x."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def cross_motion(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """v x m = [w_v x w_m ; w_v x v_m + v_v x w_m]."""
    wv, vv = v[..., :3], v[..., 3:]
    wm, vm = m[..., :3], m[..., 3:]
    return torch.cat([cross(wv, wm), cross(wv, vm) + cross(vv, wm)], dim=-1)


def cross_force(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """v x* f = [w_v x n_f + v_v x f_f ; w_v x f_f]."""
    wv, vv = v[..., :3], v[..., 3:]
    nf, ff = f[..., :3], f[..., 3:]
    return torch.cat([cross(wv, nf) + cross(vv, ff), cross(wv, ff)], dim=-1)


def inertia_matrix(mass, com, inertia_com: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about the origin:
    [[I_c - m cx cx, m cx], [-m cx, m 1]] with cx = skew(com)."""
    cx = skew(com)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=com.dtype, device=com.device).expand(cx.shape)
    top = torch.cat([inertia_com - m * torch.matmul(cx, cx), m * cx], dim=-1)
    bot = torch.cat([-m * cx, m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inertia_mul(mass, com, inertia_com: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """I @ v without materializing the 6x6:
    h_lin = m (v_O + w x c), h_ang = I_c w + c x h_lin."""
    w, vo = v[..., :3], v[..., 3:]
    vc = vo + cross(w, com)
    h_lin = mass[..., None] * vc
    h_ang = (inertia_com * w[..., None, :]).sum(-1) + cross(com, h_lin)
    return torch.cat([h_ang, h_lin], dim=-1)


def force_at_point(f: torch.Tensor, p: torch.Tensor, torque: torch.Tensor | None = None) -> torch.Tensor:
    """Linear force f applied at point p -> spatial force [p x f + torque ; f]."""
    n = cross(p, f)
    if torque is not None:
        n = n + torque
    return torch.cat([n, f], dim=-1)


def point_velocity(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Velocity of the body-fixed point p (relative to the origin) of a body
    with spatial velocity v = [w; v_O]: v_O + w x p."""
    return v[..., 3:] + cross(v[..., :3], p)
