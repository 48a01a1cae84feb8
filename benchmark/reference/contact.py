"""Penalty contact between robot contact spheres and the terrain (port of
steppingstone_tpu/physics/contact.py).

Terrain = stepping stones (tilted discs, or boxes for plank support) plus
an optional ground plane at z=0; stone rows are (x, y, z, phi, x_tilt,
y_tilt). Branchless and batched over envs (B) x spheres (NC) x stones (S).
Forces are spring-damper normal plus Coulomb-capped viscous friction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import spatial as sp
from .quaternion import cross


class ContactParams(NamedTuple):
    """Penalty gains, sized for explicit 240 Hz substeps (see the JAX
    module for the derivation from the ankle's effective mass)."""

    kn: float = 15000.0      # normal spring stiffness (N/m) per contact
    cn: float = 60.0         # normal damping (N s/m)
    mu: float = 1.0          # Coulomb friction coefficient
    kt: float = 150.0        # tangential viscous gain (N s/m)
    margin: float = 0.02     # lateral overhang allowed beyond stone rim (m)


class ContactOut(NamedTuple):
    force: torch.Tensor         # (B, NC, 3) world contact force on each sphere
    normal_force: torch.Tensor  # (B, NC) normal force magnitude
    stone_index: torch.Tensor   # (B, NC) long index of supporting stone (-1 = ground/none)
    in_contact: torch.Tensor    # (B, NC) bool


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def stone_normals(stones: torch.Tensor) -> torch.Tensor:
    """(..., 6) stone rows -> (..., 3) top-surface unit normals: +z rotated
    by x_tilt about x, then y_tilt about y."""
    xt, yt = stones[..., 4], stones[..., 5]
    nx = torch.sin(yt) * torch.cos(xt)
    ny = -torch.sin(xt)
    nz = torch.cos(yt) * torch.cos(xt)
    return torch.stack([nx, ny, nz], dim=-1)


def support_axes(stones: torch.Tensor):
    """In-plane unit axes of each stone's top: ux along the heading phi
    projected onto the tilted plane, uy = n x ux (plank support)."""
    normals = stone_normals(stones)
    phi = stones[..., 3]
    h = torch.stack([torch.cos(phi), torch.sin(phi), torch.zeros_like(phi)], dim=-1)
    ux = h - _dot(h, normals)[..., None] * normals
    ux = ux / torch.sqrt(torch.sum(ux * ux, dim=-1, keepdim=True) + 1e-12)
    return ux, cross(normals, ux)


def compute_contacts(
    points: torch.Tensor,        # (B, NC, 3) sphere centers, world
    velocities: torch.Tensor,    # (B, NC, 3) sphere center velocities
    radius: torch.Tensor,        # (NC,)
    stones: torch.Tensor,        # (B, S, 6)
    stone_radius: torch.Tensor,  # (B,) disc radius / plank half-length
    use_ground: torch.Tensor,    # (B,) bool: include the plane z=0
    params: ContactParams = ContactParams(),
    support_hy: float | None = None,  # None: disc; else plank lateral half-extent
) -> ContactOut:
    normals = stone_normals(stones)                          # (B, S, 3)
    rel = points[:, :, None, :] - stones[:, None, :, :3]     # (B, NC, S, 3)
    dist_n = _dot(rel, normals[:, None])                     # height above plane
    lat = rel - dist_n[..., None] * normals[:, None]         # tangential offset
    rim = (stone_radius + params.margin)[:, None, None]
    rad = radius[None, :, None]

    pen = rad - dist_n                                       # (B, NC, S)
    if support_hy is None:
        on_disc = torch.sqrt(_dot(lat, lat)) <= rim
    else:
        ux, uy = support_axes(stones)
        on_disc = (torch.abs(_dot(lat, ux[:, None])) <= rim) & (
            torch.abs(_dot(lat, uy[:, None])) <= support_hy + params.margin
        )
    # top surface only, valid while the center is above the mid-plane
    valid = on_disc & (pen > 0.0) & (dist_n > -rad)
    pen = torch.where(valid, pen, float("-inf"))

    # the ground plane as an extra pseudo-stone, after the stones: the
    # first maximum wins, so a stone/ground tie goes to the stone
    g_pen = radius[None] - points[..., 2]
    g_pen = torch.where(use_ground[:, None] & (g_pen > 0), g_pen, float("-inf"))
    all_pen = torch.cat([pen, g_pen[..., None]], dim=-1)     # (B, NC, S+1)
    best_pen, best = torch.max(all_pen, dim=-1)
    in_contact = best_pen > 0.0

    ground_n = normals.new_tensor([0.0, 0.0, 1.0]).expand(normals.shape[0], 1, 3)
    n_all = torch.cat([normals, ground_n], dim=1)            # (B, S+1, 3)
    n = torch.gather(n_all, 1, best[..., None].expand(-1, -1, 3))  # (B, NC, 3)

    pen_c = torch.clamp(best_pen, min=0.0)
    vn = _dot(velocities, n)
    fn = params.kn * pen_c - params.cn * vn * (pen_c > 0)
    fn = torch.clamp(fn, min=0.0) * in_contact

    vt = velocities - vn[..., None] * n
    vt_norm = torch.sqrt(torch.sum(vt * vt, dim=-1) + 1e-8)
    ft_mag = torch.minimum(params.mu * fn, params.kt * vt_norm)
    ft = -ft_mag[..., None] * vt / vt_norm[..., None]

    force = fn[..., None] * n + ft
    nstones = stones.shape[1]
    stone_index = torch.where(in_contact & (best < nstones), best, -1)
    return ContactOut(force=force, normal_force=fn, stone_index=stone_index,
                      in_contact=in_contact)


def contact_forces_to_bodies(
    nbodies: int,
    contact_body: torch.Tensor,  # (NC,) long body index per sphere
    points: torch.Tensor,        # (B, NC, 3)
    root_pos: torch.Tensor,      # (B, 3)
    force: torch.Tensor,         # (B, NC, 3)
) -> torch.Tensor:
    """Scatter point forces into per-body spatial forces (B, NB, 6)."""
    f_sp = sp.force_at_point(force, points - root_pos[:, None])
    f_ext = f_sp.new_zeros((f_sp.shape[0], nbodies, 6))
    return f_ext.index_add(1, contact_body, f_sp)
