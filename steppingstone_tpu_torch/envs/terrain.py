"""Stepping-stone terrain generation and curriculum-conditioned sampling
(port of steppingstone_tpu/envs/terrain.py).

`terrain` rows are (x, y, z, phi, x_tilt, y_tilt); stones are placed in
spherical steps (r, yaw, pitch) cumulative in heading, with positive pitch
placing the stone lower. An 11 x 11 (yaw x pitch) grid drives curriculum
sampling; discrete levels 0..5 widen the uniform ranges.

Batched over envs (leading axis B). Every sampler takes its random draws
as a `StoneDraws`; `draw_stones` makes them from a `torch.Generator` (for a
shard of the fleet, its rows of the whole fleet's draws), and tests pass
the JAX package's draws instead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from steppingstone_tpu_torch.parallel.mesh import SINGLE, Mesh

N_LEVELS = 6
GRID = 11
YAW_MAX = float(np.deg2rad(20.0))
PITCH_MAX = float(np.deg2rad(50.0))
TILT_MAX = float(np.deg2rad(15.0))
R_MIN, R_MAX = 0.65, 1.25
INIT_STEP_SEPARATION = 0.75

YAW_SAMPLES = np.linspace(-YAW_MAX, YAW_MAX, GRID).astype(np.float32)
PITCH_SAMPLES = np.linspace(-PITCH_MAX, PITCH_MAX, GRID).astype(np.float32)
R_SAMPLES = np.linspace(R_MIN, R_MAX, GRID).astype(np.float32)


class CurriculumState(NamedTuple):
    """Per-env curriculum knobs (leading axis B)."""

    level: torch.Tensor        # (B,) float32 in [0, 5]
    sample_prob: torch.Tensor  # (B, GRID, GRID) categorical over (yaw, pitch)
    use_prob: torch.Tensor     # (B,) bool: sample from the grid, else uniform
    assist: torch.Tensor       # (B,) float32 support-geometry assist level


class StoneDraws(NamedTuple):
    """Random draws behind stone placements, leading axes (B, K)."""

    u: torch.Tensor    # (B, K, 4) uniform in [-1, 1): yaw, pitch, x_tilt, y_tilt
    r_u: torch.Tensor  # (B, K) uniform in [0, 1): step length, uniform mode
    cat: torch.Tensor  # (B, K) long grid cell in [0, GRID * GRID), grid mode
    r_g: torch.Tensor  # (B, K) uniform in [0, 1): step length, grid mode


def default_curriculum(level: float = 0, assist=None, batch: int = 1,
                       device="cpu") -> CurriculumState:
    def full(v, dtype=torch.float32):
        return torch.full((batch,), v, dtype=dtype, device=device)

    return CurriculumState(
        level=full(level),
        sample_prob=torch.full((batch, GRID, GRID), 1.0 / (GRID * GRID), device=device),
        use_prob=full(False, torch.bool),
        assist=full(level if assist is None else assist),
    )


def level_scale(level: torch.Tensor) -> torch.Tensor:
    return torch.clamp(level.to(torch.float32) / (N_LEVELS - 1), 0.0, 1.0)


def specialist_band_prob(k: int, device="cpu") -> torch.Tensor:
    """Uniform distribution (GRID, GRID) over the difficulty band (annulus)
    k of the grid: cells whose Chebyshev ring index max(|yi-5|, |pi-5|) ==
    k, with k clipped to [0, N_LEVELS - 1] (the specialist curriculum's
    `update_specialist(k)`)."""
    c = (GRID - 1) // 2
    yi, pi = np.meshgrid(np.arange(GRID), np.arange(GRID), indexing="ij")
    ring = np.maximum(np.abs(yi - c), np.abs(pi - c))
    sel = (ring == min(max(int(k), 0), N_LEVELS - 1)).astype(np.float32)
    return torch.as_tensor(sel / np.sum(sel, dtype=np.float32), device=device)


def draw_stones(cur: CurriculumState, k: int, generator: torch.Generator | None = None,
                mesh: Mesh = SINGLE) -> StoneDraws:
    """Fresh draws for k placements per env from `generator`, made at the
    global batch of `mesh` (world x the B envs of `cur`) and cut to this
    rank's rows, so a shard draws its rows of the single-process draws.
    The grid cell is one uniform per placement, turned into a cell by the
    env's own cumulative `sample_prob` (the first cell whose cumulative
    probability exceeds u x the total)."""
    B, dev = cur.level.shape[0], cur.level.device

    def rand(*shape):
        return mesh.local(torch.rand((mesh.world * B, k) + shape, generator=generator,
                                     device=dev))

    cdf = torch.cumsum(cur.sample_prob.reshape(B, -1), dim=1)
    cat = torch.searchsorted(cdf, rand() * cdf[:, -1:], right=True)
    return StoneDraws(u=2.0 * rand(4) - 1.0, r_u=rand(), cat=torch.clamp(cat, max=GRID * GRID - 1),
                      r_g=rand())


# float32 constants on a device, made on first use: (value or name, device) -> tensor
_CONSTANTS: dict = {}


def _constant(key, device: torch.device) -> torch.Tensor:
    """A bound (a float) as a float32 scalar, or the grid's "yaw" or "pitch"
    samples, on `device`: made on the first call for a key and device, then
    the same tensor (a sampler copies nothing from the host)."""
    got = _CONSTANTS.get((key, device))
    if got is None:
        value = {"yaw": YAW_SAMPLES, "pitch": PITCH_SAMPLES}[key] if isinstance(key, str) else key
        got = _CONSTANTS[(key, device)] = torch.as_tensor(value, dtype=torch.float32,
                                                          device=device)
    return got


def _uniform(unit: torch.Tensor, lo, hi) -> torch.Tensor:
    """A unit draw scaled to [lo, hi) the way jax.random.uniform scales its
    bits; a bound given as a float is its float32 scalar."""
    lo, hi = (x if isinstance(x, torch.Tensor) else _constant(float(x), unit.device)
              for x in (lo, hi))
    return torch.maximum(lo, unit * (hi - lo) + lo)


def sample_step_params(cur: CurriculumState, draws: StoneDraws):
    """(r, yaw, pitch, x_tilt, y_tilt), each (B, K). Uniform mode scales the
    ranges by level/5; grid mode draws (yaw, pitch) from the installed
    11 x 11 categorical."""
    s = level_scale(cur.level)[:, None]
    yaw_u = draws.u[..., 0] * YAW_MAX * s
    pitch_u = draws.u[..., 1] * PITCH_MAX * s
    xt_u = draws.u[..., 2] * TILT_MAX * s
    yt_u = draws.u[..., 3] * TILT_MAX * s
    r_u = _uniform(draws.r_u, R_MIN, R_MIN + (R_MAX - R_MIN) * s)

    dev = draws.cat.device
    yaw_g = _constant("yaw", dev)[draws.cat // GRID]
    pitch_g = _constant("pitch", dev)[draws.cat % GRID]
    r_g = _uniform(draws.r_g, R_MIN, R_MAX)

    use = cur.use_prob[:, None]
    return (
        torch.where(use, r_g, r_u),
        torch.where(use, yaw_g, yaw_u),
        torch.where(use, pitch_g, pitch_u),
        torch.where(use, xt_u * 0.0, xt_u),
        torch.where(use, yt_u * 0.0, yt_u),
    )


def next_stone(prev: torch.Tensor, r, yaw, pitch, x_tilt, y_tilt) -> torch.Tensor:
    """Place a stone relative to `prev` (..., 6): horizontal reach
    r cos(pitch), drop r sin(pitch), heading prev_phi + yaw."""
    heading = prev[..., 3] + yaw
    dist_h = r * torch.cos(pitch)
    dz = -r * torch.sin(pitch)
    x = prev[..., 0] + dist_h * torch.cos(heading)
    y = prev[..., 1] + dist_h * torch.sin(heading)
    z = prev[..., 2] + dz
    return torch.stack([x, y, z, heading, x_tilt, y_tilt], dim=-1)


def generate_terrain(cur: CurriculumState, n_stones: int, draws: StoneDraws) -> torch.Tensor:
    """Full terrain at reset: (B, n_stones, 6). Stone 0 sits under the
    character, stone 1 is flat at INIT_STEP_SEPARATION ahead, and each later
    stone is placed from the one before (draws: (B, n_stones - 2)); the
    chain of placements is a running sum over the stone axis."""
    r, yaw, pitch, xt, yt = sample_step_params(cur, draws)
    B, dev = r.shape[0], r.device
    heading = torch.cumsum(yaw, dim=1)
    dist_h = r * torch.cos(pitch)

    def chain(start, steps):
        first = torch.full((B, 1), start, dtype=torch.float32, device=dev)
        return torch.cumsum(torch.cat([first, steps], dim=1), dim=1)[:, 1:]

    rest = torch.stack([
        chain(INIT_STEP_SEPARATION, dist_h * torch.cos(heading)),
        chain(0.0, dist_h * torch.sin(heading)),
        chain(0.0, -r * torch.sin(pitch)),
        heading, xt, yt,
    ], dim=-1)
    start = torch.zeros((B, 2, 6), dtype=torch.float32, device=dev)
    start[:, 1, 0] = INIT_STEP_SEPARATION
    return torch.cat([start, rest], dim=1)


def resample_stone(terrain: torch.Tensor, index: torch.Tensor, cur: CurriculumState,
                   draws: StoneDraws) -> torch.Tensor:
    """Re-place stone `index` (B,) relative to the stone before it (draws:
    (B, 1)), where 2 <= index < n_stones; other envs keep their terrain."""
    B, n = terrain.shape[0], terrain.shape[1]
    rows = torch.arange(B, device=terrain.device)
    prev = terrain[rows, torch.clamp(index - 1, 0, n - 1)]
    stone = next_stone(prev, *(x[:, 0] for x in sample_step_params(cur, draws)))
    out = terrain.clone()
    out[rows, torch.clamp(index, 0, n - 1)] = stone
    do = (index >= 2) & (index < n)
    return torch.where(do[:, None, None], out, terrain)


def candidate_stones(terrain: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """All GRID * GRID candidate placements of stone `index` (B,) over the
    (yaw, pitch) grid at mid spacing, flat, relative to the stone before
    it: the geometry behind `create_temp_states`. (B, GRID * GRID, 6)."""
    B, n, dev = terrain.shape[0], terrain.shape[1], terrain.device
    prev = terrain[torch.arange(B, device=dev), torch.clamp(index - 1, 0, n - 1)]
    yy, pp = torch.meshgrid(_constant("yaw", dev), _constant("pitch", dev), indexing="ij")
    yaw = yy.reshape(-1).expand(B, -1)
    flat = torch.zeros_like(yaw)
    return next_stone(prev[:, None], (R_MIN + R_MAX) * 0.5, yaw, pp.reshape(-1), flat, flat)
