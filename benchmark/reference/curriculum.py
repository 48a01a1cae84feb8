"""The value-based curriculum, plain: the candidate stones and their
observations, the value grid over an eval fleet, threshold sampling's
probabilities, its uniform full-range round and the install of a grid on
a fleet's curriculum (the plain counterpart of the port's
`runtime/curriculum.py` and `envs/stepper.py` `create_temp_states`).

Float32, TF32 off (set here, on import); a caller that wants TF32 sets
the flags around its calls.

Departures from the ALLSTEPS trainer (`train.py:224-273`), the same as
the port's and the JAX package's (`runtime/curriculum.py`):
- the grid is scored over an eval fleet of `n_envs` envs (16) for a fixed
  number of control steps (160), every env's rows summed on each step in
  which it moved to a new stone; the trainer stepped one env until 5 hit
  events;
- the fleet is reset at level 0 from given draws and acts with the
  policy's mean action;
- the probabilities are softmax(-scale x |grid - threshold|) at the
  configuration's `sampling_scale` (150), where the trainer's active code
  hard-coded 10.
"""

from __future__ import annotations

import torch

from . import stepper as st
from . import terrain as terr

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CELLS = terr.GRID * terr.GRID


def candidate_stones(terrain: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """All GRID x GRID candidate placements of stone `index` (B,) over the
    (yaw, pitch) grid at mid spacing, relative to the stone before it,
    flat and flat-tilted: (B, GRID * GRID, 6)."""
    B, n, dev = terrain.shape[0], terrain.shape[1], terrain.device
    prev = terrain[torch.arange(B, device=dev), torch.clamp(index - 1, 0, n - 1)]
    yy, pp = torch.meshgrid(torch.as_tensor(terr.YAW_SAMPLES, device=dev),
                            torch.as_tensor(terr.PITCH_SAMPLES, device=dev), indexing="ij")
    yaw = yy.reshape(-1).expand(B, -1)
    flat = torch.zeros_like(yaw)
    return terr.next_stone(prev[:, None], (terr.R_MIN + terr.R_MAX) * 0.5, yaw, pp.reshape(-1),
                           flat, flat)


def _repeat(x, k: int):
    if isinstance(x, tuple):
        return type(x)(*(_repeat(y, k) for y in x))
    return x.repeat_interleave(k, dim=0)


def candidate_observations(cfg: st.StepperConfig, state: st.EnvState) -> torch.Tensor:
    """(B, GRID * GRID, obs_dim): the observation of each env with each
    candidate swapped in for its next-next stone (unmirrored)."""
    B, n = state.terrain.shape[:2]
    idx = torch.clamp(state.next_step_index + 1, 0, cfg.n_stones - 1)
    cands = candidate_stones(state.terrain, idx)
    at = (torch.arange(n, device=idx.device) == idx[:, None])[:, None, :, None]
    terrain = torch.where(at, cands[:, :, None, :], state.terrain[:, None])
    obs = st.observe_with_terrain(cfg, _repeat(state, CELLS), terrain.reshape(B * CELLS, n, 6))
    return obs.reshape(B, CELLS, -1)


@torch.no_grad()
def grid_from_states(env, policy, states: list) -> tuple:
    """The value grid's sums over a fleet's states after each control step
    (`states`, one EnvState per step): on each step the ensemble-mean value
    of every candidate observation, summed over the envs that moved to a
    new stone that step, added step by step. Returns (grid (CELLS,) before
    normalization, events (a 0-dim long tensor))."""
    dev = states[0].terrain.device
    grid = torch.zeros(CELLS, device=dev)
    count = torch.zeros((), dtype=torch.long, device=dev)
    for s in states:
        vals = policy.ensemble_values(candidate_observations(env.cfg, s)).mean(dim=-1)
        event = s.update_terrain
        grid = grid + torch.where(event[:, None], vals, 0.0).sum(dim=0)
        count = count + event.sum()
    return grid, count


def normalize(grid: torch.Tensor) -> torch.Tensor:
    """grid / (max |grid| + 1e-8), as (GRID, GRID)."""
    return (grid / (grid.abs().max() + 1e-8)).reshape(terr.GRID, terr.GRID)


@torch.no_grad()
def value_grid(env, policy, n_envs: int, reset_draws, step_draws: list) -> tuple:
    """The value grid of a fresh eval fleet of `n_envs` envs at level 0,
    free-running on the mean action over `len(step_draws)` control steps:
    (normalized grid (GRID, GRID), events, the states after each step)."""
    dev = reset_draws.noise.device
    cur = terr.default_curriculum(0, batch=n_envs, device=dev)
    state, obs = env.reset(cur, draws=reset_draws)
    states = []
    for d in step_draws:
        state, out = env.step(state, policy.action_mean(obs), draws=d)
        states.append(state)
        obs = out.obs
    grid, count = grid_from_states(env, policy, states)
    return normalize(grid), count, states


def threshold_probs(grid: torch.Tensor, scale: float, threshold: float) -> torch.Tensor:
    """softmax(-scale x |grid - threshold|) over the cells, (GRID, GRID)."""
    return torch.softmax(-scale * torch.abs(grid.reshape(-1) - threshold),
                         dim=0).reshape(grid.shape)


def uniform_round(cur: terr.CurriculumState, assist: float) -> terr.CurriculumState:
    """Threshold sampling's uniform round: every env at the top level,
    sampling off, the assist ladder's `assist` (the grid kept)."""
    return cur._replace(level=torch.full_like(cur.level, terr.N_LEVELS - 1),
                        use_prob=torch.zeros_like(cur.use_prob),
                        assist=torch.full_like(cur.assist, assist))


def install(cur: terr.CurriculumState, probs: torch.Tensor) -> terr.CurriculumState:
    """`probs` (GRID, GRID) normalized by its sum (+1e-12) on every env,
    sampling on."""
    probs = probs / (probs.sum() + 1e-12)
    return cur._replace(sample_prob=probs.expand_as(cur.sample_prob).clone(),
                        use_prob=torch.ones_like(cur.use_prob))
