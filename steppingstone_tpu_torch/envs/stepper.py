"""Stepping-stone environments, Walker3D and Mike (torque) and Cassie
(stable PD) (port of steppingstone_tpu/envs/stepper.py).

- Walker3D and Mike obs 60 / action 21: [height above the lowest foot,
  heading-frame velocity (3), roll, pitch] + 21 limit-normalized joint
  angles + 21 joint speeds * 0.1 + 2 foot contacts + 2 lookahead stones x
  (sin(a) d, cos(a) d, dz, x_tilt, y_tilt)
- Cassie obs 51 / action 10: [height, sin/cos of the bearing to the next
  stone] + heading-frame velocity (3) + roll, pitch + body rates (3) + 14
  joint angles + 14 joint speeds * 0.1 + 2 foot contacts + the gait clock
  (sin, cos) + 2 lookahead stones x (sin(a) d, cos(a) d, dz, x_tilt); the
  action sets PD targets held over the control step, and stable PD runs
  inside each substep
- support: shrinking discs, pillars, or planks (`plank_class` Plank /
  LargePlank, a box of half-width `plank_hy` across the walking direction)
- reward = progress potential + step bonus 50 exp(-d / 0.25) + target
  bonus + tall bonus (+2/-1) - electricity, stall-torque, joint-limit and
  posture penalties
- an episode ends on a fall (height below termination, non-finite state),
  a stall (no new stone hit for `stall_timeout` steps away from the goal)
  or the time limit; `step` resets ended envs itself
- mirror: with mirroring enabled, unclocked envs (Walker3D) observe and act
  in mirrored coordinates in alternate episodes (drawn at reset), clocked
  envs (Cassie) in the second half of every gait cycle

Batched over envs: every `EnvState` field has a leading axis B. Reset and
step take their random draws as `ResetDraws` / `EnvStepDraws`, made from a
`torch.Generator` when not given.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from steppingstone_tpu_torch.core import quaternion as qt
from steppingstone_tpu_torch.device import resolve_device
from steppingstone_tpu_torch.envs import terrain as terr
from steppingstone_tpu_torch.parallel.mesh import SINGLE, Mesh
from steppingstone_tpu_torch.physics import engine
from steppingstone_tpu_torch.physics import kinematics as km
from steppingstone_tpu_torch.physics.contact import ContactParams
from steppingstone_tpu_torch.physics.engine import PhysicsState
from steppingstone_tpu_torch.physics.model import RobotModel, tensor
from steppingstone_tpu_torch.physics.robots import cassie as cassie_mod
from steppingstone_tpu_torch.physics.robots import walker3d as walker_mod
from steppingstone_tpu_torch.tracing import span

CONTROL_DT = engine.SIM_DT * engine.SUBSTEPS  # 60 Hz


class EnvState(NamedTuple):
    phys: PhysicsState
    terrain: torch.Tensor          # (B, NS, 6)
    next_step_index: torch.Tensor  # (B,) long
    elapsed: torch.Tensor          # (B,) long
    prev_dist: torch.Tensor        # (B,) horizontal distance to the walk target
    cur: terr.CurriculumState
    ep_return: torch.Tensor        # (B,) running episode return
    update_terrain: torch.Tensor   # (B,) bool
    foot_contact: torch.Tensor     # (B, 2) bool from the last control step
    foot_xyz: torch.Tensor         # (B, 2, 3) foot link origins (world)
    phase: torch.Tensor            # (B,) gait clock in [0, 1) (clocked envs)
    last_hit: torch.Tensor         # (B,) long elapsed at the last stone hit
    mirror_enabled: torch.Tensor   # (B,) bool
    mirror_episode: torch.Tensor   # (B,) bool: this episode runs mirrored
    robot_power: torch.Tensor      # (B,) torque scale (PD: scales torque and gains)
    stone_radius: torch.Tensor     # (B,) disc radius


class StepOut(NamedTuple):
    obs: torch.Tensor        # (B, obs_dim)
    reward: torch.Tensor     # (B,)
    done: torch.Tensor       # (B,) episode ended this step
    timeout: torch.Tensor    # (B,) ended only because of the time limit
    ep_return: torch.Tensor  # (B,) final return of the episode that ended (else 0)
    ep_len: torch.Tensor     # (B,) final length of the episode that ended (else 0)
    hit: torch.Tensor        # (B,) advanced to a new stone this step


class ResetDraws(NamedTuple):
    stones: terr.StoneDraws  # (B, NS - 2) terrain placements
    noise: torch.Tensor      # (B, 2 NJ + 3) standard normals: pose, joint and root velocity
    mirror: torch.Tensor     # (B,) bool: the episode runs mirrored


class EnvStepDraws(NamedTuple):
    resample: terr.StoneDraws  # (B, 1) placement of the next-next stone on a hit
    reset: ResetDraws          # for envs whose episode ends this step


@dataclasses.dataclass(frozen=True, eq=False)
class StepperConfig:
    """Static env description (see the JAX StepperConfig for the reasons
    behind the stall timeout, the running start and the support modes)."""

    name: str
    model: RobotModel
    actuation: str              # "torque" | "pd"
    obs_dim: int
    n_stones: int = 20
    stone_radius: float = 0.25
    max_episode_steps: int = 1000
    lookahead: int = 2
    termination_height: float = 0.7
    step_bonus: float = 50.0
    step_bonus_scale: float = 0.25
    target_bonus: float = 2.0
    tall_bonus: float = 2.0
    stall_timeout: int = 180
    electricity_cost: float = 4.5
    stall_torque_cost: float = 0.225
    joints_at_limit_cost: float = 0.1
    clock_period: int = 0       # control steps per gait cycle (0 = no clock obs)
    contact: ContactParams = ContactParams()
    reset_noise: float = 0.05
    init_forward_speed: float = 1.2
    # "disc": contact radius stone_radius + radius_extra at assist level 0,
    # shrinking to stone_radius at level 5; "pillar": stone_radius always;
    # "plank": a box of that half-length along the stone's heading and
    # plank_hy across it
    support: str = "disc"
    plank_hy: float = 1.5
    radius_extra: float = 0.35

    @property
    def action_dim(self) -> int:
        return self.model.action_dim


# ----------------------------------------------------------------------
# observation
# ----------------------------------------------------------------------

def _norm_angles(model: RobotModel, qj: torch.Tensor) -> torch.Tensor:
    """Joint angles normalized to [-1, 1] by the position limits."""
    lo = tensor(model, "joint_lower", qj.device)
    hi = tensor(model, "joint_upper", qj.device)
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    return (qj - mid) / half


def _rows(terrain: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """terrain[b, idx[b, ...]] for a (B, ...) index."""
    b = torch.arange(terrain.shape[0], device=terrain.device)
    return terrain[b.view((-1,) + (1,) * (idx.dim() - 1)), idx]


def observe(cfg: StepperConfig, state: EnvState) -> torch.Tensor:
    return observe_with_terrain(cfg, state, state.terrain)


def observe_with_terrain(cfg: StepperConfig, state: EnvState, terrain: torch.Tensor) -> torch.Tensor:
    """(B, obs_dim) observation, optionally for another terrain: the
    Walker layout (60), or the clocked Cassie layout (51)."""
    q, qd = state.phys.q, state.phys.qd
    root_pos, quat, qj = q[:, 0:3], q[:, 3:7], q[:, 7:]
    vel = qd[:, 3:6]
    yaw, pitch, roll = qt.to_euler_zyx(quat)
    ch, sh = torch.cos(yaw), torch.sin(yaw)
    height = root_pos[:, 2] - state.foot_xyz[:, :, 2].min(dim=1).values
    v_head = torch.stack([ch * vel[:, 0] + sh * vel[:, 1],
                          -sh * vel[:, 0] + ch * vel[:, 1], vel[:, 2]], dim=1)

    steps = torch.arange(cfg.lookahead, device=q.device)
    rows = _rows(terrain, torch.clamp(state.next_step_index[:, None] + steps, 0, cfg.n_stones - 1))
    deltas = rows[..., 0:3] - root_pos[:, None]
    a = torch.atan2(deltas[..., 1], deltas[..., 0]) - yaw[:, None]
    d = torch.sqrt(deltas[..., 0] * deltas[..., 0] + deltas[..., 1] * deltas[..., 1] + 1e-12)
    tgt = torch.stack([torch.sin(a) * d, torch.cos(a) * d, deltas[..., 2],
                       rows[..., 4], rows[..., 5]], dim=-1)
    B = q.shape[0]
    if cfg.clock_period:
        # bearing to the next stone, body rates and the gait clock
        bearing = torch.atan2(deltas[:, 0, 1], deltas[:, 0, 0]) - yaw
        ang = 2 * torch.pi * state.phase
        obs = torch.cat([
            torch.stack([height, torch.sin(bearing), torch.cos(bearing)], dim=1),
            v_head, torch.stack([roll, pitch], dim=1), qt.rotate_inv(quat, qd[:, 0:3]),
            qj, qd[:, 6:] * 0.1, state.foot_contact.to(q.dtype),
            torch.stack([torch.sin(ang), torch.cos(ang)], dim=1),
            tgt[..., :4].reshape(B, -1)], dim=1)
    else:
        obs = torch.cat([height[:, None], v_head, torch.stack([roll, pitch], dim=1),
                         _norm_angles(cfg.model, qj), qd[:, 6:] * 0.1,
                         state.foot_contact.to(q.dtype), tgt.reshape(B, -1)], dim=1)
    if obs.shape[1] != cfg.obs_dim:
        raise ValueError(f"obs dim {obs.shape[1]} != {cfg.obs_dim}")
    return obs


def _repeat(x, k: int):
    """Each env's row of a (nested) NamedTuple of (B, ...) tensors
    repeated k times in a row: (B * k, ...)."""
    if isinstance(x, tuple):
        return type(x)(*(_repeat(y, k) for y in x))
    return x.repeat_interleave(k, dim=0)


def create_temp_states(cfg: StepperConfig, state: EnvState) -> torch.Tensor:
    """(B, GRID * GRID, obs_dim) hypothetical observations, one per
    candidate placement of the next-next stone over the (yaw, pitch) grid:
    each candidate swapped into a copy of the env's terrain, all B * 121
    observed in one batch."""
    B, n = state.terrain.shape[:2]
    cand_idx = torch.clamp(state.next_step_index + 1, 0, cfg.n_stones - 1)
    cands = terr.candidate_stones(state.terrain, cand_idx)             # (B, G, 6)
    G = cands.shape[1]
    at = (torch.arange(n, device=cand_idx.device) == cand_idx[:, None])[:, None, :, None]
    terrain = torch.where(at, cands[:, :, None, :], state.terrain[:, None])  # (B, G, n, 6)
    obs = observe_with_terrain(cfg, _repeat(state, G), terrain.reshape(B * G, n, 6))
    return obs.reshape(B, G, -1)


def get_temp_state(cfg: StepperConfig, state: EnvState) -> torch.Tensor:
    """The observation of the current terrain, (B, obs_dim)."""
    return observe(cfg, state)


def _mirror_active(cfg: StepperConfig, state: EnvState) -> torch.Tensor:
    """Clocked envs mirror in the second half of the gait cycle; unclocked
    envs in the episodes drawn at reset."""
    if cfg.clock_period:
        return state.mirror_enabled & (state.phase >= 0.5)
    return state.mirror_enabled & state.mirror_episode


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------

def _foot_bodies(model: RobotModel) -> tuple:
    right = int(model.contact_body[np.argmax(model.foot_of_contact == 0)])
    left = int(model.contact_body[np.argmax(model.foot_of_contact == 1)])
    return right, left


def _foot_xyz(model: RobotModel, q: torch.Tensor, feet: torch.Tensor) -> torch.Tensor:
    """(B, 2, 3) world foot link origins; `feet` holds `_foot_bodies` on q's device."""
    return km.forward_kinematics(model, q).pos[:, feet]


def _broadcast(value, like: torch.Tensor) -> torch.Tensor:
    """`value` (a scalar or one per env) as a float32 tensor shaped `like`."""
    v = torch.as_tensor(value, dtype=torch.float32, device=like.device)
    return torch.broadcast_to(v, like.shape).clone()


def _where(cond: torch.Tensor, a, b):
    """Per-env select over (nested) NamedTuples of (B, ...) tensors."""
    if isinstance(a, tuple):
        return type(a)(*(_where(cond, x, y) for x, y in zip(a, b)))
    return torch.where(cond.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def env_state_from_numpy(src, device="cpu") -> EnvState:
    """Build an EnvState from numpy arrays: `src` is a (nested) mapping or
    object with the EnvState field names, e.g. a JAX EnvState whose leaves
    were converted with np.asarray. Fields the port does not keep (the
    JAX random key) are ignored."""

    def get(obj, name):
        return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)

    def t(x):
        x = np.array(x)  # a writable copy
        if x.dtype == np.bool_:
            return torch.as_tensor(x, device=device)
        if x.dtype.kind in "iu":
            return torch.as_tensor(x, dtype=torch.long, device=device)
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    phys, cur = get(src, "phys"), get(src, "cur")
    return EnvState(
        phys=PhysicsState(q=t(get(phys, "q")), qd=t(get(phys, "qd"))),
        cur=terr.CurriculumState(*(t(get(cur, f)) for f in terr.CurriculumState._fields)),
        **{f: t(get(src, f)) for f in EnvState._fields if f not in ("phys", "cur")},
    )


# ----------------------------------------------------------------------
# the env
# ----------------------------------------------------------------------

class StepperEnv:
    """Static config plus batched reset/step on one device."""

    def __init__(self, cfg: StepperConfig, device=None):
        if cfg.actuation not in ("torque", "pd"):
            raise ValueError(f"unknown actuation {cfg.actuation!r}")
        if cfg.support not in ("disc", "pillar", "plank"):
            raise ValueError(f"unknown support mode {cfg.support!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        model = cfg.model
        # initial pose: the model's pose, for torque robots plus the mocca
        # "running_start" offsets
        base = engine.default_state(model).q[0]
        off = np.zeros(model.njoints, dtype=np.float32)
        if cfg.actuation == "torque":
            for jn, v in walker_mod.RUNNING_START.items():
                off[list(model.joint_names).index(jn)] = v
        self._q0j = (base[7:] + torch.as_tensor(off)).to(self.device)
        self._quat0 = base[3:7].to(self.device)
        kin = km.forward_kinematics(model, base[None])
        low = torch.min(km.contact_points(model, kin)[0, :, 2]
                        - torch.as_tensor(model.contact_radius))
        self.standing_height = float(base[2] - low)
        # constants a reset or step reads, on the device once (a step copies
        # nothing from the host)
        self._feet = torch.as_tensor(_foot_bodies(model), device=self.device)
        self._root0 = torch.tensor([0.3, 0.0, self.standing_height + 0.015], device=self.device)
        # mirror transforms (sign, permutation) for obs and action
        neg_o, r_o, l_o, neg_a, r_a, l_a = self.get_mirror_indices()

        def tables(n, neg, right, left):
            sign = np.ones(n, dtype=np.float32)
            sign[neg] = -1.0
            perm = np.arange(n)
            perm[np.concatenate([right, left])] = perm[np.concatenate([left, right])]
            return (torch.as_tensor(sign, device=self.device),
                    torch.as_tensor(perm, device=self.device))

        self.mirror_sign_obs, self.mirror_perm_obs = tables(cfg.obs_dim, neg_o, r_o, l_o)
        self.mirror_sign_act, self.mirror_perm_act = tables(cfg.action_dim, neg_a, r_a, l_a)

    def _mirror_obs(self, obs):
        return obs[..., self.mirror_perm_obs] * self.mirror_sign_obs

    def _mirror_act(self, act):
        return act[..., self.mirror_perm_act] * self.mirror_sign_act

    @property
    def observation_dim(self) -> int:
        return self.cfg.obs_dim

    @property
    def action_dim(self) -> int:
        return self.cfg.action_dim

    @property
    def yaw_samples(self) -> np.ndarray:
        return terr.YAW_SAMPLES

    @property
    def pitch_samples(self) -> np.ndarray:
        return terr.PITCH_SAMPLES

    @property
    def r_samples(self) -> np.ndarray:
        return terr.R_SAMPLES

    # -- randomness ---------------------------------------------------------
    def draw_reset(self, cur: terr.CurriculumState, generator=None,
                   mesh: Mesh = SINGLE) -> ResetDraws:
        """Reset draws for the envs of `cur`: with `mesh`, this rank's rows
        of draws made at the global batch."""
        B = mesh.world * cur.level.shape[0]
        return ResetDraws(
            stones=terr.draw_stones(cur, self.cfg.n_stones - 2, generator, mesh),
            noise=mesh.local(torch.randn((B, 2 * self.cfg.model.njoints + 3),
                                         generator=generator, device=self.device)),
            mirror=mesh.local(torch.rand((B,), generator=generator, device=self.device)) < 0.5,
        )

    def draw_step(self, cur: terr.CurriculumState, generator=None,
                  mesh: Mesh = SINGLE) -> EnvStepDraws:
        return EnvStepDraws(resample=terr.draw_stones(cur, 1, generator, mesh),
                            reset=self.draw_reset(cur, generator, mesh))

    # -- reset / step -------------------------------------------------------
    def reset(self, cur: terr.CurriculumState, mirror_enabled=None, generator=None,
              draws: ResetDraws | None = None):
        """Fresh episodes for a batch of envs with curriculum `cur` (B,)."""
        cfg, model, dev = self.cfg, self.cfg.model, self.device
        B, nj = cur.level.shape[0], model.njoints
        if mirror_enabled is None:
            mirror_enabled = torch.zeros((B,), dtype=torch.bool, device=dev)
        if draws is None:
            draws = self.draw_reset(cur, generator)
        terrain = terr.generate_terrain(cur, cfg.n_stones, draws.stones)

        noise = cfg.reset_noise * draws.noise
        lo = tensor(model, "joint_lower", dev)
        hi = tensor(model, "joint_upper", dev)
        qj = torch.clamp(self._q0j + noise[:, :nj], lo + 0.01, hi - 0.01)
        q = torch.cat([self._root0.expand(B, 3), self._quat0.expand(B, 4), qj], dim=1)
        qd = torch.zeros((B, model.ndof), device=dev)
        qd[:, 6:] = 0.1 * noise[:, nj:2 * nj]
        qd[:, 3:5] = 0.1 * noise[:, 2 * nj:2 * nj + 2]
        qd[:, 3] += cfg.init_forward_speed

        zeros = torch.zeros((B,), device=dev)
        izeros = torch.zeros((B,), dtype=torch.long, device=dev)
        state = EnvState(
            phys=PhysicsState(q=q, qd=qd),
            terrain=terrain,
            next_step_index=izeros + 1,
            elapsed=izeros,
            prev_dist=zeros,
            cur=cur,
            ep_return=zeros,
            update_terrain=torch.zeros((B,), dtype=torch.bool, device=dev),
            foot_contact=torch.zeros((B, 2), dtype=torch.bool, device=dev),
            foot_xyz=_foot_xyz(model, q, self._feet),
            phase=zeros,
            last_hit=izeros,
            mirror_enabled=mirror_enabled,
            mirror_episode=draws.mirror,
            robot_power=zeros + 1.0,
            stone_radius=zeros + cfg.stone_radius,
        )
        state = state._replace(prev_dist=self._target_dist(state))
        obs = observe(cfg, state)
        obs = torch.where(_mirror_active(cfg, state)[:, None], self._mirror_obs(obs), obs)
        return state, obs

    def _walk_target(self, terrain, ns):
        """The potential target: the last of the lookahead stones."""
        cfg = self.cfg
        return _rows(terrain, torch.clamp(ns + cfg.lookahead - 1, 0, cfg.n_stones - 1))

    def _target_dist(self, state: EnvState) -> torch.Tensor:
        d = self._walk_target(state.terrain, state.next_step_index)[:, :2] - state.phys.q[:, 0:2]
        return torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + 1e-12)

    def step(self, state: EnvState, action: torch.Tensor, generator=None,
             draws: EnvStepDraws | None = None):
        cfg, model = self.cfg, self.cfg.model
        last = cfg.n_stones - 1
        if draws is None:
            draws = self.draw_step(state.cur, generator)
        # the policy acts in mirrored coordinates while mirroring is active
        action = torch.where(_mirror_active(cfg, state)[:, None], self._mirror_act(action), action)
        r_eff, hy = state.stone_radius, None
        if cfg.support != "pillar":
            # shrinking support assist, keyed on cur.assist
            r_eff = state.stone_radius + cfg.radius_extra * (
                1.0 - terr.level_scale(state.cur.assist))
        if cfg.support == "plank":
            hy = cfg.plank_hy
        if cfg.actuation == "pd":
            # stable PD: the target is held over the control step, the
            # torque re-evaluated every substep with kp and kd implicit
            phys, info = engine.step(
                model, state.phys, torch.zeros(model.njoints, device=self.device),
                state.terrain, r_eff, False, cfg.contact,
                pd_target=engine.pd_target_from_action(model, action),
                pd_power=state.robot_power, support_hy=hy)
        else:
            tau = engine.torque_actuation(model, action) * state.robot_power[:, None]
            phys, info = engine.step(model, state.phys, tau, state.terrain, r_eff,
                                     False, cfg.contact, support_hy=hy)
        foot_xyz = _foot_xyz(model, phys.q, self._feet)

        # ---- step-hit detection & terrain resampling -------------------------
        ns = state.next_step_index
        hit = ((info.foot_stone == ns[:, None]) & info.foot_contact).any(dim=1)
        ns_new = torch.where(hit, torch.clamp(ns + 1, max=last), ns)
        fd = foot_xyz[:, :, :2] - _rows(state.terrain, torch.clamp(ns, max=last))[:, None, :2]
        foot_dist = torch.sqrt(torch.sum(fd * fd, dim=2) + 1e-12).min(dim=1).values
        terrain = torch.where(
            hit[:, None, None],
            terr.resample_stone(state.terrain, ns_new + 1, state.cur, draws.resample),
            state.terrain,
        )
        phase = state.phase
        if cfg.clock_period > 0:
            phase = (phase + 1.0 / cfg.clock_period) % 1.0
        mid = state._replace(phys=phys, terrain=terrain, next_step_index=ns_new,
                             foot_contact=info.foot_contact, foot_xyz=foot_xyz, phase=phase)

        # ---- reward --------------------------------------------------------
        # progress toward the OLD walk target, then re-anchor the potential
        d_old = self._walk_target(state.terrain, ns)[:, :2] - phys.q[:, 0:2]
        dist_old = torch.sqrt(d_old[:, 0] * d_old[:, 0] + d_old[:, 1] * d_old[:, 1] + 1e-12)
        progress = (state.prev_dist - dist_old) / CONTROL_DT
        new_dist = self._target_dist(mid)

        height = phys.q[:, 2] - foot_xyz[:, :, 2].min(dim=1).values
        tall = height > cfg.termination_height
        tall_bonus = torch.where(tall, cfg.tall_bonus, -1.0)

        _, pitch, roll = qt.to_euler_zyx(phys.q[:, 3:7])
        posture = (
            torch.where((pitch < -0.2) | (pitch > 0.4), torch.abs(pitch), 0.0)
            + torch.where((roll < -0.4) | (roll > 0.4), torch.abs(roll), 0.0)
        )

        a = torch.clamp(action, -1.0, 1.0)
        speeds = 0.1 * phys.qd[:, 6:]
        idx = tensor(model, "actuated_idx", a.device, torch.long)
        electricity = cfg.electricity_cost * torch.mean(torch.abs(a * speeds[:, idx]), dim=1)
        stall = cfg.stall_torque_cost * torch.mean(a * a, dim=1)
        at_limit = torch.abs(_norm_angles(model, phys.q[:, 7:])) > 0.99
        joints_pen = cfg.joints_at_limit_cost * torch.sum(at_limit.to(torch.float32), dim=1)

        # step bonus on the contact frame, except once the new index is the last stone
        step_bonus = torch.where(
            hit & (ns_new != last),
            cfg.step_bonus * torch.exp(-foot_dist / cfg.step_bonus_scale), 0.0)
        at_goal = (ns_new == last) & (new_dist < 0.15)
        target_bonus = torch.where(at_goal, cfg.target_bonus, 0.0)
        reward = (progress + step_bonus + target_bonus + tall_bonus
                  - electricity - stall - joints_pen - posture)

        # ---- termination -------------------------------------------------------
        # per-env NaN firewall: a non-finite state ends the episode and its
        # reward is squashed
        finite = (torch.isfinite(phys.q).all(dim=1) & torch.isfinite(phys.qd).all(dim=1)
                  & torch.isfinite(reward))
        reward = torch.where(finite, reward, 0.0)
        elapsed = state.elapsed + 1
        timeout = elapsed >= cfg.max_episode_steps
        last_hit = torch.where(hit, elapsed, state.last_hit)
        stalled = torch.zeros_like(hit)
        if cfg.stall_timeout > 0:
            stalled = (elapsed - last_hit >= cfg.stall_timeout) & ~at_goal
        fall = ~tall | ~finite | stalled
        done = fall | timeout
        ep_return = state.ep_return + reward
        mid = mid._replace(elapsed=elapsed, prev_dist=new_dist, ep_return=ep_return,
                           update_terrain=hit, last_hit=last_hit)

        # ---- auto-reset ------------------------------------------------------
        with span("env.reset"):
            reset_state, reset_obs = self.reset(state.cur, state.mirror_enabled,
                                                draws=draws.reset)
        out_state = _where(done, reset_state, mid)
        # injected params persist across auto-resets
        out_state = out_state._replace(robot_power=mid.robot_power,
                                       stone_radius=mid.stone_radius)
        cont_obs = observe(cfg, mid)
        cont_obs = torch.where(_mirror_active(cfg, mid)[:, None], self._mirror_obs(cont_obs),
                               cont_obs)
        obs = torch.where(done[:, None], reset_obs, cont_obs)
        return out_state, StepOut(
            obs=obs,
            reward=reward,
            done=done,
            timeout=timeout & ~fall,
            ep_return=torch.where(done, ep_return, 0.0),
            ep_len=torch.where(done, elapsed, 0),
            hit=hit & (ns_new != ns),
        )

    # ---- curriculum and mirror fan-outs ---------------------------------------
    def set_env_params(self, state: EnvState, params: dict) -> EnvState:
        """Env-param injection; supported keys: stone_radius (a scalar or
        one value per env)."""
        if "stone_radius" in params:
            state = state._replace(stone_radius=_broadcast(params["stone_radius"],
                                                           state.stone_radius))
        return state

    def set_robot_params(self, state: EnvState, params: dict) -> EnvState:
        """Robot-param injection; supported keys: power (the torque scale,
        a scalar or one value per env)."""
        if "power" in params:
            state = state._replace(robot_power=_broadcast(params["power"], state.robot_power))
        return state

    def set_mirror(self, state: EnvState, enabled: bool) -> EnvState:
        return state._replace(mirror_enabled=torch.full_like(state.mirror_enabled, enabled))

    def update_curriculum(self, state: EnvState, level, assist=None) -> EnvState:
        """assist=None ties the support assist to the level."""
        cur = state.cur._replace(
            level=torch.full_like(state.cur.level, level),
            use_prob=torch.zeros_like(state.cur.use_prob),
            assist=torch.full_like(state.cur.assist, level if assist is None else assist),
        )
        return state._replace(cur=cur)

    def update_assist(self, state: EnvState, assist) -> EnvState:
        """Set only the support-geometry assist level."""
        return state._replace(cur=state.cur._replace(
            assist=torch.full_like(state.cur.assist, assist)))

    def update_specialist(self, state: EnvState, k) -> EnvState:
        """Restrict stone sampling to difficulty band k (the specialist
        curriculum): the band's uniform grid distribution, grid mode on."""
        prob = terr.specialist_band_prob(k, state.cur.sample_prob.device)
        return state._replace(cur=state.cur._replace(
            sample_prob=prob.expand_as(state.cur.sample_prob).clone(),
            use_prob=torch.ones_like(state.cur.use_prob)))

    def update_sample_prob(self, state: EnvState, prob) -> EnvState:
        """Install a (GRID, GRID) grid, or one per env, each normalized by
        its sum (+1e-12), and sample from it."""
        prob = torch.as_tensor(prob, dtype=torch.float32, device=state.cur.sample_prob.device)
        prob = prob / (prob.sum(dim=(-2, -1), keepdim=True) + 1e-12)
        return state._replace(cur=state.cur._replace(
            sample_prob=prob.expand_as(state.cur.sample_prob).clone(),
            use_prob=torch.ones_like(state.cur.use_prob)))

    def get_mirror_indices(self):
        """(neg_obs, right_obs, left_obs, neg_act, right_act, left_act): the
        Walker layout, or for clocked envs the Cassie layout."""
        cfg = self.cfg
        nj = cfg.model.njoints
        if cfg.clock_period:
            # 3 header + 3 v + 2 roll/pitch + 3 w, then angles, speeds,
            # contacts, clock, and (sin*d, cos*d, dz, x_tilt) per stone
            mir, amir = cassie_mod.MIRROR, cassie_mod.MIRROR_ACTION
            base = 11
            contact0 = base + 2 * nj
            tgt0, width = contact0 + 4, 4
            neg_obs = [1, 4, 6, 8, 10]  # sin(bearing), vy, roll, wx, wz
            neg_act, right_act, left_act = (amir["neg_actions"], amir["right_actions"],
                                            amir["left_actions"])
        else:
            mir = walker_mod.MIRROR
            base = 6
            contact0 = base + 2 * nj
            tgt0, width = contact0 + 2, 5
            neg_obs = [2, 4]  # vy, roll
            neg_act, right_act, left_act = (mir["neg_joints"], mir["right_joints"],
                                            mir["left_joints"])
        jpos = lambda j: base + j
        jvel = lambda j: base + nj + j
        neg_obs += [jpos(j) for j in mir["neg_joints"]]
        neg_obs += [jvel(j) for j in mir["neg_joints"]]
        neg_obs += [tgt0 + width * k for k in range(cfg.lookahead)]       # sin*d
        neg_obs += [tgt0 + width * k + 3 for k in range(cfg.lookahead)]   # x_tilt
        right_obs = ([jpos(j) for j in mir["right_joints"]]
                     + [jvel(j) for j in mir["right_joints"]] + [contact0])
        left_obs = ([jpos(j) for j in mir["left_joints"]]
                    + [jvel(j) for j in mir["left_joints"]] + [contact0 + 1])
        return (np.array(neg_obs), np.array(right_obs), np.array(left_obs),
                np.array(neg_act), np.array(right_act), np.array(left_act))


# The reference selects support geometry with a `plank_class` env kwarg
# (mocca bullet_objects class names); the names map onto support modes
# (half-extents as in the JAX package, reports/CALIBRATION.md).
PLANK_CLASSES = {
    "Pillar": dict(support="pillar"),
    "Plank": dict(support="plank", plank_hy=0.6),
    "LargePlank": dict(support="plank", plank_hy=1.5),
}


def _overrides(kw: dict) -> dict:
    kw = dict(kw)
    plank_class = kw.pop("plank_class", None)
    if plank_class is not None:
        kw.update(PLANK_CLASSES[plank_class])
    return kw


def walker3d_stepper(device=None, **kw) -> StepperEnv:
    """Walker3DStepperEnv-v0; kw are StepperConfig overrides or `plank_class`."""
    cfg = StepperConfig(name="Walker3DStepperEnv-v0", model=walker_mod.walker3d(),
                        actuation="torque", obs_dim=60, **_overrides(kw))
    return StepperEnv(cfg, device)


def mike_stepper(device=None, **kw) -> StepperEnv:
    """MikeStepperEnv-v0: Walker3D's env on the heavier, taller Mike; kw
    are StepperConfig overrides or `plank_class`."""
    cfg = StepperConfig(name="MikeStepperEnv-v0", model=walker_mod.mike(),
                        actuation="torque", obs_dim=60, **_overrides(kw))
    return StepperEnv(cfg, device)


def cassie_stepper(device=None, **kw) -> StepperEnv:
    """CassieStepper-v1: stable-PD actuation, 30-step gait clock; kw are
    StepperConfig overrides or `plank_class`."""
    cfg = StepperConfig(name="CassieStepper-v1", model=cassie_mod.cassie(), actuation="pd",
                        obs_dim=51, termination_height=0.5, clock_period=30,
                        init_forward_speed=0.8, **_overrides(kw))
    return StepperEnv(cfg, device)
