"""Inference and visualization entry point (port of
steppingstone_tpu/runtime/enjoy.py, the reference `playground/enjoy.py`
re-designed for offline workflows).

Rolls a trained policy out deterministically on one env (optionally
switching specialists by depth), records the kinematic trajectory and the
terrain, and writes:

- a .npz trajectory dump (body positions and orientations, stones,
  rewards, contacts, actions, values) for the viz/ renderers, with the JAX
  package's keys, shapes and dtypes, so either package's viz reads either
  package's dump (reference `--dump`, enjoy.py:352-377)
- per-hit candidate-stone value grids (reference value plotting,
  enjoy.py:234-316)
- a console episode report (reward, steps, stones reached)

Usage (on the card; `main(argv, device="cpu")` runs it on the CPU):
  python -m steppingstone_tpu_torch.runtime.enjoy --env Walker3DStepperEnv-v0 \\
      --net runs/exp/checkpoints/latest [--steps 1000] [--dump traj.npz] \\
      [--plot-value] [--curriculum 5]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from steppingstone_tpu_torch.agents.networks import ActorCritic
from steppingstone_tpu_torch.device import resolve_device
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.envs import terrain as terr
from steppingstone_tpu_torch.envs.stepper import ResetDraws, create_temp_states
from steppingstone_tpu_torch.physics import kinematics as km
from steppingstone_tpu_torch.runtime.checkpoint import CheckpointManager
from steppingstone_tpu_torch.runtime.torch_import import REFERENCE_MODELS, load_reference_checkpoint


def _checkpoint_file(net_path: str) -> str:
    """The file behind `net_path`: the path itself, or a port tag without
    its `.pt` (`CheckpointManager(dirname).path(basename)`)."""
    for path in (net_path, f"{net_path}.pt"):
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no checkpoint at {net_path} (nor {net_path}.pt)")


def load_params(net_path: str, env, num_ensembles: int, device=None) -> tuple[dict, int]:
    """(state dict of `ActorCritic` on `device`, number of critics) from
    either kind of checkpoint, both `.pt` files:

    - a port checkpoint (runtime/checkpoint.py; a tag with or without
      `.pt`): a tree of tensors read with `weights_only=True`, holding
      `"policy"` (a training snapshot, `specialist_<k>` or `crash`);
    - a reference pickle (runtime/torch_import.py): any other `.pt`, whose
      classes a weights-only read refuses.

    Raises, naming the path, on a missing path or a file of neither kind.
    `num_ensembles` is the caller's expectation; the count returned is the
    checkpoint's."""
    dev = resolve_device(device)
    path = _checkpoint_file(net_path)
    try:
        snap = CheckpointManager.read(path)
    except (pickle.UnpicklingError, KeyError, RuntimeError, EOFError) as e:
        # not a tree of tensors: the reference reader decides, and raises
        # naming the path
        if not path.endswith(".pt"):
            raise ValueError(f"{path} is neither a port checkpoint nor a reference .pt") from e
        return load_reference_checkpoint(path, env.action_dim, dev)
    if not (isinstance(snap, dict) and isinstance(snap.get("policy"), dict)):
        got = sorted(snap) if isinstance(snap, dict) else type(snap).__name__
        raise ValueError(f"{path} is a tensor file without a 'policy' (holds {got})")
    state = {k: v.to(dev) for k, v in snap["policy"].items()}
    n = len({k.split(".")[1] for k in state if k.startswith("critics.")})
    return state, n


def policy_from_state(state: dict, env, n_critics: int, device=None) -> ActorCritic:
    """An `ActorCritic` holding `state` (its init, drawn from a generator of
    its own, is overwritten)."""
    policy = ActorCritic(env.observation_dim, env.action_dim, max(n_critics, 1), device=device,
                         generator=torch.Generator())
    policy.load_state_dict(state)
    return policy


def specialist_band(next_step_index: int, n_specialists: int, n_stones: int) -> int:
    """The specialist for a depth into the terrain: one per difficulty
    band."""
    return min(next_step_index * n_specialists // n_stones, n_specialists - 1)


def value_grid(cfg, policy: ActorCritic, state) -> torch.Tensor:
    """(GRID, GRID) ensemble-mean values of the candidate placements of the
    next-next stone, for a one-env state."""
    temp = create_temp_states(cfg, state)                   # (1, G, obs_dim)
    return policy.ensemble_values(temp).mean(dim=-1).reshape(terr.GRID, terr.GRID)


@torch.no_grad()
def run_episode(env, policy: ActorCritic, max_steps: int, plot_value: bool,
                curriculum_level: float, specialists=None, generator=None,
                reset_draws: ResetDraws | None = None, step_draws=None) -> dict:
    """Roll one deterministic episode of one env (a batch of 1 through the
    batched stepper); `specialists` is an optional list of policies
    switched by difficulty band (reference `--use_specialist`,
    enjoy.py:104-110). Randomness comes from `generator`; `reset_draws`
    and `step_draws` (a sequence of EnvStepDraws, one per step) replace its
    draws."""
    cfg = env.cfg
    cur = terr.default_curriculum(curriculum_level, batch=1, device=env.device)
    state, obs = env.reset(cur, generator=generator, draws=reset_draws)

    frames, rewards, contacts, value_grids = [], [], [], []
    actions_log, values_log = [], []
    stones0 = state.terrain[0].cpu().numpy()
    total, hits = 0.0, 0
    active = policy
    for t in range(max_steps):
        kin = km.forward_kinematics(cfg.model, state.phys.q)
        frames.append((kin.pos[0].cpu().numpy(), kin.quat[0].cpu().numpy()))
        if specialists:
            active = specialists[specialist_band(int(state.next_step_index[0]),
                                                 len(specialists), cfg.n_stones)]
        values_log.append(float(active.value(obs)[0, 0]))
        action = active.action_mean(obs)
        state, out = env.step(state, action, generator=generator,
                              draws=None if step_draws is None else step_draws[t])
        obs = out.obs
        reward = float(out.reward[0])
        rewards.append(reward)
        actions_log.append(action[0].cpu().numpy())
        contacts.append(state.foot_contact[0].cpu().numpy())
        total += reward
        hits += int(out.hit[0])
        if plot_value and bool(state.update_terrain[0]):
            value_grids.append(value_grid(cfg, policy, state).cpu().numpy())
        if bool(out.done[0]):
            break
    return dict(
        frames=frames,
        rewards=np.array(rewards),
        actions=np.array(actions_log),
        values=np.array(values_log),
        contacts=np.array(contacts),
        stones=stones0,
        value_grids=value_grids,
        total_reward=total,
        hits=hits,
        steps=len(rewards),
        final_terrain=state.terrain[0].cpu().numpy(),
    )


def specialist_paths(net: str) -> list:
    """The reference's specialists next to `net` (enjoy.py:104-110):
    `{net}_specialist_{i}` or `net` with `latest` replaced by
    `specialist_{i}`, for i in 0..4, each with or without `.pt`."""
    found = []
    for i in range(5):
        for cand in (f"{net}_specialist_{i}", net.replace("latest", f"specialist_{i}")):
            if os.path.exists(cand) or os.path.isfile(f"{cand}.pt"):
                found.append(cand)
                break
    return found


def write_dump(path: str, result: dict, model) -> None:
    """The trajectory .npz, with the JAX package's keys, shapes and
    dtypes."""
    np.savez_compressed(
        path,
        body_pos=np.stack([f[0] for f in result["frames"]]),
        body_quat=np.stack([f[1] for f in result["frames"]]),
        rewards=result["rewards"], contacts=result["contacts"],
        actions=result["actions"], values=result["values"],
        stones=result["final_terrain"],
        body_names=np.array(model.body_names),
        joint_names=np.array(model.joint_names),
        value_grids=np.array(result["value_grids"])
        if result["value_grids"] else np.zeros((0, terr.GRID, terr.GRID)),
    )


def main(argv=None, device=None):
    """`python -m steppingstone_tpu_torch.runtime.enjoy ...` on the card
    (`device` picks another)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="Walker3DStepperEnv-v0")
    ap.add_argument("--net", default=None,
                    help="port checkpoint (a tag, with or without .pt) or reference .pt file")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1093)  # reference enjoy.py:102
    ap.add_argument("--dump", default=None, help="write trajectory .npz here")
    ap.add_argument("--plot-value", action="store_true")
    ap.add_argument("--curriculum", type=float, default=0)
    ap.add_argument("--num-ensembles", type=int, default=1)
    ap.add_argument("--episodes", type=int, default=1)
    ap.add_argument("--use-specialist", action="store_true",
                    help="load <net>_specialist_{0..4} and switch by depth")
    ap.add_argument("--plank-class", default=None,
                    help="support geometry (stepper.PLANK_CLASSES)")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    kw = {"plank_class": args.plank_class} if args.plank_class else {}
    env = make_env(args.env, device=dev, **kw)
    print(f"Env: {args.env}")

    if args.net is None:
        # reference default: models/{env}_latest.pt (enjoy.py:100)
        args.net = os.path.join(REFERENCE_MODELS, f"{args.env}_latest.pt")
    print(f"Model: {os.path.basename(args.net)}")
    state, n_ens = load_params(args.net, env, args.num_ensembles, dev)
    policy = policy_from_state(state, env, n_ens, dev)

    specialists = None
    if args.use_specialist:
        # reference loads {env}_specialist_{0..4}.pt (enjoy.py:104-110)
        specialists = [policy_from_state(load_params(p, env, n_ens, dev)[0], env, n_ens, dev)
                       for p in specialist_paths(args.net)]
        if not specialists:
            raise SystemExit("no specialist checkpoints found next to --net")
        print(f"loaded {len(specialists)} specialists")

    generator = torch.Generator(device=dev).manual_seed(args.seed)
    for ep in range(args.episodes):
        result = run_episode(env, policy, args.steps, args.plot_value, args.curriculum,
                             specialists=specialists, generator=generator)
        print(f"episode {ep}: reward {result['total_reward']:.1f} over "
              f"{result['steps']} steps, stones hit: {result['hits']}")
        if args.dump:
            path = args.dump if args.episodes == 1 else f"{args.dump}.{ep}"
            write_dump(path, result, env.cfg.model)
            print(f"wrote {path}")


if __name__ == "__main__":
    main()
