"""Walking-behavior evaluation (port of scripts/behavior_eval.py).

Mean episode reward can be farmed by standing still, so capability is
read from behavior: stones crossed, falls, distance travelled and
per-episode returns, per curriculum level (or specialist difficulty
band), for the deterministic policy over N envs x T steps (default 256 x
1000). The report is the JAX script's JSON: the same top-level keys, and
per entry the same 15 keys, rounded alike.

Usage (on the card; `main(argv, device="cpu")` runs it on the CPU):
  python -m steppingstone_tpu_torch.runtime.behavior_eval runs/exp \\
      [--env Walker3DStepperEnv-v0] [--levels 0 2 5] [--ensembles 1]
      [--envs 256] [--steps 1000] [--tag latest] [--plank_class LargePlank]
      [--bands 0 3 [--specialists]] [--device cuda] [--out x.json]

It reads `<run_dir>/checkpoints/<tag>.pt` (and `specialist_<k>.pt` with
`--specialists`), a port checkpoint; a JAX package checkpoint is refused,
naming the converter (scripts/jax_ckpt_to_port.py). Every entry starts
from the same draws: one torch.Generator seeded with SEED at each entry
(the JAX script resets every entry from PRNGKey(7)); `main`'s `draws`
replaces them. The numbers are not comparable with the JAX
package's reports (reports/behavior_r5_*.json), whose policies are other
checkpoints, drawn from another generator.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from steppingstone_tpu_torch.agents.networks import ActorCritic
from steppingstone_tpu_torch.device import resolve_device
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.envs import terrain as terr
from steppingstone_tpu_torch.envs.stepper import EnvState
from steppingstone_tpu_torch.envs.vector import VecEnv
from steppingstone_tpu_torch.runtime.enjoy import load_params, policy_from_state
from steppingstone_tpu_torch.tracing import span

# the per-step records of an entry, in the order `evaluate_entry` stacks them
RECORDS = ("reward", "hit", "done", "timeout", "ep_return", "ep_len", "ns_pre")
SEED = 7  # scripts/behavior_eval.py PRNGKey(7)


def band_curriculum(k: int, batch: int, device) -> terr.CurriculumState:
    """Level-5 support geometry with stones drawn from specialist band k
    (an annulus of the (yaw, pitch) grid, terrain.specialist_band_prob)."""
    cur = terr.default_curriculum(terr.N_LEVELS - 1, batch=batch, device=device)
    prob = terr.specialist_band_prob(k, device=device)
    return cur._replace(sample_prob=prob.expand(batch, -1, -1).clone(),
                        use_prob=torch.ones(batch, dtype=torch.bool, device=device))


@torch.no_grad()
def evaluate_entry(venv: VecEnv, policy: ActorCritic, cur: terr.CurriculumState, steps: int,
                   reset_draws=None, step_draws=None) -> tuple[dict, EnvState]:
    """Reset the fleet with `cur`, then `steps` steps of the policy's mean
    action. Returns ({name: (T, N) host array for each of RECORDS}, final
    state); `ns_pre` is each env's target stone before the step. Reset
    draws come from `reset_draws` or the fleet's generator; `step_draws`,
    if given, is called before every step with the done flags of the step
    before (None before the first) and returns that step's EnvStepDraws.
    The records stay on the device until the last step."""
    with span("eval.entry"):
        with span("eval.reset"):
            state, obs = venv.reset(cur, draws=reset_draws)
        rows, done = [], None
        for _ in range(steps):
            with span("eval.step"):
                ns_pre = state.next_step_index.clone()
                with span("policy"):
                    action = policy.action_mean(obs)
                state, out = venv.step(state, action,
                                       draws=None if step_draws is None else step_draws(done))
                obs, done = out.obs, out.done
                rows.append((out.reward, out.hit, out.done, out.timeout, out.ep_return,
                             out.ep_len, ns_pre))
        with span("eval.records"):
            cols = [torch.stack(c).cpu().numpy() for c in zip(*rows)]
    return dict(zip(RECORDS, cols)), state


def entry_report(rec: dict, final: EnvState, n_envs: int, n_stones: int) -> dict:
    """One entry's behavior numbers, computed and rounded as
    scripts/behavior_eval.py computes them. The track is finite: an
    episode that ends with its target at the last stone walked the whole
    track, and is not counted as a capability fall."""
    done, tout, hit = rec["done"], rec["timeout"], rec["hit"]
    last = n_stones - 1
    ended = int(done.sum())                    # completed episodes
    falls = int(done.sum() - tout.sum())       # ended by falling, not by time
    reached_end = done & (rec["ns_pre"] >= last)
    falls_mid = int((done & ~tout & (rec["ns_pre"] < last)).sum())
    n_ep = ended + n_envs                      # episodes in flight count once
    d = rec["ep_return"][done]
    return {
        "episodes_completed": ended,
        "falls": falls,
        "fall_rate": round(falls / max(n_ep, 1), 3),
        "walked_whole_track": int(reached_end.sum()),
        "walked_whole_track_rate": round(float(reached_end.sum()) / max(n_ep, 1), 3),
        "falls_before_track_end": falls_mid,
        "fall_before_end_rate": round(falls_mid / max(n_ep, 1), 3),
        "stone_hits_total": int(hit.sum()),
        "stones_per_episode": round(float(hit.sum()) / max(n_ep, 1), 2),
        "mean_episode_reward": round(float(d.mean()), 1) if d.size else None,
        "median_episode_reward": round(float(np.median(d)), 1) if d.size else None,
        "mean_episode_len": round(float(rec["ep_len"][done].mean()), 1) if ended else None,
        "reward_per_step": round(float(rec["reward"].mean()), 2),
        "mean_final_next_step_index": round(
            float(final.next_step_index.cpu().numpy().mean()), 1),
        "mean_final_x_m": round(float(final.phys.q[:, 0].cpu().numpy().mean()), 1),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir")
    ap.add_argument("--env", default="Walker3DStepperEnv-v0")
    ap.add_argument("--levels", type=float, nargs="*", default=[0, 2, 5])
    ap.add_argument("--ensembles", type=int, default=1,
                    help="kept from the JAX script; the critics are the checkpoint's")
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--tag", default="latest")
    ap.add_argument("--plank_class", default=None,
                    help="evaluate on this support geometry (stepper.PLANK_CLASSES)")
    ap.add_argument("--bands", type=int, nargs="*", default=None,
                    help="evaluate at specialist difficulty bands (annuli of the 11x11 grid, "
                         "terrain.specialist_band_prob) instead of levels; support geometry "
                         "fixed at level 5")
    ap.add_argument("--specialists", action="store_true",
                    help="with --bands: load checkpoints/specialist_k for band k (vs the "
                         "single --tag policy for every band)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write JSON here")
    return ap.parse_args(argv)


def main(argv=None, device=None, draws=None) -> dict:
    """`python -m steppingstone_tpu_torch.runtime.behavior_eval ...`: the
    report, printed as JSON and returned. `device` overrides `--device`.
    `draws`, if given, is called with each entry's label and curriculum
    and returns (reset draws, step-draws callable) for evaluate_entry."""
    args = parse_args(argv)
    dev = resolve_device(args.device if device is None else device)
    kw = {"plank_class": args.plank_class} if args.plank_class else {}
    env = make_env(args.env, device=dev, **kw)
    ckpt_dir = os.path.join(args.run_dir, "checkpoints")

    def policy(tag: str) -> ActorCritic:
        state, n_critics = load_params(os.path.join(ckpt_dir, tag), env, args.ensembles, dev)
        return policy_from_state(state, env, n_critics, dev)

    N, T = args.envs, args.steps
    report = {"run": args.run_dir, "env": args.env, "tag": args.tag, "envs": N, "steps": T,
              "support": env.cfg.support, "plank_class": args.plank_class}
    main_policy = policy(args.tag)
    entries = []
    if args.bands is not None:
        for k in args.bands:
            p = policy(f"specialist_{min(k, 4)}") if args.specialists else main_policy
            name = f"band_{k}" + ("_specialist" if args.specialists else "")
            entries.append((name, band_curriculum(k, N, dev), p))
    else:
        for level in args.levels:
            entries.append((f"level_{level:g}",
                            terr.default_curriculum(level, batch=N, device=dev), main_policy))

    venv = VecEnv(env, N, device=dev, seed=SEED)
    for label, cur, p in entries:
        venv.generator.manual_seed(SEED)
        reset_draws, step_draws = draws(label, cur) if draws is not None else (None, None)
        rec, final = evaluate_entry(venv, p, cur, T, reset_draws, step_draws)
        report[label] = entry_report(rec, final, N, env.cfg.n_stones)
        print(f"{label} done", file=sys.stderr, flush=True)
    js = json.dumps(report, indent=2)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js + "\n")
    return report


if __name__ == "__main__":
    main()
