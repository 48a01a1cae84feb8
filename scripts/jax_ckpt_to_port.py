#!/usr/bin/env python3
"""Convert the JAX package's checkpoints (orbax) into the PyTorch port's.

    python scripts/jax_ckpt_to_port.py <jax_run>/checkpoints \\
        [--tags latest best ...] --out <port_run>/checkpoints

Run it where the JAX package and orbax are installed: orbax writes OCDBT
compressed with zstd, which the port does not decode (it imports no JAX,
orbax, zstandard or tensorstore), so the port reads the converted files.
With no --tags every tag of the directory is converted. Each tag is
restored with the JAX CheckpointManager and no target, in any layout the
JAX resume accepts (steppingstone_tpu/runtime/train.py: full, r2 without
`value_opt_state`, params-only) or as a bare `{"params": ...}`
(`specialist_<k>`, `crash`), and written as `<out>/<tag>.pt`:

- every tag: `{"policy": ...}`, the weights through
  agents/networks.py `params_from_jax`; enjoy, warm starts (`net=`) and
  the behavior evaluation read it;
- a tag with optimizer state: the port's whole resume snapshot
  (runtime/train.py `make_snapshot`): both Adam states on the port's flat
  layout, the env fleet, observations, episode stats, counters, test
  returns, the curriculum keys, and the test fleet where the run has one.
  The run's configuration is read from `<jax_run>/configs.json`.

What cannot be carried: the JAX random key. The snapshot holds each of
the port's generators' seeds from the run's seed, as at the start of a
run (`Trainer.generator_seeds`), in place of its state, and the port
seeds its generators from them when it resumes; the random streams
restart. A
field that the JAX snapshot lacks and the port needs is filled as the
JAX resume fills it (a fresh Adam state, a fresh reset of the fleets from
the run's seed with the initial curricula installed, no test returns, the
strategies' initial keys), and each fill is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from steppingstone_tpu.runtime.checkpoint import CheckpointManager as JaxCheckpoints  # noqa: E402
from steppingstone_tpu_torch.agents.networks import ActorCritic, params_from_jax  # noqa: E402
from steppingstone_tpu_torch.agents.ppo import adam_state_from_jax, init_optimizer  # noqa: E402
from steppingstone_tpu_torch.agents.rollout import EpisodeStats  # noqa: E402
from steppingstone_tpu_torch.envs.stepper import env_state_from_numpy  # noqa: E402
from steppingstone_tpu_torch.runtime.checkpoint import (CheckpointManager,  # noqa: E402
                                                        is_orbax_checkpoint)
from steppingstone_tpu_torch.runtime.config import TrainConfig  # noqa: E402
from steppingstone_tpu_torch.runtime.train import Trainer  # noqa: E402


def layout(snap: dict) -> str:
    """The JAX resume's name for a snapshot's layout."""
    if "opt_state" not in snap:
        return "params"
    if "env_state" not in snap:
        return "params-only"
    return "full" if "value_opt_state" in snap else "r2-layout"


def policy_of(snap: dict) -> dict:
    """The port's ActorCritic state dict from a snapshot or a bare flax
    parameter tree."""
    return params_from_jax(snap["params"] if "params" in snap else snap)


def empty_policy(state: dict) -> ActorCritic:
    """An ActorCritic on the CPU holding `state`, sized from it."""
    obs_dim = state["actor.layers.0.weight"].shape[1]
    n_critics = len({k.split(".")[1] for k in state if k.startswith("critics.")})
    policy = ActorCritic(obs_dim, state["logstd"].shape[0], max(n_critics, 1), device="cpu",
                         generator=torch.Generator())
    policy.load_state_dict(state)
    return policy


def adam_of(opt_state, policy: ActorCritic):
    """The port's AdamState from a restored optax chain state (a list
    holding the clip's empty state and a dict with count, mu and nu)."""
    parts = opt_state if isinstance(opt_state, (list, tuple)) else [opt_state]
    adam = next(p for p in parts if isinstance(p, dict) and "mu" in p)
    return adam_state_from_jax(SimpleNamespace(**adam), policy)


def run_config(src: str) -> TrainConfig:
    """The port's TrainConfig of the JAX run whose checkpoints are `src`,
    from its configs.json (seed after the replicate offset, one process)."""
    path = os.path.join(os.path.dirname(os.path.abspath(src)), "configs.json")
    if not os.path.isfile(path):
        raise SystemExit(f"{path} is missing: a tag with optimizer state needs the run's "
                         "configuration to build the port's resume snapshot")
    with open(path) as f:
        raw = json.load(f)
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    cfg = TrainConfig(**{k: v for k, v in raw.items() if k in names})
    cfg.mesh_devices = 0
    return cfg


def resume_snapshot(snap: dict, policy_state: dict, trainer: Trainer, say) -> dict:
    """The port's whole resume snapshot from a JAX snapshot with optimizer
    state; `say` reports each field filled."""
    cfg = trainer.cfg
    policy = empty_policy(policy_state)
    strategies = trainer.make_strategies()
    fresh = []

    def fleets():
        # a fresh start's fleets, drawn once, from the run's seeds
        if not fresh:
            trainer.seed_generators()
            fresh.extend(trainer.fresh_fleets(strategies))
        return fresh

    out = {"policy": policy_state, "opt_state": adam_of(snap["opt_state"], policy)}
    if "value_opt_state" in snap:
        out["value_opt_state"] = adam_of(snap["value_opt_state"], policy)
    else:
        out["value_opt_state"] = init_optimizer(policy)
        say("value_opt_state: a fresh Adam state (count 0, zero moments)")
    if "env_state" in snap:
        out["env_state"] = env_state_from_numpy(snap["env_state"])
        out["obs"] = torch.as_tensor(np.array(snap["obs"]), dtype=torch.float32)
        s = snap["stats"]
        out["stats"] = EpisodeStats(ret=torch.as_tensor(np.array(s["ret"]), dtype=torch.float32),
                                    length=torch.as_tensor(np.array(s["length"]),
                                                           dtype=torch.long),
                                    valid=torch.as_tensor(np.array(s["valid"])))
    else:
        out["env_state"], out["obs"] = fleets()[:2]
        out["stats"] = EpisodeStats.init(cfg.num_processes, "cpu")
        say("env_state, obs: a fresh reset of the fleet from the run's seed, the initial "
            "curricula installed; stats: no episode completed")
    # seeds, not states: the resuming port seeds its own generators
    out["generators"] = trainer.generator_seeds()
    out["update"] = int(snap["update"])
    out["frames"] = int(snap["frames"])
    out["max_ep_reward"] = float(snap["max_ep_reward"])
    size = max(cfg.num_tests, 1)
    if "test_rets" in snap:
        out["test_rets"] = torch.as_tensor(np.array(snap["test_rets"], np.float32))
    else:
        out["test_rets"] = torch.full((size,), float("nan"))
        say("test_rets: none (no test fleet result)")
    if out["test_rets"].shape != (size,):
        raise SystemExit(f"test_rets holds {tuple(out['test_rets'].shape)}, the run's "
                         f"num_tests={cfg.num_tests} needs ({size},)")
    initial = strategies.snapshot_keys(-1, cfg.first_sampling)
    saved = snap.get("curriculum", {})
    keys = {}
    for k, v in initial.items():
        if k in saved:
            keys[k] = type(v)(np.asarray(saved[k]).item())
        elif k in ("fixed_frac", "assist_frac") and k.replace("frac", "level") in saved:
            keys[k] = float(np.asarray(saved[k.replace("frac", "level")]).item())
            say(f"curriculum.{k}: its level's value")
        else:
            keys[k] = v
            say(f"curriculum.{k}: the initial {v!r}")
    out["curriculum"] = keys
    if trainer.test_venv is not None:
        if "test_state" in snap:
            out["test_state"] = env_state_from_numpy(snap["test_state"])
            out["test_obs"] = torch.as_tensor(np.array(snap["test_obs"]), dtype=torch.float32)
        else:
            out["test_state"], out["test_obs"] = fleets()[2:]
            say("test_state, test_obs: a fresh reset of the test fleet from the run's seed")
    return out


def convert(src: str, out: str, tags=None) -> dict:
    """Convert `tags` (default: every orbax tag of `src`) into `out`;
    returns {tag: layout}."""
    jax_ckpt = JaxCheckpoints(src)
    port_ckpt = CheckpointManager(out)
    if not tags:
        tags = [t for t in jax_ckpt.tags() if is_orbax_checkpoint(os.path.join(src, t))]
    if not tags:
        raise SystemExit(f"no orbax checkpoint under {src}")
    trainer = None
    done = {}
    for tag in tags:
        snap = jax_ckpt.restore(tag)
        kind = layout(snap)
        notes = []
        policy_state = policy_of(snap)
        if kind == "params":
            port = {"policy": policy_state}
            if "update" in snap:
                port["update"] = int(snap["update"])
        else:
            if trainer is None:
                trainer = Trainer(run_config(src), device="cpu")
            port = resume_snapshot(snap, policy_state, trainer, notes.append)
        port_ckpt.save(tag, port)
        print(f"{tag}: {kind} -> {port_ckpt.path(tag)}", flush=True)
        for note in notes:
            print(f"  filled {note}", flush=True)
        if kind != "params":
            seeds = ", ".join(f"{k} {s}" for k, s in trainer.generator_seeds().items())
            print(f"  the JAX random key has no port counterpart: the port seeds its "
                  f"generators afresh ({seeds}) when it resumes; the random streams restart",
                  flush=True)
        done[tag] = kind
    return done


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="the JAX run's checkpoints directory")
    ap.add_argument("--tags", nargs="*", default=None, help="default: every tag")
    ap.add_argument("--out", required=True, help="the port run's checkpoints directory")
    args = ap.parse_args(argv)
    return convert(args.src, args.out, args.tags)


if __name__ == "__main__":
    main()
