"""Typed experiment configuration with `k=v` CLI overrides and the
experiment directory (own copy of steppingstone_tpu/runtime/config.py:
same keys, defaults, derived values and checks, the same configs.json and
run.json).

Re-design of the reference's sacred setup (`playground/train.py:35-87`,
`common/sacred_utils.py:19-61`): same `python -m ... with`-style `k=v`
override grammar (the `with` word is optional).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import platform
import subprocess
import sys
from typing import Optional

from steppingstone_tpu_torch.parallel.mesh import make_mesh


@dataclasses.dataclass
class TrainConfig:
    env_name: str = "CassieStepper-v1"

    # auxiliary (reference train.py:39-56)
    num_frames: float = 20e7
    seed: int = 8
    save_every: float = 1e7
    log_interval: int = 1
    load_saved_controller: bool = False
    net: Optional[str] = None          # explicit checkpoint path for warm start
    use_mirror: bool = False
    use_phase_mirror: bool = False
    use_curriculum: bool = False
    use_adaptive_sampling: bool = False
    use_specialist: bool = False
    use_threshold_sampling: bool = False
    save_sampling_prob: bool = False
    plot_prob: bool = False

    # sampling (reference train.py:59-67)
    episode_steps: int = 40000          # frames per update
    num_processes: int = 100            # now: batched envs in one program
    mini_batch_size: int = 1024
    num_tests: int = 4
    test_interval: int = 1              # reference evaluates every update
    num_ensembles: int = 1
    sampling_scale: int = 150
    curriculum_threshold: float = 0.85

    # algorithm (reference train.py:69-87)
    use_gae: bool = True
    # alternate full PPO / value-only (10x lr) updates — the reference's
    # `update_values` path (`algorithms/ppo.py:36-38,111`, toggle commented
    # at `train.py:519`)
    use_value_update: bool = False
    lr_decay_type: str = "exponential"
    gamma: float = 0.99
    gae_lambda: float = 0.95
    lr: float = 3e-4
    use_clipped_value_loss: bool = False
    entropy_coef: float = 0.0
    value_loss_coef: float = 1.0
    ppo_epoch: int = 10
    clip_param: float = 0.2
    eps: float = 1e-5
    max_grad_norm: float = 2.0

    # experiment bookkeeping
    experiment_dir: str = "runs/latest"
    replicate_num: int = 1
    resume: bool = False                # continue from checkpoints/latest

    # env construction (reference passes `plank_class` as an env kwarg,
    # SURVEY.md §2.9; "" = env default — see stepper.PLANK_CLASSES and
    # reports/CALIBRATION.md)
    plank_class: str = ""

    # curriculum refinements (see runtime/curriculum.py FixedCurriculum and
    # agents/networks.py reinflate_logstd; 0 disables either)
    level_ramp_updates: int = 25        # updates to ramp each level advance
    advance_logstd: float = -1.7        # re-inflate exploration on advance
    # fixed-curriculum advance bar (reference train.py:503 hardcodes 1000).
    # The bar is reward-scale dependent: Cassie's gait-clock reward field
    # tops out lower per episode than Walker3D's, so its deterministic
    # test mean plateaus ~680 at level 4 while walking — pace advances
    # with a robot-appropriate bar; the final eval is level-5 behavior
    # regardless of how advances were paced
    curriculum_bar: float = 1000.0
    # grid-mode assist ladder: threshold/adaptive runs get the same
    # carpet->calibrated support-geometry ramp as the fixed curriculum
    # (advanced on the same mean>1000 rule), decoupled from the sampling
    # distribution (terrain.CurriculumState.assist)
    grid_assist: bool = True
    # advance bar for the assist ladder (the fixed curriculum keeps the
    # reference's 1000): frontier-targeting sampling suppresses the
    # episode mean by design, so the ladder needs a lower bar to move
    assist_bar: float = 700.0
    # mirror the fixed-curriculum level onto the deterministic test fleet
    # (the reference's test envs stay at their construction-time level,
    # `train.py:110`; ours can follow so test_*_rew measures the CURRENT
    # difficulty)
    test_curriculum: bool = False
    # gate level advances on the deterministic test-fleet mean (>1000)
    # instead of the stochastic training mean — closes the noise-carried-
    # gait gap (round-4 Cassie: stochastic ~2900 vs 93% deterministic
    # falls); requires test_curriculum
    advance_on_test: bool = False
    # late-run exploration anneal: once the top level is reached (or past
    # 60% of the run for non-fixed strategies), cap the logstd linearly
    # down to final_logstd over anneal_updates updates (0/0 disables) —
    # forces the MEAN action to carry the gait (networks.cap_logstd)
    final_logstd: float = 0.0
    anneal_updates: int = 0
    # explicit anneal start (update index); -1 = auto (top level reached,
    # or 60% of the run for non-fixed strategies)
    anneal_start_update: int = -1
    # env-contract override: stall-timeout steps (-1 = env default 180;
    # 0 disables the rule — the fidelity A/B of round-4 verdict weak #2)
    stall_timeout: int = -1
    # reference threshold-coupling flag (`train.py:125,226`): when True,
    # the first non-value-only threshold update restricts sampling to
    # specialist band 0 (the reference initializes it False, so its
    # active path never fires; exposed here so the coupling is drivable)
    first_sampling: bool = False
    # exploration reset on warm start (reference resets to -2.5,
    # controller.py:102-104; imperfect transplants need a warmer start)
    warm_start_logstd: float = -2.5
    # warm-start stabilizers (agents/ppo.py kl_cutoff rationale): scale lr
    # by min(1, (j+1)/lr_warmup_updates), and skip minibatch updates whose
    # approx KL exceeds kl_cutoff (0 disables both)
    lr_warmup_updates: int = 0
    kl_cutoff: float = 0.0

    # extras of the JAX package (no reference analog), kept so both read
    # the same keys
    mesh_devices: int = 0               # ranks the env fleet shards over (0 = all)
    checkpoint_async: bool = True       # inert: the port writes checkpoints in line
    checkpoint_interval: int = 10       # save 'latest' every N updates
    episode_log: bool = False           # Monitor-style episodes.csv
    profile_dir: Optional[str] = None   # profiler trace output

    # ---- derived (reference computes these in-config, train.py:59-63) --
    @property
    def num_steps(self) -> int:
        return self.episode_steps // self.num_processes

    @property
    def num_mini_batch(self) -> int:
        return max(1, self.episode_steps // self.mini_batch_size)

    @property
    def num_updates(self) -> int:
        return int(self.num_frames) // self.num_steps // self.num_processes

    def validate(self):
        """Raise ValueError on an inconsistent configuration, the ranks of
        the default process group included (parallel/mesh.py)."""
        if self.episode_steps % self.num_processes != 0:
            raise ValueError(
                "episode_steps must divide evenly into num_processes "
                f"({self.episode_steps} % {self.num_processes})"
            )
        if not (self.num_steps > 0 and self.num_updates > 0):
            raise ValueError(
                f"num_steps={self.num_steps} and num_updates={self.num_updates} "
                "must both be positive"
            )
        world = make_mesh(self.mesh_devices).world  # raises where the ranks contradict it
        if self.num_processes % world != 0:
            raise ValueError(
                f"num_processes={self.num_processes} must divide over {world} ranks"
            )
        if self.advance_on_test and not (self.test_curriculum and self.num_tests > 0):
            raise ValueError(
                "advance_on_test gates level advances on the deterministic "
                "test fleet; set test_curriculum=True and num_tests > 0"
            )
        if self.anneal_updates > 0 or self.final_logstd != 0.0:
            if not (self.anneal_updates > 0 and self.final_logstd != 0.0):
                raise ValueError(
                    "the logstd anneal needs BOTH final_logstd and anneal_updates set"
                )
            if not self.final_logstd > -3.0:
                raise ValueError(
                    "final_logstd must stay above the exploration floor "
                    "LOGSTD_MIN=-3.0 (networks.py)"
                )

    # ---- self-describing artifacts (round-4 verdict weak #7/task 10:
    # configs.json once recorded sampling_scale=150 for a run that
    # executed at a hardcoded 10) ---------------------------------------
    def inert_keys(self) -> list:
        """Config keys that have NO effect given the enabled strategies —
        stamped into configs.json so a run's artifacts say which recorded
        values the executing code actually consumed."""
        inert = []
        sampling = self.use_threshold_sampling or self.use_adaptive_sampling
        if not sampling:
            inert += ["sampling_scale", "grid_assist", "assist_bar"]
        elif not self.grid_assist:
            inert += ["assist_bar"]
        if not self.use_threshold_sampling:
            inert += ["curriculum_threshold"]
        if not (self.use_curriculum or (sampling and self.grid_assist)):
            inert += ["level_ramp_updates", "advance_logstd"]
        if not self.use_curriculum:
            inert += ["curriculum_bar"]
        if not (self.load_saved_controller or self.net):
            inert += ["warm_start_logstd"]
        if self.num_tests <= 0:
            inert += ["test_interval", "test_curriculum", "advance_on_test"]
        if self.anneal_updates == 0 and self.final_logstd == 0.0:
            inert += ["anneal_updates", "final_logstd", "anneal_start_update"]
        if not sampling:
            inert += ["save_sampling_prob", "plot_prob"]
        return sorted(set(inert))

    def reference_divergences(self) -> dict:
        """Defaults that deliberately diverge from the reference's ACTIVE
        code path (round-4 advisor finding #2): returns {key: (ours,
        reference)} for every such knob currently off its faithful value."""
        faithful = {
            "sampling_scale": 10,      # reference train.py:263,356 hardcodes
            "level_ramp_updates": 0,   # reference steps levels instantly
            "advance_logstd": 0.0,     # reference never re-inflates logstd
            "grid_assist": False,      # no assist ladder in the reference
            "test_curriculum": False,
            "advance_on_test": False,
            "final_logstd": 0.0,
            "anneal_updates": 0,
            "curriculum_bar": 1000.0,  # reference train.py:503 hardcodes
        }
        out = {}
        inert = set(self.inert_keys())
        for k, ref in faithful.items():
            ours = getattr(self, k)
            if ours != ref and k not in inert:
                out[k] = (ours, ref)
        return out


_BOOLS = {"true": True, "false": False, "1": True, "0": False,
          "yes": True, "no": False, "t": True, "f": False}


def _coerce(field_type, raw: str):
    if field_type in (bool, Optional[bool]):
        return _BOOLS[raw.lower()]
    if field_type in (int,):
        return int(float(raw))
    if field_type in (float,):
        return float(raw)
    if field_type in (Optional[str], str):
        return None if raw.lower() == "none" else raw
    return raw


def parse_cli(argv=None, base: TrainConfig | None = None) -> TrainConfig:
    """Parse `k=v` overrides (sacred's `with k=v` grammar, reference
    `scripts/local_run_playground_train.sh:25`)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = dataclasses.replace(base) if base else TrainConfig()
    fields = {f.name: f for f in dataclasses.fields(TrainConfig)}
    for arg in argv:
        if arg == "with":
            continue
        if "=" not in arg:
            raise SystemExit(f"expected k=v override, got {arg!r}")
        k, v = arg.split("=", 1)
        if k not in fields:
            raise SystemExit(
                f"unknown config key {k!r}; known: {sorted(fields)}"
            )
        setattr(cfg, k, _coerce(_annotation_of(k), v))
    cfg.validate()
    return cfg


def _annotation_of(name: str):
    # dataclass stores annotations as strings under `from __future__ import
    # annotations`; resolve the common ones
    ann = TrainConfig.__annotations__[name]
    return {"str": str, "int": int, "float": float, "bool": bool,
            "Optional[str]": Optional[str]}.get(ann, str)


def _git_info():
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ).stdout.strip()
        return {"commit": commit}
    except (OSError, subprocess.SubprocessError):
        return {}


def init_experiment(cfg: TrainConfig, write: bool = True) -> str:
    """Create the experiment dir and (with `write`, on one rank of several)
    write configs.json / run.json (reference `sacred_utils.py:42-55`).
    Returns the experiment dir.

    Replicate seeding follows the reference: seed += (replicate_num - 1) *
    num_processes (`sacred_utils.py:34`).
    """
    cfg.seed = cfg.seed + (cfg.replicate_num - 1) * cfg.num_processes
    os.makedirs(cfg.experiment_dir, exist_ok=True)
    if not write:
        return cfg.experiment_dir
    # stamp effective/derived values and the keys the enabled strategies
    # ignore, so the snapshot is self-describing
    snapshot = dataclasses.asdict(cfg)
    snapshot["_effective"] = {
        "seed": cfg.seed,  # after the replicate offset
        "num_steps": cfg.num_steps,
        "num_mini_batch": cfg.num_mini_batch,
        "num_updates": cfg.num_updates,
    }
    snapshot["_inert_keys"] = cfg.inert_keys()
    with open(os.path.join(cfg.experiment_dir, "configs.json"), "w") as f:
        json.dump(snapshot, f, indent=2, sort_keys=True)
    divergences = cfg.reference_divergences()
    for k, (ours, ref) in divergences.items():
        print(f"config divergence from the reference's active path: {k}={ours} "
              f"(reference: {ref})", flush=True)
    run_meta = {
        "start_time": datetime.datetime.now().isoformat(),
        "host": platform.node(),
        "python": sys.version,
        "argv": sys.argv,
        "reference_divergences": {
            k: {"ours": v[0], "reference": v[1]} for k, v in divergences.items()
        },
        **_git_info(),
    }
    with open(os.path.join(cfg.experiment_dir, "run.json"), "w") as f:
        json.dump(run_meta, f, indent=2)
    return cfg.experiment_dir
