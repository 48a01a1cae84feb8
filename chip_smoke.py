#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (steppingstone_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds every kernel from this checkout's
sources (and the URDF parser with the host C++ compiler). Phases, in
order; any failure exits non-zero and no phase's failure is caught:

1. card: name and power limit (nvidia-smi)
2. build: the control-step kernels (csrc/control_step.cu, one nvcc run for
   the eight variants K1, K2, K3, K2+K3, K4, K2+K4, K3+K4, K2+K3+K4, each
   as control_step_warp<PD, PLANK, ROT>, a warp per env) and ptxas's
   registers, stack frame and spills for each; control_step_warp's shared
   memory per block and resident envs per SM for Walker3D and Cassie on
   discs and on planks, unrotated and with rotated frames
3. each variant against its plain PyTorch version (engine._step_scan) on
   the card at B=4096 and a ragged B=1000 (K2 and K2+K3 also at 1024 and
   64, the round-5 runs' fleet and test fleet, K2 also at 16, the value
   grid's eval fleet, and at 512 and 32, a rank's fleet and test fleet of
   the sharded round-5 run; K1 also at 512, a rank's fleet of the dry
   run; K1 and K2 also at 256, the behavior evaluation's fleet; K1 also
   at 128, entry()'s fleet), on states
   from a short rollout
   of the port plus random perturbations, so that contacts, on-stone feet,
   joint limits and (planks) feet beyond the disc radius but on the plank
   all occur; K1 on Walker3D torques over discs, K2 on Walker3D torques
   over LargePlank planks, K3 on Cassie stable PD over discs, K2+K3 on
   Cassie stable PD over planks, and the K4 variants on the same four
   with fixed joint rotations drawn from a seed (the repo holds no
   full-width URDF robot); K2 also on Mike's states at 1024 and 64 (its
   round-5 run's fleet and test fleet); K1 and K2 also at B=1 (enjoy's
   single env: one block, one live warp behind the tail guard), on the
   first of the 4096 envs whose step engages a contact on a stone, a joint
   limit and (K2) plank-only support; then each variant's time per
   launch (K2's and K2+K3's also at their path batches, K1's and K2's at
   B=1); the foot_positions kernel (the feet's world positions that every
   env reset and step reads) against the plain forward kinematics on the
   same states, within 1e-5 + 1e-6 |x|, at its paths' batches: Walker3D at
   4096 (K1's states) and at 1024, 256 and 16 (K2's: the round-5 fleet,
   the behavior evaluation's and the value grid's), Cassie at 1024 (K2+K3's)
   and Walker3D with fixed joint rotations at a ragged 1000 (K4's); then
   its time per launch replayed from a CUDA graph (as the env step's graph
   runs it), per eager call, and the plain kinematics' per eager call
4. paths, each driven through the entry points a user calls, with the
   launch counts set to 0 just before and read just after (and no call of
   the plain version, and no launch of another variant, allowed; the
   foot_positions kernel exactly two launches an env step, the auto-reset's
   and the step's own, and one a reset outside a step, none on the paths
   of engine.step calls):
   - K1: Walker3D rollout, VecEnv(4096), 25 steps, exactly 25 K1
     launches; the split of a step, a torch.profiler trace, and a small
     rollout on the card against the same rollout on the CPU
   - K3: Cassie (disc support) rollout, 4096 envs, 25 steps, exactly 25
   - the measurement entry points (this slice's path, K1 on discs):
     entry() (steppingstone_tpu_torch/entry.py), 3 forward steps at its
     128 envs, exactly 3 K1 launches, every output finite, one step on the
     card against the CPU from the same state, draws and parameters;
     steppingstone_tpu_torch/bench.py at bench.py's
     4096 envs x 100 steps, cut in depth to one warm-up and one timed
     Trainer.train_iteration and one warm-up and one timed rollout chunk of
     25 steps: exactly 250 K1 launches, its JSON line printed; the update
     probe (steppingstone_tpu_torch/update_probe.py) at 12800-row
     minibatches, mirrored, on 409,600 rows; a profile of 10 PPO minibatch
     steps of the bench's 4096 rows
   - K2+K3: the round-5 Cassie training configuration (CassieStepper-v1,
     LargePlank, phase mirror, 2 critics, KL guard), 4096 envs x 100
     steps, one training iteration driven in its halves (Trainer.rollout,
     then Trainer.update: GAE, 10 epochs x 100 minibatches of 4096 rows),
     exactly 100 launches, every output finite, the rollout / update split
     and profiles of both
   - K2: Walker3D LargePlank train_iteration with mirror-augmented PPO,
     4096 envs x 25 steps, exactly 25 launches
   - one Cassie LargePlank training iteration on the card against the
     same iteration on the CPU, on shared draws
   - the URDF path: the test robot of tests/test_urdf.py through
     urdf.load_urdf and 60 engine.step calls at 4096 envs (exactly 60 K4
     launches), then loaded with kp/kd and driven by PD targets (60 K3+K4);
     it lands on its spheres above -0.1 m; one more step from the loop's
     first state, its landing and its last state is held against the
     plain version, as in 3
   - rotated Walker3D through 100 engine.step calls at 4096 envs (100 K4),
     rotated Walker3D on planks (25 K2+K4), rotated Cassie PD on planks
     (25 K2+K3+K4)
   - the training loop: Trainer.train from the CLI's parser on the round-5
     Walker3D run (scripts/round5_runs.sh COMMON + HARDEN + runs/r5_w3d:
     1024 envs x 400 steps, minibatches of 1024, 64 test envs every 10
     updates, LargePlank, fixed curriculum), cut to 1 update: K2 launches
     equal the control steps taken (test fleet included), progress.csv
     has the reference header, the artifacts exist, losses are finite
     (its resume to a second update is the sharded path's: cut to keep
     the script near its time)
   - Mike: Trainer.train from the CLI's parser on the round-5 Mike run
     (scripts/round5_runs.sh COMMON + HARDEN + runs/r5_mike_scratch:
     MikeStepperEnv-v0, LargePlank, fixed curriculum), cut to one update:
     exactly 400 + 1000 K2 launches (the update and its test fleet), the
     reference progress.csv header, finite losses, the update's rollout /
     update / test fleet split
   - the value-based curricula: Trainer.train from the CLI's parser on the
     round-5 threshold-sampling run (scripts/round5_runs.sh COMMON +
     runs/r5_thr150: LargePlank, threshold sampling at scale 150, the
     grid-mode assist ladder, the pickles; not the heatmap, plot_prob,
     which needs matplotlib), cut to one
     update (the uniform round and its test fleet: exactly 1,400 K2
     launches), then resumed for a second (the value grid's 160 steps of
     16 envs and the update: exactly 560); the first snapshot's threshold
     and assist keys, the pickles (one round), the probabilities installed
     on every env, the grid normalized; the candidate observations and
     critic values on 16 of the fleet's envs against the CPU; one
     AdaptiveSampling.pre_update on the card (160 K2 launches) against
     softmax(-150 grid) computed on the host
   - warm starts: Trainer.train from the CLI's parser on the round-5
     specialist run (scripts/round5_runs.sh COMMON + runs/r5_specialist:
     LargePlank, the specialist schedule, warm_start_logstd -2.0,
     kl_cutoff 0.12, lr_warmup_updates 20), warm-started from the round-5
     Walker3D loop's checkpoints/best above and cut to one update: the
     warm start equals the checkpoint but for logstd (all -2.0), exactly
     400 + 1000 K2 launches, the reference progress.csv, finite losses,
     the update's split (this slice's K2 path)
   - inference: enjoy.main on the card (a) on LargePlank from the
     specialist run's checkpoints/latest with --plot-value --dump, one K2
     launch per step of the episode, the dump with the JAX dump's keys,
     shapes and dtypes; (b) the same policy pickled in the reference's
     layout, loaded equal to it and run on discs, one K1 launch per step;
     then enjoy.run_episode on the card against the CPU from the same
     draws (frames, rewards, actions, values, value grids 1e-3; contacts,
     hits, steps equal)
   - behavior evaluation: behavior_eval.main on the card on the round-5
     Walker3D loop's checkpoints/latest at the round-5 reports' 256 envs,
     cut in depth from 1000 steps an entry to 50: scripts/round5_evals.sh
     :8 with its levels cut from 0 2 5 to 0 5 and :15 with its bands cut
     from 0 1 2 3 to 0 3 (LargePlank, exactly 100 K2 launches each), and
     level 0 on discs (exactly 50 K1); each report with the JAX script's
     keys (read from scripts/behavior_eval.py), every value finite, falls
     and whole-track walks within the episodes; ms a step, one profiled
     entry; one 8-env x 30-step LargePlank entry on the card against the
     CPU from the same draws (integer fields equal, floats within 1e-3 or
     one unit of the key's rounding)
   - resume is total on the card: 256 envs x 16 steps, 2 + 2 updates
     against 4 unbroken, every progress.csv column but fps within rel 1e-5 /
     abs 1e-6 (tests/test_runtime.py); a miss is traced to its source by a
     second unbroken run
   - sharded (parallel/): two ranks share the card, each a process posing
     as a one-GPU host (LOCAL_RANK 0) over gloo, since NCCL refuses two
     ranks on one GPU. (a) parallel.dryrun_multichip(2): one Walker3D
     iteration at 1,024 envs x 2 steps (512 a rank) against the same
     iteration in this process, the losses within the JAX package's rel
     1e-3, exactly 2 K1 launches a rank; (b) one rank under NCCL at world
     size 1 runs that iteration through every collective, equal bit for
     bit to the iteration without a process group; (c) the round-5
     Walker3D run (R5_W3D with mesh_devices=2: 512 envs and 32 test envs a
     rank), cut to 1 update then resumed to 2: each rank's K2 launches
     equal its control steps, no plain call, the ranks end with the same
     learner, rank 0 alone writes progress.csv (the reference header) and
     the checkpoints; each rank's time in collectives per minibatch step
     (the gradient all-reduce) and per update is printed
5. one JSON line `{"kernels": [...]}` (K1's `launches` are the bench's on
   the measurement path, each variant's other paths under `other_paths`;
   each variant with its `design` and `occupancy`; last foot_positions,
   its launches on the bench and on every other path checked), the script's wall
   time, the card line, and last
   `{"ok": true, "device": {...}}`
"""

from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

NUM_ENVS = 4096
# the Walker3D rollout path's steps: the bench's rollout chunk (the
# measurement path's bench times the same rollout at length)
ROLLOUT_STEPS = 25
CHECK_BATCHES = (4096, 1000)
# the round-5 Walker3D run's fleet and test fleet (R5_W3D)
R5_ENVS, R5_TEST_ENVS = 1024, 64
# the value grid's eval fleet (steppingstone_tpu_torch/runtime/curriculum.py
# EVAL_ENVS) and its control steps (EVAL_STEPS)
GRID_ENVS, GRID_STEPS = 16, 160
# the sharded path: the env fleet over SHARDED_RANKS ranks, each a process
# posing as a one-GPU host on the card (LOCAL_RANK 0), over gloo (NCCL
# refuses two ranks on one GPU); the dry run's fleet and steps
SHARDED_RANKS = 2
DRYRUN_ENVS = 1024
# K2 and K2+K3 are also held to their plain version, and timed, at the
# batch sizes their round-5 runs give them (both take COMMON's fleet and
# test fleet, scripts/round5_runs.sh; K2 also the value grid's eval fleet
# and a rank's fleet and test fleet of the sharded round-5 run); K1 at a
# rank's fleet of the dry run
# the behavior evaluation's fleet (runtime/behavior_eval.py --envs)
BEHAVIOR_ENVS = 256
# the measurement path (steppingstone_tpu_torch/entry.py, bench.py,
# update_probe.py): entry's fleet and its forward steps; the bench at
# bench.py's full width cut in depth to BENCH_REPEATS timed iteration and
# rollout chunk (after its own warm-up of each); one grid point of the
# update probe (minibatch rows, mirror); the minibatch steps profiled at
# the bench's minibatch rows
ENTRY_ENVS = 128
ENTRY_CALLS = 3
BENCH_REPEATS = 1
PROBE_POINT = (12800, True)
PROFILED_MINIBATCHES = 10
PATH_BATCHES = {"K1": (DRYRUN_ENVS // SHARDED_RANKS, BEHAVIOR_ENVS, ENTRY_ENVS),
                "K2": (R5_ENVS, R5_TEST_ENVS, GRID_ENVS, R5_ENVS // SHARDED_RANKS,
                       R5_TEST_ENVS // SHARDED_RANKS, BEHAVIOR_ENVS),
                "K2+K3": (R5_ENVS, R5_TEST_ENVS)}
TIMED_LAUNCHES = 50
CASSIE_DISC_STEPS = 25
TRAIN_STEPS = 100
WALKER_PLANK_STEPS = 25
LR = 3e-4
# the round-5 Cassie run (scripts/round5_runs.sh), at one card's env count
CASSIE_RUN = dict(env_name="CassieStepper-v1", plank_class="LargePlank", use_phase_mirror=True,
                  num_ensembles=2, kl_cutoff=0.12)
# H100 SXM published peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# variant -> the env whose states and support it is checked on; the K4
# variants run those robots with fixed joint rotations drawn from ROT_SEED
VARIANT_ENVS = {
    "K1": ("Walker3DStepperEnv-v0", {}),
    "K2": ("Walker3DStepperEnv-v0", {"plank_class": "LargePlank"}),
    "K3": ("CassieStepper-v1", {}),
    "K2+K3": ("CassieStepper-v1", {"plank_class": "LargePlank"}),
    "K4": ("Walker3DStepperEnv-v0", {}),
    "K2+K4": ("Walker3DStepperEnv-v0", {"plank_class": "LargePlank"}),
    "K3+K4": ("CassieStepper-v1", {}),
    "K2+K3+K4": ("CassieStepper-v1", {"plank_class": "LargePlank"}),
}
ROT_SEED = 5
URDF_STEPS = 60
ROT_WALKER_STEPS = 100
ROT_PLANK_STEPS = 25
# scripts/round5_runs.sh: COMMON (:19-21) and HARDEN (:31-32)
R5_COMMON = [f"num_processes={R5_ENVS}", "episode_steps=409600", "mini_batch_size=1024",
             f"num_tests={R5_TEST_ENVS}",
             "test_interval=10", "mesh_devices=1", "use_mirror=True", "episode_log=True",
             "seed=8"]
R5_HARDEN = ["test_curriculum=True", "advance_on_test=True", "final_logstd=-2.5",
             "anneal_updates=150", "kl_cutoff=0.12"]
# the round-5 Walker3D run, runs/r5_w3d (its own line :57-58), cut in depth
# to UPDATES_FIRST updates (one process), and over two ranks then a resume
# to UPDATES_RESUMED
R5_W3D = R5_COMMON + R5_HARDEN + ["env_name=Walker3DStepperEnv-v0", "plank_class=LargePlank",
                                  "use_curriculum=True", "checkpoint_interval=1"]
UPDATES_FIRST, UPDATES_RESUMED = 1, 2
# the same run over SHARDED_RANKS ranks: COMMON's mesh_devices=1 names one
# device; over two ranks the fleet shards over both (512 envs and 32 test
# envs a rank)
R5_W3D_SHARDED = R5_W3D + [f"mesh_devices={SHARDED_RANKS}"]
# the round-5 Mike run, runs/r5_mike_scratch (its own line :92-95), cut in
# depth to one update: 400 control steps and the test fleet's episode
# (1000 steps), each one K2 launch
R5_MIKE = R5_COMMON + R5_HARDEN + ["env_name=MikeStepperEnv-v0", "plank_class=LargePlank",
                                   "use_curriculum=True"]
MIKE_LAUNCHES = 400 + 1000
# the round-5 value-based run, runs/r5_thr150 (its own line :87-89):
# threshold sampling at the config's sampling_scale (150) and
# curriculum_threshold (0.85), the grid-mode assist ladder (assist_bar
# 700), cut in depth to 1 update then a resume to 2. Update 1 is the
# uniform round (level 5, no value grid) with the test fleet: 400 + 1000
# K2 launches; update 2 runs the value grid (160 steps of 16 envs) and its
# 400 steps: 560. The run's plot_prob=True is cut: the card's machine has
# no matplotlib (the heatmap is held by the CPU tests)
R5_THR150 = R5_COMMON + ["env_name=Walker3DStepperEnv-v0", "plank_class=LargePlank",
                         "use_threshold_sampling=True", "save_sampling_prob=True"]
THR_LAUNCHES = {"first": 400 + 1000, "resumed": 400 + GRID_STEPS}
# the round-5 specialist run, runs/r5_specialist (its own line :117-122):
# the specialist schedule warm-started from the round-5 Walker3D run's
# checkpoints/best (here the cut loop's above) with its logstd reset to
# -2.0, cut in depth to one update of SPECIALIST_STEPS control steps (the
# run's 400 halved; minibatches keep their 1024 rows): 200 K2 launches and
# the test fleet's episode (1000)
SPECIALIST_STEPS = 200
R5_SPECIALIST = R5_COMMON + ["env_name=Walker3DStepperEnv-v0", "plank_class=LargePlank",
                             "use_specialist=True", "warm_start_logstd=-2.0", "kl_cutoff=0.12",
                             "lr_warmup_updates=20",
                             f"episode_steps={R5_ENVS * SPECIALIST_STEPS}"]
SPECIALIST_LAUNCHES = SPECIALIST_STEPS + 1000
# enjoy's episodes end where the policy falls, at most ENJOY_STEPS steps;
# the card against the CPU over CARD_CPU_EPISODE_STEPS at most
ENJOY_STEPS = 1000
CARD_CPU_EPISODE_STEPS = 30
# K1 and K2 are also held to their plain version, and timed, at enjoy's
# single env
ONE_ENV = ("K1", "K2")
# foot_positions is held to the plain kinematics, and timed, on the states
# of these variants' checks at these batches: the rollout paths' fleet
# (K1, Walker3D), the round-5 fleets (K2 Walker3D, K2+K3 Cassie), the
# behavior evaluation's and the value grid's fleets, and a ragged batch of
# a model with fixed joint rotations (K4)
FOOT_BATCHES = {"K1": (NUM_ENVS,), "K2": (R5_ENVS, BEHAVIOR_ENVS, GRID_ENVS),
                "K2+K3": (R5_ENVS,), "K4": (CHECK_BATCHES[1],)}
# the behavior evaluation of the round-5 reports on the round-5 Walker3D
# loop's checkpoints (runs/r5_w3d, latest), at its 256 envs, cut in depth
# from 1000 steps to BEHAVIOR_STEPS (the untrained policy falls after ~21
# steps, so episodes still end):
# scripts/round5_evals.sh:8 (levels 0 2 5 on LargePlank, cut to 0 5) and
# :15 (bands 0 1 2 3 on LargePlank, cut to 0 3), each entry one K2 launch a
# step; and level 0 on discs, one K1 launch a step.
# name -> (flags, variant, launches)
BEHAVIOR_STEPS = 50
BEHAVIOR_RUNS = {
    "levels 0 5, LargePlank": (["--levels", "0", "5", "--plank_class", "LargePlank"], "K2",
                               2 * BEHAVIOR_STEPS),
    "bands 0 3, LargePlank": (["--bands", "0", "3", "--plank_class", "LargePlank"], "K2",
                              2 * BEHAVIOR_STEPS),
    "level 0, discs": (["--levels", "0"], "K1", BEHAVIOR_STEPS),
}
# the behavior evaluation on the card against the CPU: one entry on
# LargePlank from the same draws
BEHAVIOR_CPU_ENVS, BEHAVIOR_CPU_STEPS = 8, 30
PROGRESS_HEADER = ["iter", "total_num_steps", "fps", "entropy", "value_loss", "action_loss",
                   "mean_rew", "median_rew", "min_rew", "max_rew", "test_mean_rew",
                   "test_median_rew", "test_min_rew", "test_max_rew"]
# the URDF of tests/test_urdf.py (a 2-link hopper with a fixed head and a
# rotated knee frame)
TESTBOT_URDF = """<?xml version="1.0"?>
<robot name="testbot">
  <!-- a 2-link hopper with a fixed head -->
  <link name="base">
    <inertial>
      <mass value="5.0"/>
      <origin xyz="0 0 0.1"/>
      <inertia ixx="0.05" iyy="0.06" izz="0.04" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision>
      <origin xyz="0 0 0"/>
      <geometry><sphere radius="0.1"/></geometry>
    </collision>
  </link>
  <link name="head">
    <inertial>
      <mass value="1.0"/>
      <origin xyz="0 0 0.05"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <joint name="neck" type="fixed">
    <parent link="base"/>
    <child link="head"/>
    <origin xyz="0 0 0.3"/>
  </joint>
  <link name="right_thigh">
    <inertial>
      <mass value="2.0"/>
      <origin xyz="0 0 -0.2"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.005" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <joint name="right_hip" type="revolute">
    <parent link="base"/>
    <child link="right_thigh"/>
    <origin xyz="0 -0.1 -0.05" rpy="0 0 0"/>
    <axis xyz="0 1 0"/>
    <limit lower="-1.5" upper="1.5" effort="80"/>
    <dynamics damping="0.5"/>
  </joint>
  <link name="right_foot">
    <inertial>
      <mass value="0.5"/>
      <origin xyz="0 0 -0.05"/>
      <inertia ixx="0.002" iyy="0.002" izz="0.002" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision>
      <origin xyz="0 0 -0.1"/>
      <geometry><sphere radius="0.04"/></geometry>
    </collision>
  </link>
  <joint name="right_knee" type="revolute">
    <parent link="right_thigh"/>
    <child link="right_foot"/>
    <origin xyz="0 0 -0.4" rpy="0.1 0 0"/>
    <axis xyz="0 1 0"/>
    <limit lower="-2.0" upper="0.1" effort="60"/>
  </joint>
</robot>
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps, after one warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mangled_names() -> dict:
    """Each kernel's name and template arguments as they appear in its
    mangled name -> its variant: control_step_warp<PD, PLANK, ROT> (and
    control_step_warp<PD, PLANK> of sources before ROT, for
    scripts/compare_sources.py's baselines), and foot_positions."""
    from steppingstone_tpu_torch.physics.step_kernel import VARIANTS

    mangle = lambda name, flags: f"{name}ILb" + "ELb".join(str(int(b)) for b in flags) + "EE"
    names = {"foot_positions": "foot_positions"}
    for v, (pd, plank, rot) in VARIANTS.items():
        names[mangle("control_step_warp", (pd, plank, rot))] = v
        if not rot:
            names[mangle("control_step_warp", (pd, plank))] = f"{v} (before ROT)"
    return names


def print_ptxas(build_log: str) -> None:
    """ptxas's registers and stack frame (with spills) of each kernel."""
    current, names = "?", mangled_names()
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            current = next((v for m, v in names.items() if m in line), "?")
        elif "registers" in line or "stack frame" in line:
            print(f"ptxas {current}:", line.strip(), flush=True)


@dataclasses.dataclass
class Counted:
    """What counting_plain counts in its block: calls of the plain control
    step, env resets on the card made outside an env step, and the
    foot_positions kernel's launches."""
    plain_calls: int = 0
    resets: int = 0
    feet: int = 0


# foot_positions' launches on each path checked (check_launches), by path
FOOT_LAUNCHES: dict = {}


@contextlib.contextmanager
def counting_plain():
    """Counts calls of the plain control step (engine._step_scan) in the
    block, which a path on the card must not make; the env resets on the
    card made outside an env step (StepperEnv.reset, its auto-reset inside
    StepperEnv.step left out); and the foot_positions kernel's launches,
    set to 0 at the block's start."""
    from steppingstone_tpu_torch.envs.stepper import StepperEnv
    from steppingstone_tpu_torch.physics import engine, step_kernel

    counted, depth = Counted(), [0]
    plain, reset, step = engine._step_scan, StepperEnv.reset, StepperEnv.step

    def counted_plain(*args, **kwargs):
        counted.plain_calls += 1
        return plain(*args, **kwargs)

    def counted_reset(env, *args, **kwargs):
        counted.resets += depth[0] == 0 and env.device.type == "cuda"
        return reset(env, *args, **kwargs)

    def counted_step(env, *args, **kwargs):
        depth[0] += 1
        try:
            return step(env, *args, **kwargs)
        finally:
            depth[0] -= 1

    engine._step_scan = counted_plain
    StepperEnv.reset, StepperEnv.step = counted_reset, counted_step
    step_kernel.FOOT_POSITIONS.launches = 0
    try:
        yield counted
    finally:
        engine._step_scan, StepperEnv.reset, StepperEnv.step = plain, reset, step
        counted.feet = step_kernel.FOOT_POSITIONS.launches


def check_launches(what: str, launches: dict, variant: str, expected: int,
                   counted: Counted | None, env_steps: int | None = None):
    """Exactly `expected` launches of `variant`, none of another variant
    and, from `counted` (None where the path ran in other processes: only
    their launches are checked), no plain call and two foot_positions
    launches an env step
    (its auto-reset's and its own; `env_steps` by default `expected`, 0 on
    a path of engine.step calls) and one a reset outside a step."""
    others = {k: v for k, v in launches.items() if k != variant and v}
    plain_calls = 0 if counted is None else counted.plain_calls
    if launches[variant] != expected or others or plain_calls:
        raise AssertionError(f"{what}: launches {launches}, plain calls {plain_calls}; "
                             f"expected {expected} {variant} launches and nothing else")
    if counted is not None:
        steps = expected if env_steps is None else env_steps
        if counted.feet != 2 * steps + counted.resets:
            raise AssertionError(f"{what}: {counted.feet} foot_positions launches, expected "
                                 f"2 x {steps} env steps + {counted.resets} resets")
        FOOT_LAUNCHES[what] = counted.feet


def check_finite(what: str, tensors: dict) -> None:
    import torch

    for name, t in tensors.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite {name} in {what}")


def variant_env(variant: str):
    """The env a variant is checked on (make_env; for the K4 variants the
    same robot with fixed joint rotations drawn from ROT_SEED)."""
    from steppingstone_tpu_torch.envs import make_env
    from steppingstone_tpu_torch.envs.stepper import StepperEnv
    from steppingstone_tpu_torch.physics.model import with_rotated_frames
    from steppingstone_tpu_torch.physics.step_kernel import VARIANTS

    name, kw = VARIANT_ENVS[variant]
    env = make_env(name, **kw)
    if VARIANTS[variant][2]:
        model = with_rotated_frames(env.cfg.model, ROT_SEED)
        env = StepperEnv(dataclasses.replace(env.cfg, model=model), env.device)
    return env


def kernel_inputs(env, batch: int, seed: int):
    """Inputs of one control step at batch size `batch`: the state after a
    short random-action rollout of the port, perturbed as in
    tests/test_pallas_step.py, with a quarter of the envs past a joint
    limit; planks also shift half the envs sideways so that feet stand on
    the plank beyond the disc radius. Returns
    (args of control_step, its keyword arguments)."""
    import torch

    from steppingstone_tpu_torch.envs import terrain as terr
    from steppingstone_tpu_torch.envs.vector import VecEnv
    from steppingstone_tpu_torch.physics import engine

    cfg, model = env.cfg, env.cfg.model
    venv = VecEnv(env, batch, seed=seed)
    g = venv.generator
    rand = lambda *shape: torch.rand(shape, generator=g, device="cuda")
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    state, _ = venv.reset()
    for _ in range(12):
        state, _ = venv.step(state, 0.5 * randn(batch, env.action_dim))
    q, qd = state.phys.q.clone(), state.phys.qd.clone()
    q[:, 2] += 0.05 * randn(batch) - 0.03
    q[:, 7:] += 0.1 * randn(batch, model.njoints)
    qd += 0.3 * randn(*qd.shape)
    # a quarter of the envs start with one joint 0.15 rad past its upper
    # limit (PD pulls Cassie's joints away from their limits otherwise)
    rows = torch.nonzero(rand(batch) < 0.25)[:, 0]
    joint = torch.randint(model.njoints, (rows.shape[0],), generator=g, device="cuda")
    upper = torch.as_tensor(model.joint_upper, device="cuda")
    q[rows, 7 + joint] = upper[joint] + 0.15
    kw = {}
    if cfg.support == "plank":
        q[:, 1] += (rand(batch) < 0.5) * (2.4 * rand(batch) - 1.2)
        kw["support_hy"] = cfg.plank_hy
    r_eff = state.stone_radius + cfg.radius_extra * (1.0 - terr.level_scale(state.cur.assist))
    if cfg.actuation == "pd":
        tau = torch.zeros((batch, model.njoints), device="cuda")
        kw["target"] = engine.pd_target_from_action(model, 2.4 * rand(batch, model.action_dim) - 1.2)
        kw["power"] = 0.5 + 0.5 * rand(batch)
    else:
        tau = 20.0 * randn(batch, model.njoints)
    use_ground = rand(batch) < 0.5
    return (q, qd, tau, state.terrain.contiguous(), r_eff.contiguous(), use_ground), kw


def plain_version(model, args, kw, substeps=None):
    from steppingstone_tpu_torch.physics import engine

    pd = (kw["target"], kw["power"]) if "target" in kw else None
    return engine._step_scan(model, engine.PhysicsState(args[0], args[1]), *args[2:], pd=pd,
                             support_hy=kw.get("support_hy"),
                             substeps=engine.SUBSTEPS if substeps is None else substeps)


def plank_only_spheres(env, args, kw):
    """(B, NC) bool: the contact spheres that a plank supports and a disc of
    the same radius would not (stones only, no ground)."""
    import torch

    from steppingstone_tpu_torch.physics import contact as ct
    from steppingstone_tpu_torch.physics import kinematics as km
    from steppingstone_tpu_torch.physics.model import tensor

    model = env.cfg.model
    q, stones, r_eff = args[0], args[3], args[4]
    pts = km.contact_points(model, km.forward_kinematics(model, q))
    rest = (torch.zeros_like(pts), tensor(model, "contact_radius", "cuda"), stones, r_eff,
            torch.zeros_like(args[5]), env.cfg.contact)
    plank = ct.compute_contacts(pts, *rest, support_hy=kw["support_hy"])
    disc = ct.compute_contacts(pts, *rest)
    return (plank.stone_index >= 0) & (disc.stone_index < 0)


def plank_only_fraction(env, args, kw) -> float:
    """Share of contact spheres that a plank supports and a disc of the same
    radius would not."""
    return float(plank_only_spheres(env, args, kw).float().mean())


def check_one_env(env, variant: str, args, kw):
    """The variant at B=1 (enjoy's single env: one block, one live warp
    behind the tail guard) against its plain version (compare_step), on the
    first env of a larger batch of inputs whose step engages a contact on a
    stone, a joint limit and (planks) plank-only support. Returns
    (metrics, the one env's inputs)."""
    import torch

    _, ref = plain_version(env.cfg.model, args, kw)
    engaged = (ref.foot_contact.any(dim=1) & (ref.foot_stone >= 0).any(dim=1)
               & ref.joint_at_limit.any(dim=1))
    if "support_hy" in kw:
        engaged &= plank_only_spheres(env, args, kw).any(dim=1)
    rows = torch.nonzero(engaged)[:, 0]
    if not len(rows):
        raise AssertionError(f"{variant}: no env of {args[0].shape[0]} engages everything")
    i = int(rows[0])
    one = tuple(a[i:i + 1].contiguous() for a in args)
    one_kw = {k: v[i:i + 1].contiguous() if torch.is_tensor(v) else v for k, v in kw.items()}
    extra = {"plank_only_fraction": plank_only_fraction(env, one, one_kw)} if "support_hy" in kw else {}
    got = compare_step(env.cfg.model, f"{variant} (one env)", one, one_kw, variant=variant,
                       robot=env.cfg.model.name, env_index=i, **extra)
    if not (got["contact_fraction"] > 0 and got["on_stone_fraction"] > 0
            and got["at_limit_fraction"] > 0 and got.get("plank_only_fraction", 1) > 0):
        raise AssertionError(f"{variant}: the one env engages less than chosen: {got}")
    return got, (one, one_kw)


# A joint limit switches a stiff spring on (engine.LIMIT_K) where the input
# q of a substep passes the limit: a trajectory that passes within
# LIMIT_FLIP_MARGIN rad (a few fp32 ulps at the joints' scale) of a limit
# may land on either side in two fp32 implementations. At most
# MAX_FLIP_SHARE of the envs may miss the q / qd / foot-force bars that way
# (the Pallas bars let the discrete diagnostics disagree on 0.1%), each
# shown to be one by limit_flips.
LIMIT_FLIP_MARGIN = 1e-6
MAX_FLIP_SHARE = 1e-3


def misses(q, qd, force, st, ref):
    """Per env: whether (q, qd, foot force) miss the Pallas bars (q 2e-4,
    qd 2e-3/2e-2, foot force 1e-2/1.0) against the plain version's
    (state, info)."""
    miss = lambda a, b, rtol, atol: ((a - b).abs() > atol + rtol * b.abs()).any(dim=1)
    return (miss(q, st.q, 2e-4, 2e-4) | miss(qd, st.qd, 2e-3, 2e-2)
            | miss(force, ref.foot_normal_force, 1e-2, 1.0))


def limit_flips(model, args, kw, envs):
    """For envs whose control step misses the bars, substep by substep:
    (a) from the plain version's state, the kernel matches each substep
    within the bars (q, qd, foot force) with the same at-limit flags;
    (b) on their own trajectories the kernel and the plain version first
    miss the bars in a substep whose at-limit flags differ; (c) there the
    plain version's input q lies within LIMIT_FLIP_MARGIN of that joint's
    limit. Raises otherwise; returns each env's distance in (c)."""
    import torch

    from steppingstone_tpu_torch.physics import engine, step_kernel

    sub = [a[envs].contiguous() for a in args]
    sub_kw = {k: v[envs].contiguous() if torch.is_tensor(v) else v for k, v in kw.items()}
    lo = torch.as_tensor(model.joint_lower, device="cuda")
    hi = torch.as_tensor(model.joint_upper, device="cuda")
    n = len(envs)
    q, qd = sub[0], sub[1]          # the plain version's trajectory
    qk, qdk = q, qd                 # the kernel's own trajectory
    parted = torch.zeros(n, dtype=torch.bool, device="cuda")
    flipped = torch.zeros(n, dtype=torch.bool, device="cuda")
    distance = torch.full((n,), float("inf"), device="cuda")
    for _ in range(engine.SUBSTEPS):
        st, ref = plain_version(model, [q, qd] + sub[2:], sub_kw, substeps=1)
        q1, qd1, info1 = step_kernel.control_step(model, q, qd, *sub[2:], substeps=1, **sub_kw)
        torch.testing.assert_close(q1, st.q, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(qd1, st.qd, rtol=2e-3, atol=2e-2)
        torch.testing.assert_close(info1.foot_normal_force, ref.foot_normal_force,
                                   rtol=1e-2, atol=1.0)
        if not torch.equal(info1.joint_at_limit, ref.joint_at_limit):
            raise AssertionError(f"envs {envs}: at-limit flags differ from the same state")
        qk, qdk, infok = step_kernel.control_step(model, qk, qdk, *sub[2:], substeps=1,
                                                  **sub_kw)
        first = misses(qk, qdk, infok.foot_normal_force, st, ref) & ~parted
        differ = infok.joint_at_limit != ref.joint_at_limit
        gap = torch.minimum((q[:, 7:] - lo).abs(), (q[:, 7:] - hi).abs())
        gap = torch.where(differ, gap, float("inf")).min(dim=1).values
        flipped |= first & differ.any(dim=1) & (gap < LIMIT_FLIP_MARGIN)
        distance = torch.where(first, gap, distance)
        parted |= first
        q, qd = st.q, st.qd
    if not bool(flipped.all()):
        raise AssertionError(f"envs {envs} are not joint-limit flips (parted {parted.tolist()}, "
                             f"input q's distance to the limit whose flag differs "
                             f"{distance.tolist()})")
    return distance.tolist()


def compare_step(model, what: str, args, kw, **extra) -> dict:
    """One control step of the kernel against engine._step_scan on the same
    inputs, under the Pallas bars of tests/test_pallas_step.py and a bar on
    contact_force_sum (rel 1e-3, abs 1.0), on every env but the joint-limit
    flips (see limit_flips); raises on a miss. Returns
    the errors and the inputs' contact, stone and limit shares."""
    import torch

    from steppingstone_tpu_torch.physics import step_kernel

    batch = args[0].shape[0]
    q, qd, info = step_kernel.control_step(model, *args, **kw)
    st, ref = plain_version(model, args, kw)
    torch.cuda.synchronize()
    outliers = torch.nonzero(misses(q, qd, info.foot_normal_force, st, ref))[:, 0]
    if len(outliers) > MAX_FLIP_SHARE * batch:
        raise AssertionError(f"{what}: {len(outliers)} of {batch} envs miss the bars")
    flips = limit_flips(model, args, kw, outliers) if len(outliers) else []
    keep = torch.ones(batch, dtype=torch.bool, device="cuda")
    keep[outliers] = False
    agree = lambda a, b: float((a == b).float().mean())
    got = dict(
        batch=batch,
        max_q_err=float((q - st.q)[keep].abs().max()),
        max_qd_err=float((qd - st.qd)[keep].abs().max()),
        limit_flips=len(flips),
        limit_flip_distance=flips,
        foot_contact_agreement=agree(info.foot_contact, ref.foot_contact),
        foot_stone_agreement=agree(info.foot_stone, ref.foot_stone),
        at_limit_agreement=agree(info.joint_at_limit, ref.joint_at_limit),
        max_foot_force_err=float((info.foot_normal_force - ref.foot_normal_force)[keep].abs().max()),
        max_force_sum_err=float((info.contact_force_sum - ref.contact_force_sum)[keep].abs().max()),
        contact_fraction=float(ref.foot_contact.float().mean()),
        envs_in_contact=float((ref.contact_force_sum > 0).float().mean()),
        on_stone_fraction=float((ref.foot_stone >= 0).float().mean()),
        at_limit_fraction=float(ref.joint_at_limit.float().mean()),
        **extra,
    )
    print(f"{what} vs plain:", json.dumps(got), flush=True)
    torch.testing.assert_close(q[keep], st.q[keep], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(qd[keep], st.qd[keep], rtol=2e-3, atol=2e-2)
    torch.testing.assert_close(info.foot_normal_force[keep], ref.foot_normal_force[keep],
                               rtol=1e-2, atol=1.0)
    # the sum over spheres and substeps, in another order than the plain
    # version's
    torch.testing.assert_close(info.contact_force_sum[keep], ref.contact_force_sum[keep],
                               rtol=1e-3, atol=1.0)
    if not (got["foot_contact_agreement"] > 0.999 and got["foot_stone_agreement"] > 0.995
            and got["at_limit_agreement"] > 0.999):
        raise AssertionError(f"{what}: diagnostics disagree with the plain version: {got}")
    return got


def check_variant(env, variant: str, batch: int):
    """A kernel variant against engine._step_scan (compare_step) on inputs
    that engage contacts, stones, joint limits and (planks) plank-only
    support. Returns (metrics, the inputs)."""
    from steppingstone_tpu_torch.physics import step_kernel

    model = env.cfg.model
    args, kw = kernel_inputs(env, batch, seed=batch)
    if step_kernel.variant("target" in kw, "support_hy" in kw,
                           model.joint_rot is not None) != variant:
        raise AssertionError(f"{variant} inputs select another variant")
    extra = {"plank_only_fraction": plank_only_fraction(env, args, kw)} if "support_hy" in kw else {}
    got = compare_step(model, variant, args, kw, variant=variant, robot=model.name, **extra)
    if not (0 < got["contact_fraction"] < 1 and got["on_stone_fraction"] > 0
            and got["at_limit_fraction"] > 0 and got.get("plank_only_fraction", 1) > 0):
        raise AssertionError(f"inputs did not engage contacts, limits and planks: {got}")
    return got, (args, kw)


def time_variant(env, variant: str, args, kw) -> dict:
    from steppingstone_tpu_torch.physics import engine, step_kernel

    model, kernel = env.cfg.model, step_kernel.CONTROL_STEP
    soa = step_kernel.to_kernel_layout(*args)
    pd, hy, rot = "target" in kw, kw.get("support_hy"), model.joint_rot is not None
    launch_kw = dict(support_hy=hy)
    if pd:
        launch_kw.update(target_t=kw["target"].t().contiguous(), power=kw["power"])
    cp = env.cfg.contact
    ms = cuda_ms(lambda: kernel.launch(model, *soa, cp, engine.SUBSTEPS, **launch_kw),
                 TIMED_LAUNCHES)
    wrapper_ms = cuda_ms(lambda: step_kernel.control_step(model, *args, **kw), TIMED_LAUNCHES)
    plain_ms = cuda_ms(lambda: plain_version(model, args, kw), 3)
    n_stones, batch = args[3].shape[1], args[0].shape[0]
    flops = step_kernel.control_step_flops(model, n_stones, engine.SUBSTEPS, pd, hy,
                                           rot) * batch
    nbytes = step_kernel.control_step_bytes(model, n_stones, pd) * batch
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    got = dict(variant=variant, batch=batch, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
               bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               flops=flops, bytes=nbytes)
    print(f"{variant} timing:", json.dumps(got), flush=True)
    return got


def foot_positions_cost(model, feet) -> tuple:
    """(fp32 operations, bytes) of foot_positions for one env, counted
    from its inputs: a link above the foot rotates the anchor (30: two
    cross products and the sum), adds it (3), halves the angle and takes
    its sine and cosine (3), scales the axis (3) and multiplies the
    quaternions (28; 28 more with fixed joint rotations); the foot's own
    link rotates and adds (33). Bytes: the root pose and the angles on the
    feet's chains read, the positions written (the model's tables and the
    chains are shared by every env)."""
    from steppingstone_tpu_torch.physics import step_kernel

    chains = step_kernel.foot_chains(model, feet)
    link = 67 + (28 if model.joint_rot is not None else 0)
    flops = sum(33 + (int(n) - 1) * link for n in chains[:, 0])
    angles = {int(b) for row in chains for b in row[1:row[0]]}
    return flops, 4 * (7 + len(angles)) + 4 * 3 * len(feet)


def check_foot_positions(env, variant: str, q) -> dict:
    """foot_positions on the card at q (B, nq) against the plain forward
    kinematics on the card at the same q, within 1e-5 + 1e-6 |x|, in one
    launch; then its time (ms: a launch replayed from a CUDA graph of
    TIMED_LAUNCHES launches; wrapper_ms: an eager call) beside the plain
    kinematics' (plain_ms) and the bound of its operations and bytes."""
    import torch

    from steppingstone_tpu_torch.envs.stepper import _foot_bodies
    from steppingstone_tpu_torch.physics import kinematics, step_kernel

    model = env.cfg.model
    feet, batch = _foot_bodies(model), q.shape[0]
    plain = lambda: kinematics.forward_kinematics(model, q).pos[:, list(feet)]
    before = step_kernel.FOOT_POSITIONS.launches
    got = step_kernel.foot_positions(model, q, feet)
    if step_kernel.FOOT_POSITIONS.launches != before + 1:
        raise AssertionError(f"foot_positions: {step_kernel.FOOT_POSITIONS.launches - before} "
                             "launches for one call")
    ref = plain()
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-5,
                               msg=lambda m: f"foot_positions, {model.name} at {batch}: {m}")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(TIMED_LAUNCHES):
            step_kernel.foot_positions(model, q, feet)
    flops, nbytes = (batch * x for x in foot_positions_cost(model, feet))
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    out = dict(variant=variant, robot=model.name, batch=batch,
               max_abs_err=float((got - ref).abs().max()),
               ms=cuda_ms(graph.replay, 5) / TIMED_LAUNCHES,
               wrapper_ms=cuda_ms(lambda: step_kernel.foot_positions(model, q, feet),
                                  TIMED_LAUNCHES),
               plain_ms=cuda_ms(plain, 3), bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes", flops=flops,
               bytes=nbytes)
    print("foot_positions:", json.dumps(out), flush=True)
    return out


def rollout_path(env, variant: str, steps: int, detail: bool) -> dict:
    """A rollout as a user drives it (make_env, VecEnv, ActorCritic,
    collect_rollout) at NUM_ENVS, with the variant's launches counted;
    with `detail` also the split of a step and a profile."""
    import torch

    from steppingstone_tpu_torch.agents.networks import ActorCritic
    from steppingstone_tpu_torch.agents.rollout import (
        EpisodeStats, collect_rollout, policy_action)
    from steppingstone_tpu_torch.envs.vector import VecEnv
    from steppingstone_tpu_torch.physics import step_kernel

    venv = VecEnv(env, NUM_ENVS, seed=0)
    policy = ActorCritic(env.observation_dim, env.action_dim,
                         generator=torch.Generator().manual_seed(0))
    state, obs = venv.reset()
    stats = EpisodeStats.init(NUM_ENVS, "cuda")
    torch.cuda.synchronize()
    step_kernel.CONTROL_STEP.reset_counts()
    with counting_plain() as plain:
        t0 = time.perf_counter()
        state, obs, stats, traj, aux = collect_rollout(venv, policy, state, obs, stats, steps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(step_kernel.CONTROL_STEP.launches)
    check_launches(f"{env.cfg.name} rollout", launches, variant, steps, plain)
    if traj.obs.shape != (steps, NUM_ENVS, env.observation_dim):
        raise AssertionError(f"trajectory obs shape {tuple(traj.obs.shape)}")
    check_finite(f"{env.cfg.name} rollout", {
        **traj._asdict(), "last_obs": obs, "q": state.phys.q, "qd": state.phys.qd,
        "terrain": state.terrain})
    out = dict(env=env.cfg.name, support=env.cfg.support, launches=launches[variant],
               seconds=seconds, env_steps_per_s=NUM_ENVS * steps / seconds,
               step_ms=1e3 * seconds / steps, hits=int(aux["hits"]),
               dones=int(aux["ep_done"].sum()), mean_reward=float(traj.rewards.mean()))
    if detail:
        # the split of a rollout step, timed after the counted run
        with torch.no_grad():
            out["policy_ms"] = cuda_ms(lambda: (policy_action(policy, obs, False, venv.generator),
                                                policy.value(obs)), 10)
        out["env_step_ms"] = cuda_ms(lambda: venv.step(state, traj.actions[-1]), 10)
    print(f"{variant} path:", json.dumps(out), flush=True)
    if detail:
        print(f"{variant} path profile:", json.dumps(profile_rollout(venv, policy, state, obs)),
              flush=True)
    return out


def device_time(prof, wall_ms: float, steps: int, key: str = "control_step") -> dict:
    """Device kernel time summed over a torch.profiler trace against the
    host clock. The profiler slows the host, so the idle share it gives is
    an upper estimate."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    key_ms = sum(e.self_device_time_total for e in kernels if key in e.key) / 1e3
    return dict(steps=steps, wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                kernels_per_step=sum(e.count for e in kernels) / steps,
                control_step_share_of_device_time=key_ms / busy_ms)


def profile_rollout(venv, policy, state, obs, steps: int = 5) -> dict:
    """A few rollout steps under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from steppingstone_tpu_torch.agents.rollout import EpisodeStats, collect_rollout

    stats = EpisodeStats.init(obs.shape[0], obs.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        collect_rollout(venv, policy, state, obs, stats, steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return device_time(prof, wall_ms, steps)


def profile_update(ppo_cfg, generator, policy, opt_state, batch, steps: int = 10) -> dict:
    """`steps` PPO minibatch steps of `ppo_cfg`'s minibatch size on `batch`
    under torch.profiler (one epoch over the first steps x rows of the
    batch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from steppingstone_tpu_torch.agents.ppo import ppo_update

    rows = batch["obs"].shape[0] // ppo_cfg.num_mini_batch
    cfg = dataclasses.replace(ppo_cfg, ppo_epoch=1, num_mini_batch=steps)
    sub = {k: v[:steps * rows] for k, v in batch.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ppo_update(policy, opt_state, cfg, sub, LR, generator=generator)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    out = device_time(prof, wall_ms, steps)
    out.pop("control_step_share_of_device_time")
    return dict(rows_per_step=rows, **out)


def cassie_training_path() -> dict:
    """The round-5 Cassie configuration through one training iteration,
    driven in its two halves (Trainer.rollout, then Trainer.update: what
    Trainer.train_iteration runs) and timed in each: 4096 envs x 100 steps,
    every step one K2+K3 launch; then profiles of both halves."""
    import torch

    from steppingstone_tpu_torch.agents.ppo import init_optimizer
    from steppingstone_tpu_torch.agents.rollout import EpisodeStats
    from steppingstone_tpu_torch.physics import step_kernel
    from steppingstone_tpu_torch.runtime.config import TrainConfig
    from steppingstone_tpu_torch.runtime.train import Trainer

    cfg = TrainConfig(**CASSIE_RUN, num_processes=NUM_ENVS, episode_steps=NUM_ENVS * TRAIN_STEPS,
                      mini_batch_size=NUM_ENVS, num_tests=0)
    trainer = Trainer(cfg)
    policy = trainer.init_params()
    opt_state = init_optimizer(policy)
    state, obs = trainer.venv.reset()
    state = trainer.venv.set_mirror(state, True)
    stats = EpisodeStats.init(NUM_ENVS, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_kernel.CONTROL_STEP.reset_counts()
    with counting_plain() as plain:
        t0 = time.perf_counter()
        state, obs, stats, batch, aux = trainer.rollout(policy, state, obs, stats)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt_state, m = trainer.update(policy, opt_state, batch, LR)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = dict(step_kernel.CONTROL_STEP.launches)
    check_launches("Cassie training", launches, "K2+K3", TRAIN_STEPS, plain)
    check_finite("Cassie training", {
        **{f"param {n}": p.detach() for n, p in policy.named_parameters()},
        "adam mu": opt_state.mu, "adam nu": opt_state.nu, "last_obs": obs,
        "q": state.phys.q, "qd": state.phys.qd, "ep_return": aux["ep_return"],
        **batch, "rewards": aux["rewards"], **{f"metric {k}": v for k, v in m._asdict().items()}})
    out = dict(launches=launches["K2+K3"], seconds=t2 - t0,
               env_steps_per_s=NUM_ENVS * TRAIN_STEPS / (t2 - t0),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               metrics={k: float(v) for k, v in m._asdict().items()},
               split_rollout_s=t1 - t0, split_update_s=t2 - t1,
               rollout_env_steps_per_s=NUM_ENVS * TRAIN_STEPS / (t1 - t0),
               update_ms_per_minibatch=1e3 * (t2 - t1) / (cfg.ppo_epoch * cfg.num_mini_batch),
               hits=int(aux["hits"]), dones=int(aux["ep_done"].sum()),
               mean_reward=float(aux["rewards"].mean()))
    print("K2+K3 path (Cassie training):", json.dumps(out), flush=True)
    print("K2+K3 path profile (rollout):",
          json.dumps(profile_rollout(trainer.venv, policy, state, obs)), flush=True)
    print("K2+K3 path profile (update):",
          json.dumps(profile_update(trainer.ppo_cfg, trainer.generator, policy, opt_state,
                                    batch)), flush=True)
    return out


def measurement_path() -> dict:
    """The port's measurement entry points (this slice's path), all K1 on
    discs: (a) entry(): ENTRY_CALLS forward steps at its 128 envs, exactly
    one K1 launch each, every output finite, then one step on the card
    against the same step on the CPU from the same state, draws and
    parameters (obs, reward, value, log-prob, q and qd 1e-3, the discrete
    state equal); (b) bench.run at bench.py's
    4096 envs x 100 steps, cut in depth to BENCH_REPEATS timed iteration
    and rollout chunk after one warm-up of each: exactly the K1 launches of
    its control steps, its measured halves positive and within its
    iteration; (c) the update probe at PROBE_POINT (no launch); (d) a
    profile of PROFILED_MINIBATCHES PPO minibatch steps at the bench's
    minibatch rows, mirrored, on the probe's synthetic rows."""
    import torch

    from steppingstone_tpu_torch import bench, entry, update_probe
    from steppingstone_tpu_torch.agents.mirror import MirrorSpec
    from steppingstone_tpu_torch.agents.networks import ActorCritic
    from steppingstone_tpu_torch.agents.ppo import PPOConfig, init_optimizer
    from steppingstone_tpu_torch.envs import make_env
    from steppingstone_tpu_torch.physics import step_kernel

    kernel = step_kernel.CONTROL_STEP
    started = time.perf_counter()
    out = {}
    # (a) entry()
    forward_step, (policy, state, obs) = entry.entry()
    torch.cuda.synchronize()
    kernel.reset_counts()
    with counting_plain() as plain:
        t0 = time.perf_counter()
        for _ in range(ENTRY_CALLS):
            state, obs, reward, value, log_p = forward_step(policy, state, obs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(kernel.launches)
    check_launches("entry()", launches, "K1", ENTRY_CALLS, plain)
    shapes = {"obs": (ENTRY_ENVS, 60), "reward": (ENTRY_ENVS,), "value": (ENTRY_ENVS, 1),
              "log_p": (ENTRY_ENVS, 1)}
    outs = dict(obs=obs, reward=reward, value=value, log_p=log_p)
    if {k: tuple(v.shape) for k, v in outs.items()} != shapes:
        raise AssertionError(f"entry() output shapes {[tuple(v.shape) for v in outs.values()]}")
    check_finite("entry()", {**outs, "q": state.phys.q, "qd": state.phys.qd})
    out["entry"] = dict(envs=ENTRY_ENVS, launches=launches["K1"],
                        ms_per_step=1e3 * seconds / ENTRY_CALLS)
    # one step on the card against the CPU, same state, draws, parameters
    cpu_step, (cpu_policy, cpu_state, cpu_obs) = entry.entry(device="cpu")
    draws = entry.draw_forward(make_env(entry.ENV_NAME, device="cpu"), cpu_state,
                               torch.Generator().manual_seed(2))
    policy.load_state_dict(cpu_policy.state_dict())
    ref = cpu_step(cpu_policy, cpu_state, cpu_obs, draws)
    got = forward_step(policy, _to(cpu_state, "cuda"), cpu_obs.cuda(), _to(draws, "cuda"))
    errs = {}
    for name, g, c in zip(("obs", "reward", "value", "log_p"), got[1:], ref[1:]):
        errs[f"max_{name}_err"] = float((g.cpu() - c).abs().max())
        torch.testing.assert_close(g.cpu(), c, rtol=1e-3, atol=1e-3, msg=name)
    for name in ("q", "qd"):
        g, c = getattr(got[0].phys, name).cpu(), getattr(ref[0].phys, name)
        errs[f"max_{name}_err"] = float((g - c).abs().max())
        torch.testing.assert_close(g, c, rtol=1e-3, atol=1e-3, msg=name)
    for name in ("next_step_index", "elapsed", "foot_contact", "last_hit"):
        if not torch.equal(getattr(got[0], name).cpu(), getattr(ref[0], name)):
            raise AssertionError(f"entry() card vs CPU: {name} differs")
    out["entry"].update(card_vs_cpu=errs, phase_seconds=time.perf_counter() - started)
    print("K1 path (entry):", json.dumps(out["entry"]), flush=True)
    # (b) the bench at full width; it prints its own JSON line
    control_steps = (bench.WARMUPS + BENCH_REPEATS) * (bench.ROLLOUT_CHUNK + bench.TRAIN_STEPS)
    kernel.reset_counts()
    with counting_plain() as plain:
        t0 = time.perf_counter()
        result = bench.run(bench.NUM_ENVS, bench.TRAIN_STEPS, rollout_chunk=bench.ROLLOUT_CHUNK,
                           rollout_repeats=BENCH_REPEATS, train_repeats=BENCH_REPEATS)
        seconds = time.perf_counter() - t0
    launches = dict(kernel.launches)
    check_launches("bench", launches, "K1", control_steps, plain)
    rates = [result[k] for k in ("value", "rollout_only_steps_per_s", "seconds_per_iteration")]
    halves = result["phase_breakdown_s"]
    if (result["control_steps"] != control_steps
            or not 0 < min(halves.values()) <= sum(halves.values())
            <= result["seconds_per_iteration"]
            or "control_step_warp K1, cuda" not in result["metric"]
            or not all(math.isfinite(x) and x > 0 for x in rates)
            or not all(math.isfinite(x) for x in result["final_losses"].values())):
        raise AssertionError(f"bench result: {result}")
    out["bench"] = dict(launches=launches["K1"], seconds=seconds, value=result["value"],
                        rollout_only_steps_per_s=result["rollout_only_steps_per_s"],
                        seconds_per_iteration=result["seconds_per_iteration"],
                        phase_breakdown_s=result["phase_breakdown_s"])
    # (c) one grid point of the update probe: the PPO update alone
    kernel.reset_counts()
    t0 = time.perf_counter()
    probe = update_probe.run(grid=(PROBE_POINT[0],), mirrors=(PROBE_POINT[1],))
    if any(kernel.launches.values()) or not all(math.isfinite(p["seconds"]) for p in probe):
        raise AssertionError(f"update probe: {probe}, launches {kernel.launches}")
    out["update_probe"] = dict(points=probe, seconds=time.perf_counter() - t0)
    # (d) the minibatch steps at the bench's rows, profiled
    rows = bench.minibatch_rows(bench.NUM_ENVS * bench.TRAIN_STEPS)
    cfg = PPOConfig(num_mini_batch=PROFILED_MINIBATCHES,
                    mirror=MirrorSpec.from_env(make_env(entry.ENV_NAME)))
    policy = ActorCritic(60, 21, generator=torch.Generator().manual_seed(0))
    out["update_profile"] = dict(mirrored=True, **profile_update(
        cfg, torch.Generator(device="cuda").manual_seed(0), policy, init_optimizer(policy),
        update_probe.synthetic_batch(rows * PROFILED_MINIBATCHES, "cuda"),
        PROFILED_MINIBATCHES))
    out["phase_seconds"] = time.perf_counter() - started
    print("K1 path (measurement):", json.dumps({k: out[k] for k in ("bench", "update_probe",
                                                                    "update_profile",
                                                                    "phase_seconds")}),
          flush=True)
    return out


def walker_plank_path() -> dict:
    """Walker3D on LargePlank planks: one train_iteration with
    mirror-augmented PPO at the bench.py learner shape (minibatches of
    frames // 100 rows), every step one K2 launch."""
    import torch

    from steppingstone_tpu_torch.agents.ppo import init_optimizer
    from steppingstone_tpu_torch.agents.rollout import EpisodeStats
    from steppingstone_tpu_torch.physics import step_kernel
    from steppingstone_tpu_torch.runtime.config import TrainConfig
    from steppingstone_tpu_torch.runtime.train import Trainer

    frames = NUM_ENVS * WALKER_PLANK_STEPS
    cfg = TrainConfig(env_name="Walker3DStepperEnv-v0", plank_class="LargePlank", use_mirror=True,
                      num_processes=NUM_ENVS, episode_steps=frames, mini_batch_size=frames // 100,
                      num_tests=0)
    trainer = Trainer(cfg)
    policy = trainer.init_params()
    opt_state = init_optimizer(policy)
    state, obs = trainer.venv.reset()
    stats = EpisodeStats.init(NUM_ENVS, "cuda")
    torch.cuda.synchronize()
    step_kernel.CONTROL_STEP.reset_counts()
    with counting_plain() as plain:
        t0 = time.perf_counter()
        policy, opt_state, state, obs, stats, m, aux = trainer.train_iteration(
            policy, opt_state, state, obs, stats, LR)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(step_kernel.CONTROL_STEP.launches)
    check_launches("Walker3D LargePlank training", launches, "K2", WALKER_PLANK_STEPS, plain)
    check_finite("Walker3D LargePlank training", {
        **{f"param {n}": p.detach() for n, p in policy.named_parameters()},
        "adam mu": opt_state.mu, "last_obs": obs, "q": state.phys.q,
        **{f"metric {k}": v for k, v in m._asdict().items()}})
    out = dict(launches=launches["K2"], seconds=seconds, env_steps_per_s=frames / seconds,
               hits=int(aux["hits"]), metrics={k: float(v) for k, v in m._asdict().items()})
    print("K2 path (Walker3D LargePlank training):", json.dumps(out), flush=True)
    return out


def _to(x, device):
    """A tensor, or a (nested) NamedTuple or list of them, moved to `device`."""
    if isinstance(x, list):
        return [_to(y, device) for y in x]
    if isinstance(x, tuple):
        return type(x)(*(_to(y, device) for y in x))
    return x.to(device)


def card_vs_cpu(steps: int = 8, batch: int = 16) -> dict:
    """The whole Walker3D rollout on the card against the plain path on the
    CPU, on the same draws: the card run goes through K1, the CPU run
    through the plain PyTorch version that the CPU tests hold against the
    JAX package. Not teacher forced, so fp32 differences compound through
    contact over the steps: held to 1e-3 (the CPU tests see ~5e-5 against
    JAX over 10 steps); episode ends must agree."""
    import torch

    from steppingstone_tpu_torch.agents.networks import ActorCritic
    from steppingstone_tpu_torch.agents.rollout import EpisodeStats, collect_rollout
    from steppingstone_tpu_torch.envs import make_env
    from steppingstone_tpu_torch.envs import terrain as terr
    from steppingstone_tpu_torch.envs.vector import VecEnv

    runs = {}
    cpu_env = make_env("Walker3DStepperEnv-v0", device="cpu")
    g = torch.Generator().manual_seed(1)
    cur = terr.default_curriculum(batch=batch)
    reset = cpu_env.draw_reset(cur, g)
    draws = [cpu_env.draw_step(cur, g) for _ in range(steps)]
    noise = torch.randn((steps, batch, 21), generator=g)
    policy = ActorCritic(60, 21, device="cpu", generator=torch.Generator().manual_seed(2))
    for dev in ("cpu", "cuda"):
        venv = VecEnv(make_env("Walker3DStepperEnv-v0", device=dev), batch, device=dev)
        state, obs = venv.reset(cur=_to(cur, dev), draws=_to(reset, dev))
        runs[dev] = collect_rollout(venv, policy.to(dev), state, obs,
                                    EpisodeStats.init(batch, dev), steps,
                                    action_noise=noise.to(dev), env_draws=_to(draws, dev))
    (_, _, _, tc, ac), (_, _, _, tg, ag) = runs["cpu"], runs["cuda"]
    got = dict(max_obs_err=float((tg.obs.cpu() - tc.obs).abs().max()),
               max_reward_err=float((tg.rewards.cpu() - tc.rewards).abs().max()),
               dones=int(ac["ep_done"].sum()), hits=int(ac["hits"]))
    print("card vs CPU rollout:", json.dumps(got), flush=True)
    torch.testing.assert_close(tg.obs.cpu(), tc.obs, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(tg.rewards.cpu(), tc.rewards, rtol=1e-3, atol=1e-3)
    if not torch.equal(ag["ep_done"].cpu(), ac["ep_done"]):
        raise AssertionError("episode ends differ between the card and the CPU")
    return got


def card_vs_cpu_training(steps: int = 8, batch: int = 16) -> dict:
    """One Cassie LargePlank training iteration (2 epochs x 2 minibatches)
    on the card (K2+K3) against the same iteration on the CPU (the plain
    version the CPU tests hold against the JAX package), on the same
    draws, starting mid gait cycle so that mirrored steps occur. Not
    teacher forced: obs, rewards and the updated parameters are held to
    1e-3, episode ends must agree."""
    import torch

    from steppingstone_tpu_torch.agents.ppo import init_optimizer
    from steppingstone_tpu_torch.agents.rollout import EpisodeStats
    from steppingstone_tpu_torch.envs import terrain as terr
    from steppingstone_tpu_torch.runtime.config import TrainConfig
    from steppingstone_tpu_torch.runtime.train import IterationDraws, Trainer

    cfg = TrainConfig(**CASSIE_RUN, num_processes=batch, episode_steps=batch * steps,
                      mini_batch_size=batch * steps // 2, ppo_epoch=2, num_tests=0)
    cpu = Trainer(cfg, device="cpu")
    g = torch.Generator().manual_seed(3)
    cur = terr.default_curriculum(batch=batch)
    reset = cpu.env.draw_reset(cur, g)
    draws = IterationDraws(
        action_noise=torch.randn((steps, batch, cpu.env.action_dim), generator=g),
        env_draws=[cpu.env.draw_step(cur, g) for _ in range(steps)],
        perms=torch.stack([torch.randperm(batch * steps, generator=g)
                           for _ in range(cfg.ppo_epoch)]))
    policy0 = cpu.init_params()
    runs = {}
    for dev, trainer in (("cpu", cpu), ("cuda", Trainer(cfg, device="cuda"))):
        policy = copy.deepcopy(policy0).to(dev)
        opt_state = init_optimizer(policy)
        state, obs = trainer.venv.reset(cur=_to(cur, dev), draws=_to(reset, dev))
        state = trainer.venv.set_mirror(state, True)
        state = state._replace(phase=torch.full((batch,), 0.4, device=dev))
        state, obs, _, b, aux = trainer.rollout(policy, state, obs, EpisodeStats.init(batch, dev),
                                                draws=_to(draws, dev))
        trainer.update(policy, opt_state, b, LR, perms=draws.perms.to(dev))
        runs[dev] = (b, aux, {n: p.detach().cpu() for n, p in policy.named_parameters()})
    (bc, ac, pc), (bg, ag, pg) = runs["cpu"], runs["cuda"]
    got = dict(max_obs_err=float((bg["obs"].cpu() - bc["obs"]).abs().max()),
               max_reward_err=float((ag["rewards"].cpu() - ac["rewards"]).abs().max()),
               max_param_err=max(float((pg[n] - pc[n]).abs().max()) for n in pc),
               dones=int(ac["ep_done"].sum()), hits=int(ac["hits"]))
    print("card vs CPU training iteration:", json.dumps(got), flush=True)
    torch.testing.assert_close(bg["obs"].cpu(), bc["obs"], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(ag["rewards"].cpu(), ac["rewards"], rtol=1e-3, atol=1e-3)
    if not torch.equal(ag["ep_done"].cpu(), ac["ep_done"]):
        raise AssertionError("episode ends differ between the card and the CPU")
    for n in pc:
        torch.testing.assert_close(pg[n], pc[n], rtol=1e-3, atol=1e-3, msg=n)
    return got


def urdf_path() -> dict:
    """The URDF path: TESTBOT_URDF through urdf.load_urdf, then engine.step
    at NUM_ENVS from the default pose over one flat stone and the ground
    (tests/test_urdf.py test_urdf_model_simulates): with zero torques
    exactly URDF_STEPS K4 launches, then loaded with kp/kd and held at a
    zero PD target exactly URDF_STEPS K3+K4 launches. The robot must stay
    finite and land on its spheres above -0.1 m. One more step from the
    loop's first state, from the state before its step of largest contact
    force (the landing) and from its last state is held against the plain
    version (compare_step), outside the counted run."""
    import torch

    from steppingstone_tpu_torch.physics import engine, step_kernel
    from steppingstone_tpu_torch.physics.urdf import load_urdf

    t0 = time.perf_counter()
    models = {"K4": load_urdf(TESTBOT_URDF, root_height=1.2),
              "K3+K4": load_urdf(TESTBOT_URDF, root_height=1.2, kp=60.0, kd=6.0)}
    out = {"load_s": time.perf_counter() - t0}
    for variant, model in models.items():
        state = engine.default_state(model, NUM_ENVS, "cuda")
        zeros = torch.zeros(model.njoints, device="cuda")
        stones = torch.zeros((1, 6), device="cuda")
        kw = dict(pd_target=zeros) if variant == "K3+K4" else {}
        # the same operands batched, as control_step takes them
        rest = (torch.zeros((NUM_ENVS, model.njoints), device="cuda"),
                stones.expand(NUM_ENVS, 1, 6).contiguous(),
                torch.full((NUM_ENVS,), 0.3, device="cuda"),
                torch.ones(NUM_ENVS, dtype=torch.bool, device="cuda"))
        step_kw = (dict(target=zeros.expand(NUM_ENVS, -1).contiguous(),
                        power=torch.ones(NUM_ENVS, device="cuda")) if kw else {})
        states, forces = [state], []
        torch.cuda.synchronize()
        step_kernel.CONTROL_STEP.reset_counts()
        with counting_plain() as plain:
            t0 = time.perf_counter()
            for _ in range(URDF_STEPS):
                state, info = engine.step(model, state, zeros, stones, 0.3, True, **kw)
                states.append(state)
                forces.append(info.contact_force_sum)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = dict(step_kernel.CONTROL_STEP.launches)
        check_launches(f"URDF {variant}", launches, variant, URDF_STEPS, plain, env_steps=0)
        check_finite(f"URDF {variant}", {"q": state.q, "qd": state.qd})
        forces = torch.stack(forces)
        landing = int(forces.sum(dim=1).argmax())
        checks = [compare_step(model, f"URDF {variant} ({name})",
                               (states[i].q, states[i].qd) + rest, step_kw, step=i)
                  for name, i in (("first state", 0), ("landing", landing),
                                  ("last state", URDF_STEPS))]
        if not checks[1]["envs_in_contact"] > 0:
            raise AssertionError(f"URDF {variant}: the landing step engages no contact")
        contact = forces.sum(dim=0)
        z = state.q[:, 2]
        got = dict(launches=launches[variant], ms_per_step=1e3 * seconds / URDF_STEPS,
                   root_z_min=float(z.min()), root_z_max=float(z.max()),
                   envs_with_contact=float((contact > 0).float().mean()),
                   joint_rot_rows=int((model.joint_rot != [1, 0, 0, 0]).any(axis=1).sum()),
                   checks=checks)
        if not got["root_z_min"] > -0.1 or got["envs_with_contact"] < 1.0:
            raise AssertionError(f"URDF {variant}: the robot did not land on its spheres: {got}")
        out[variant] = got
    print("URDF path:", json.dumps(out), flush=True)
    return out


def rotated_loop(env, variant: str, steps: int) -> dict:
    """engine.step `steps` times at NUM_ENVS on a rotated robot from the
    states kernel_inputs makes (the same torques or PD targets held), with
    the variant's launches counted."""
    import torch

    from steppingstone_tpu_torch.physics import engine, step_kernel

    model = env.cfg.model
    args, kw = kernel_inputs(env, NUM_ENVS, seed=11)
    state = engine.PhysicsState(args[0], args[1])
    torch.cuda.synchronize()
    step_kernel.CONTROL_STEP.reset_counts()
    with counting_plain() as plain:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, info = engine.step(model, state, *args[2:], env.cfg.contact,
                                      pd_target=kw.get("target"), pd_power=kw.get("power"),
                                      support_hy=kw.get("support_hy"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(step_kernel.CONTROL_STEP.launches)
    check_launches(f"rotated {env.cfg.name} loop", launches, variant, steps, plain,
                   env_steps=0)
    check_finite(f"rotated {env.cfg.name} loop", {"q": state.q, "qd": state.qd})
    out = dict(env=env.cfg.name, support=env.cfg.support, launches=launches[variant],
               ms_per_step=1e3 * seconds / steps,
               contact_fraction=float(info.foot_contact.float().mean()))
    print(f"{variant} path (rotated {env.cfg.name} engine.step loop):", json.dumps(out), flush=True)
    return out


def read_progress(path: str):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [dict(zip(rows[0], r)) for r in rows[1:]]


def training_loop_path(runs: str) -> dict:
    """Trainer.train on the round-5 Walker3D run, from the CLI's parser, in
    `runs`/r5_w3d (left in place for the specialist run's warm start), cut
    to UPDATES_FIRST update: 400 K2 launches and the test fleet (at update
    0) one K2 launch per step of an episode length. The same run's resume
    is checked over two ranks (sharded_loop_path)."""
    import torch

    from steppingstone_tpu_torch.physics import step_kernel
    from steppingstone_tpu_torch.runtime.checkpoint import CheckpointManager
    from steppingstone_tpu_torch.runtime.config import parse_cli
    from steppingstone_tpu_torch.runtime.train import Trainer

    exp = os.path.join(runs, "r5_w3d")
    cfg = parse_cli(R5_W3D + [f"experiment_dir={exp}"])
    cfg = parse_cli([f"num_frames={UPDATES_FIRST * cfg.episode_steps}"], base=cfg)
    trainer = Trainer(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_kernel.CONTROL_STEP.reset_counts()
    with counting_plain() as plain:
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(step_kernel.CONTROL_STEP.launches)
    steps = r5_control_steps(trainer, cfg)
    check_launches("training loop", launches, "K2", steps, plain)
    out = dict(launches=launches["K2"], control_steps=steps, seconds=seconds,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               update_times=trainer.update_times)
    # artifacts, progress.csv, finite losses
    for name in ("configs.json", "run.json", "episodes.csv", "checkpoints/latest.pt",
                 "checkpoints/best.pt"):
        if not os.path.exists(os.path.join(exp, name)):
            raise AssertionError(f"training loop: {name} is missing")
    header, rows = read_progress(os.path.join(exp, "progress.csv"))
    check_r5_progress("training loop", header, rows, UPDATES_FIRST)
    # the checkpoint: its save and restore, the installed level
    ckpt = CheckpointManager(os.path.join(exp, "checkpoints"))
    t0 = time.perf_counter()
    after = ckpt.restore("latest")
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.save("smoke_copy", after)
    save_s = time.perf_counter() - t0
    check_r5_snapshot("training loop", after, UPDATES_FIRST)
    out.update(
        progress=[{k: r[k] for k in ("iter", "fps", "value_loss", "action_loss", "mean_rew",
                                     "test_mean_rew")} for r in rows],
        checkpoint_bytes=os.path.getsize(ckpt.path("latest")),
        checkpoint_save_s=save_s, checkpoint_restore_s=restore_s,
        curriculum=after["curriculum"])
    print("K2 path (training loop, round-5 Walker3D):", json.dumps(out), flush=True)
    return out


def r5_control_steps(trainer, cfg) -> int:
    """The control steps of a round-5 Trainer.train call: num_steps an
    update and an episode length of the test fleet every test_interval."""
    ran = range(trainer.start_update, cfg.num_updates)
    tests = sum(1 for j in ran if j % cfg.test_interval == 0)
    return len(ran) * cfg.num_steps + tests * trainer.env.cfg.max_episode_steps


def check_r5_progress(what: str, header, rows, updates: int) -> None:
    """progress.csv of a round-5 run over `updates` updates: the reference
    header, a row per update, finite losses, the test columns fresh at
    update 1 (test_interval 10) and blank after."""
    if header != PROGRESS_HEADER:
        raise AssertionError(f"{what}: progress.csv header {header}")
    if [int(r["iter"]) for r in rows] != list(range(1, updates + 1)):
        raise AssertionError(f"{what}: progress.csv rows for updates {[r['iter'] for r in rows]}")
    for r in rows:
        for col in ("entropy", "value_loss", "action_loss", "mean_rew"):
            if not math.isfinite(float(r[col])):
                raise AssertionError(f"{what}: progress.csv update {r['iter']}: {col} = {r[col]}")
    if rows[0]["test_mean_rew"] == "" or any(r["test_mean_rew"] != "" for r in rows[1:]):
        raise AssertionError(f"{what}: test columns fresh at update 1 and blank after expected")


def check_r5_snapshot(what: str, snap: dict, update: int) -> None:
    """A round-5 run's checkpoint after `update` updates: its counter, and
    the fixed curriculum's level installed on every env of the fleet."""
    import torch

    if snap["update"] != update:
        raise AssertionError(f"{what}: the checkpoint holds update {snap['update']}")
    if not torch.all(snap["env_state"]["cur"]["level"] == snap["curriculum"]["fixed_frac"]):
        raise AssertionError(f"{what}: the installed level differs from the curriculum's")


def mike_path() -> dict:
    """Trainer.train on the round-5 Mike run, from the CLI's parser, cut to
    one update: its control steps and its test fleet's episode length,
    each one K2 launch (MIKE_LAUNCHES); progress.csv with the reference
    header, finite losses and the test fleet's columns; the update's
    rollout / update / test fleet split."""
    import torch

    from steppingstone_tpu_torch.physics import step_kernel
    from steppingstone_tpu_torch.runtime.config import parse_cli
    from steppingstone_tpu_torch.runtime.train import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, "r5_mike_scratch")
        cfg = parse_cli(R5_MIKE + [f"experiment_dir={exp}"])
        cfg = parse_cli([f"num_frames={cfg.episode_steps}"], base=cfg)
        trainer = Trainer(cfg)
        env = trainer.env.cfg
        if (env.name, env.model.name, env.support, env.plank_hy) != (
                "MikeStepperEnv-v0", "mike", "plank", 1.5):
            raise AssertionError(f"the Mike run built {env.name} ({env.model.name}, "
                                 f"{env.support} {env.plank_hy})")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_kernel.CONTROL_STEP.reset_counts()
        with counting_plain() as plain:
            t0 = time.perf_counter()
            trainer.train()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = dict(step_kernel.CONTROL_STEP.launches)
        steps = cfg.num_updates * cfg.num_steps + env.max_episode_steps
        if steps != MIKE_LAUNCHES:
            raise AssertionError(f"the Mike run takes {steps} control steps")
        check_launches("Mike training loop", launches, "K2", steps, plain)
        header, rows = read_progress(os.path.join(exp, "progress.csv"))
    if header != PROGRESS_HEADER:
        raise AssertionError(f"Mike progress.csv header {header}")
    if [r["iter"] for r in rows] != ["1"]:
        raise AssertionError(f"Mike progress.csv rows for updates {[r['iter'] for r in rows]}")
    for col in ("entropy", "value_loss", "action_loss", "mean_rew", "test_mean_rew"):
        if not math.isfinite(float(rows[0][col])):
            raise AssertionError(f"Mike progress.csv: {col} = {rows[0][col]}")
    out = dict(env=env.name, model=env.model.name, launches=launches["K2"], control_steps=steps,
               seconds=seconds, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               split=trainer.update_times[0],
               rollout_ms_per_step=1e3 * trainer.update_times[0]["rollout_s"] / cfg.num_steps,
               test_ms_per_step=1e3 * trainer.update_times[0]["test_s"] / env.max_episode_steps,
               progress={k: rows[0][k] for k in ("fps", "entropy", "value_loss", "action_loss",
                                                  "mean_rew", "test_mean_rew")})
    print("K2 path (training loop, round-5 Mike):", json.dumps(out), flush=True)
    return out


def host_softmax(x):
    """softmax over a flat array, in float64 on the host."""
    import numpy as np

    e = np.exp(np.asarray(x, np.float64).reshape(-1) - np.max(x))
    return (e / e.sum()).reshape(np.shape(x))


def threshold_path() -> dict:
    """Trainer.train on the round-5 threshold-sampling run, from the CLI's
    parser (R5_THR150): 1 update (the uniform round and the test fleet),
    then resume=True to 2 (the value grid's 160 steps at 16 envs and the
    update), each exactly THR_LAUNCHES K2 launches. Checks the first call's
    snapshot (the threshold's round counter, the assist ladder, level 5
    installed), the pickles after the resume (one (11, 11) array each, the
    probabilities summing to 1 and installed on every env, the grid finite
    and normalized) and progress.csv. Then, outside the
    counted runs: the candidate observations and the critic ensemble's
    values on 16 of the fleet's envs on the card against the CPU, and one
    AdaptiveSampling.pre_update on the card with the trained policy (160
    K2 launches at 16 envs), its probabilities against softmax(-150 grid)
    computed on the host."""
    import pickle

    import numpy as np
    import torch

    from steppingstone_tpu_torch.envs import make_env
    from steppingstone_tpu_torch.envs.stepper import create_temp_states, env_state_from_numpy
    from steppingstone_tpu_torch.physics import step_kernel
    from steppingstone_tpu_torch.runtime import curriculum as curr
    from steppingstone_tpu_torch.runtime.checkpoint import CheckpointManager
    from steppingstone_tpu_torch.runtime.config import parse_cli
    from steppingstone_tpu_torch.runtime.train import Trainer

    if (curr.EVAL_ENVS, curr.EVAL_STEPS) != (GRID_ENVS, GRID_STEPS):
        raise AssertionError(f"the value grid runs {curr.EVAL_ENVS} envs x {curr.EVAL_STEPS}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, "r5_thr150")
        ckpt = CheckpointManager(os.path.join(exp, "checkpoints"))
        for phase, updates, extra in (("first", 1, []), ("resumed", 2, ["resume=True"])):
            cfg = parse_cli(R5_THR150 + [f"experiment_dir={exp}"] + extra)
            cfg = parse_cli([f"num_frames={updates * cfg.episode_steps}"], base=cfg)
            trainer = Trainer(cfg)
            torch.cuda.synchronize()
            step_kernel.CONTROL_STEP.reset_counts()
            with counting_plain() as plain:
                t0 = time.perf_counter()
                policy = trainer.train()
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            launches = dict(step_kernel.CONTROL_STEP.launches)
            check_launches(f"threshold loop ({phase})", launches, "K2", THR_LAUNCHES[phase],
                           plain)
            snap = ckpt.restore("latest")
            c, cur = snap["curriculum"], snap["env_state"]["cur"]
            out[phase] = dict(launches=launches["K2"], start_update=trainer.start_update,
                              seconds=seconds, update_times=trainer.update_times, curriculum=c)
            if phase == "first":
                # post_test turned the uniform rounds off; the ladder holds
                # the carpet; the uniform round installed level 5 uniformly
                if (c["thr_uniform_counter"], c["thr_uniform_sampling"], c["assist_level"]) != (
                        2, False, 0):
                    raise AssertionError(f"threshold snapshot after update 1: {c}")
                if not (torch.all(cur["level"] == 5) and not cur["use_prob"].any()
                        and torch.all(cur["assist"] == 0)):
                    raise AssertionError("update 1 did not install the uniform round")
        if out["resumed"]["start_update"] != 1 or out["resumed"]["curriculum"][
                "thr_uniform_counter"] != 3:
            raise AssertionError(f"the resumed threshold run: {out['resumed']}")
        # the value grid's round, logged and installed
        pkl = {}
        for what in ("sampling_prob", "value_grid"):
            with open(os.path.join(exp, f"{cfg.env_name}_{what}.pkl"), "rb") as f:
                pkl[what] = pickle.load(f)
            if len(pkl[what]) != 1 or np.shape(pkl[what][0]) != (11, 11):
                raise AssertionError(f"{what}.pkl holds {[np.shape(x) for x in pkl[what]]}")
        probs, grid = pkl["sampling_prob"][0], pkl["value_grid"][0]
        count = trainer.value_grid.last_count
        # update 2's curriculum hooks: the value grid and installing its
        # probabilities
        grid_seconds = trainer.update_times[-1]["curriculum_s"]
        if not abs(float(probs.sum()) - 1.0) < 1e-5:
            raise AssertionError(f"the probabilities sum to {probs.sum()}")
        installed = cur["sample_prob"].numpy()
        if not (np.abs(installed - probs).max() < 1e-6 and cur["use_prob"].all()):
            raise AssertionError("the fleet does not sample from the value grid's probabilities")
        if not np.isfinite(grid).all() or (count > 0 and abs(np.abs(grid).max() - 1.0) > 1e-6):
            raise AssertionError(f"value grid: count {count}, max |grid| {np.abs(grid).max()}")
        header, rows = read_progress(os.path.join(exp, "progress.csv"))
        if header != PROGRESS_HEADER or [r["iter"] for r in rows] != ["1", "2"]:
            raise AssertionError(f"threshold progress.csv {header}, rows "
                                 f"{[r['iter'] for r in rows]}")
        for r in rows:
            for col in ("entropy", "value_loss", "action_loss", "mean_rew"):
                if not math.isfinite(float(r[col])):
                    raise AssertionError(f"threshold progress.csv update {r['iter']}: {col}")
    out.update(grid_events=count, grid_seconds=grid_seconds,
               grid_ms_per_step=1e3 * grid_seconds / GRID_STEPS,
               probs_max=float(probs.max()), probs_min=float(probs.min()),
               grid_min=float(grid.min()), grid_max=float(grid.max()),
               progress=[{k: r[k] for k in ("iter", "fps", "value_loss", "mean_rew",
                                            "test_mean_rew")} for r in rows])

    # card against CPU: candidate observations and critic values on 16 of
    # the fleet's envs (the snapshot's copy on the host)
    def first(tree, n):
        return {k: first(v, n) if isinstance(v, dict) else v[:n] for k, v in tree.items()}

    states = {dev: env_state_from_numpy(first(snap["env_state"], GRID_ENVS), dev)
              for dev in ("cpu", "cuda")}
    cpu_env = make_env(cfg.env_name, device="cpu", plank_class=cfg.plank_class)
    temp = {"cuda": create_temp_states(trainer.env.cfg, states["cuda"]),
            "cpu": create_temp_states(cpu_env.cfg, states["cpu"])}
    cpu_policy = copy.deepcopy(policy).to("cpu")
    with torch.no_grad():
        values = {"cuda": policy.ensemble_values(temp["cuda"]),
                  "cpu": cpu_policy.ensemble_values(temp["cpu"])}
    got = dict(max_temp_err=float((temp["cuda"].cpu() - temp["cpu"]).abs().max()),
               max_value_err=float((values["cuda"].cpu() - values["cpu"]).abs().max()),
               next_step_index=sorted(set(states["cpu"].next_step_index.tolist())))
    print("card vs CPU temp states:", json.dumps(got), flush=True)
    torch.testing.assert_close(temp["cuda"].cpu(), temp["cpu"], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(values["cuda"].cpu(), values["cpu"], rtol=1e-3, atol=1e-3)
    out["card_vs_cpu"] = got

    # AdaptiveSampling.pre_update on the card, the trained policy and state
    adaptive = curr.AdaptiveSampling(trainer.venv, trainer.env, scale=float(cfg.sampling_scale),
                                     value_grid=trainer.value_grid)
    state = env_state_from_numpy(snap["env_state"], "cuda")
    torch.cuda.synchronize()
    step_kernel.CONTROL_STEP.reset_counts()
    with counting_plain() as plain:
        t0 = time.perf_counter()
        state = adaptive.pre_update(state, policy)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(step_kernel.CONTROL_STEP.launches)
    check_launches("AdaptiveSampling.pre_update", launches, "K2", GRID_STEPS, plain)
    expected = host_softmax(-float(cfg.sampling_scale) * adaptive.last_grid)
    if not (np.abs(adaptive.last_probs - expected).max() < 1e-6
            and torch.allclose(state.cur.sample_prob.cpu(),
                               torch.as_tensor(adaptive.last_probs).expand(R5_ENVS, 11, 11),
                               rtol=0, atol=1e-6)
            and state.cur.use_prob.all()):
        raise AssertionError("AdaptiveSampling's probabilities or their installation differ")
    out["adaptive"] = dict(launches=launches["K2"], seconds=seconds,
                           ms_per_step=1e3 * seconds / GRID_STEPS,
                           events=trainer.value_grid.last_count,
                           max_prob_err=float(np.abs(adaptive.last_probs - expected).max()))
    print("K2 path (training loop, round-5 threshold sampling):", json.dumps(out), flush=True)
    return out


def specialist_path(runs: str, w3d_exp: str) -> dict:
    """Trainer.train on the round-5 specialist run, from the CLI's parser,
    warm-started from the round-5 Walker3D loop's checkpoints/best (its
    latest where the cut loop wrote no best) and cut to one update: the
    policy after init_params is the checkpoint's exactly but for logstd,
    all -2.0; exactly SPECIALIST_LAUNCHES K2 launches and nothing else;
    progress.csv with the reference header and finite losses; the update's
    split."""
    import torch

    from steppingstone_tpu_torch.physics import step_kernel
    from steppingstone_tpu_torch.runtime.checkpoint import CheckpointManager
    from steppingstone_tpu_torch.runtime.config import parse_cli
    from steppingstone_tpu_torch.runtime.train import Trainer

    source = CheckpointManager(os.path.join(w3d_exp, "checkpoints"))
    tag = "best" if source.exists("best") else "latest"
    net = os.path.join(source.directory, tag)
    exp = os.path.join(runs, "r5_specialist")
    cfg = parse_cli(R5_SPECIALIST + [f"net={net}", f"experiment_dir={exp}"])
    cfg = parse_cli([f"num_frames={cfg.episode_steps}"], base=cfg)
    trainer = Trainer(cfg)
    weights = source.restore(tag)["policy"]
    warm = trainer.init_params().state_dict()
    if warm.keys() != weights.keys() or not all(
            torch.equal(warm[k].cpu(), weights[k]) for k in weights if k != "logstd"):
        raise AssertionError(f"the warm start differs from {net}")
    if not torch.equal(warm["logstd"].cpu(), torch.full_like(weights["logstd"], -2.0)):
        raise AssertionError(f"warm-start logstd {warm['logstd'].tolist()}")
    torch.cuda.synchronize()
    step_kernel.CONTROL_STEP.reset_counts()
    with counting_plain() as plain:
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(step_kernel.CONTROL_STEP.launches)
    check_launches("specialist loop", launches, "K2", SPECIALIST_LAUNCHES, plain)
    header, rows = read_progress(os.path.join(exp, "progress.csv"))
    if header != PROGRESS_HEADER or [r["iter"] for r in rows] != ["1"]:
        raise AssertionError(f"specialist progress.csv {header}, rows {[r['iter'] for r in rows]}")
    for col in ("entropy", "value_loss", "action_loss", "mean_rew", "test_mean_rew"):
        if not math.isfinite(float(rows[0][col])):
            raise AssertionError(f"specialist progress.csv: {col} = {rows[0][col]}")
    ckpt = CheckpointManager(os.path.join(exp, "checkpoints"))
    out = dict(warm_start=tag, launches=launches["K2"], seconds=seconds,
               split=trainer.update_times[0],
               rollout_ms_per_step=1e3 * trainer.update_times[0]["rollout_s"] / cfg.num_steps,
               test_ms_per_step=(1e3 * trainer.update_times[0]["test_s"]
                                 / trainer.env.cfg.max_episode_steps),
               specialist=ckpt.restore("latest")["curriculum"]["specialist"],
               specialist_files=[t for t in ckpt.tags() if t.startswith("specialist_")],
               progress={k: rows[0][k] for k in ("fps", "entropy", "value_loss", "action_loss",
                                                  "mean_rew", "test_mean_rew")})
    print("K2 path (training loop, round-5 specialist, warm-started):", json.dumps(out),
          flush=True)
    return dict(out, exp=exp)


# the trajectory dump's arrays (runtime/enjoy.py write_dump), as the JAX
# package's enjoy writes them (tests/test_torch_enjoy.py holds the two
# equal): name -> (shape with T steps, NB bodies, A actions, S stones, K
# value grids; dtype)
DUMP = {"body_pos": (("T", "NB", 3), "float32"), "body_quat": (("T", "NB", 4), "float32"),
        "rewards": (("T",), "float64"), "contacts": (("T", 2), "bool"),
        "actions": (("T", "A"), "float32"), "values": (("T",), "float64"),
        "stones": (("S", 6), "float32"), "body_names": (("NB",), "<U16"),
        "joint_names": (("A",), "<U16"), "value_grids": (("K", 11, 11), "float32")}


def check_dump(path: str, cfg) -> dict:
    """The dump's keys, shapes and dtypes against DUMP (an empty value-grid
    stack is float64, as numpy's zeros). Returns T and K."""
    import numpy as np

    data = np.load(path)
    dims = dict(T=len(data["rewards"]), NB=cfg.model.nbodies, A=cfg.action_dim,
                S=cfg.n_stones, K=len(data["value_grids"]))
    want = {k: (tuple(dims.get(d, d) for d in shape), dtype) for k, (shape, dtype) in DUMP.items()}
    if not dims["K"]:
        want["value_grids"] = ((0, 11, 11), "float64")
    got = {k: (data[k].shape, str(data[k].dtype)) for k in data.files}
    if got != {k: (shape, str(np.dtype(d))) for k, (shape, d) in want.items()}:
        raise AssertionError(f"{path}: {got}, expected {want}")
    return dict(steps=dims["T"], value_grids=dims["K"])


def enjoy_paths(runs: str, spec_exp: str) -> dict:
    """enjoy.main on the card: (a) Walker3D on LargePlank from the
    specialist run's checkpoints/latest with --plot-value --dump, exactly
    one K2 launch per step of the episode, the dump as DUMP; (b) the same
    policy pickled in the reference's layout (tests/reference_policy.py, as
    the CPU tests build one), loaded equal to it, and run on the default
    disc config: one K1 launch per step. No specialist_<k> file is read.
    Then a profile of an enjoy step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from steppingstone_tpu_torch.envs import make_env
    from steppingstone_tpu_torch.physics import step_kernel
    from steppingstone_tpu_torch.runtime import enjoy
    from steppingstone_tpu_torch.runtime.checkpoint import CheckpointManager

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from reference_policy import write_reference_policy

    latest = os.path.join(spec_exp, "checkpoints", "latest")
    weights = CheckpointManager.read(f"{latest}.pt")["policy"]
    ref_pt = os.path.join(runs, "ref.pt")
    write_reference_policy(ref_pt, 60, 21, 1, state=weights)
    out = {}
    for name, variant, argv in (
            ("plank", "K2", ["--plank-class", "LargePlank", "--net", latest, "--plot-value"]),
            ("reference", "K1", ["--net", ref_pt])):
        dump = os.path.join(runs, f"enjoy_{name}.npz")
        torch.cuda.synchronize()
        step_kernel.CONTROL_STEP.reset_counts()
        with counting_plain() as plain:
            t0 = time.perf_counter()
            enjoy.main(argv + ["--steps", str(ENJOY_STEPS), "--dump", dump])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = dict(step_kernel.CONTROL_STEP.launches)
        env = make_env("Walker3DStepperEnv-v0", **({"plank_class": "LargePlank"}
                                                   if variant == "K2" else {}))
        got = check_dump(dump, env.cfg)
        check_launches(f"enjoy ({name})", launches, variant, got["steps"], plain)
        out[name] = dict(got, launches=launches[variant], seconds=seconds,
                         ms_per_step=1e3 * seconds / got["steps"])
    state, n = enjoy.load_params(ref_pt, env, 1)
    if n != 1 or state.keys() != weights.keys() or not all(
            torch.equal(state[k].cpu(), weights[k]) for k in weights):
        raise AssertionError("the reference pickle does not load as the policy it was made of")
    # where an enjoy step's time goes: its first steps on LargePlank under
    # torch.profiler, after the counted runs
    env = make_env("Walker3DStepperEnv-v0", plank_class="LargePlank")
    policy = enjoy.policy_from_state(weights, env, 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        episode = enjoy.run_episode(env, policy, 5, False, 0,
                                    generator=torch.Generator(env.device).manual_seed(0))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    out["profile"] = device_time(prof, wall_ms, episode["steps"])
    print("enjoy paths:", json.dumps(out), flush=True)
    return out


def card_vs_cpu_episode(spec_exp: str, steps: int = CARD_CPU_EPISODE_STEPS) -> dict:
    """enjoy.run_episode of the specialist run's policy on Walker3D
    LargePlank, on the card (K2) and on the CPU (the plain version the CPU
    tests hold against the JAX package), from the same draws: frames,
    rewards, actions, values and value grids within 1e-3; contacts, hits
    and steps equal."""
    import numpy as np
    import torch

    from steppingstone_tpu_torch.envs import make_env
    from steppingstone_tpu_torch.envs import terrain as terr
    from steppingstone_tpu_torch.runtime import enjoy
    from steppingstone_tpu_torch.runtime.checkpoint import CheckpointManager

    weights = CheckpointManager.read(os.path.join(spec_exp, "checkpoints", "latest.pt"))["policy"]
    cur = terr.default_curriculum(batch=1)
    cpu_env = make_env("Walker3DStepperEnv-v0", device="cpu", plank_class="LargePlank")
    cpu_policy = enjoy.policy_from_state(weights, cpu_env, 1, "cpu")
    # the first of a few seeds whose CPU episode hits a stone, so that a
    # value grid is compared too
    for seed in range(6):
        g = torch.Generator().manual_seed(seed)
        reset = cpu_env.draw_reset(cur, g)
        draws = [cpu_env.draw_step(cur, g) for _ in range(steps)]
        c = enjoy.run_episode(cpu_env, cpu_policy, steps, True, 0, reset_draws=reset,
                              step_draws=draws)
        if c["hits"]:
            break
    env = make_env("Walker3DStepperEnv-v0", plank_class="LargePlank")
    k = enjoy.run_episode(env, enjoy.policy_from_state(weights, env, 1), steps, True, 0,
                          reset_draws=_to(reset, "cuda"), step_draws=_to(draws, "cuda"))
    err = lambda a, b: float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
    got = dict(seed=seed, steps=k["steps"], hits=k["hits"], value_grids=len(k["value_grids"]),
               max_frame_err=max(err([f[i] for f in k["frames"]], [f[i] for f in c["frames"]])
                                 for i in range(2)),
               **{f"max_{f}_err": err(k[f], c[f]) for f in ("rewards", "actions", "values")})
    if k["value_grids"]:
        got["max_grid_err"] = err(k["value_grids"], c["value_grids"])
    print("card vs CPU episode:", json.dumps(got), flush=True)
    if (k["steps"], k["hits"], len(k["value_grids"])) != (
            c["steps"], c["hits"], len(c["value_grids"])):
        raise AssertionError(f"steps, hits or grids differ: card {got}, CPU {c['steps']}, "
                             f"{c['hits']}, {len(c['value_grids'])}")
    if not np.array_equal(k["contacts"], c["contacts"]):
        raise AssertionError("foot contacts differ between the card and the CPU")
    for f in ("frames", "rewards", "actions", "values", "value_grids"):
        pairs = ([(np.stack([x[i] for x in k[f]]), np.stack([x[i] for x in c[f]]))
                  for i in range(2)] if f == "frames" else [(k[f], c[f])])
        for a, b in pairs:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-3,
                                       err_msg=f)
    return got


def behavior_keys() -> tuple:
    """(top-level keys, {per-entry key: its rounding unit, None for an
    integer}) of scripts/behavior_eval.py's report, read from its source
    (this script imports no JAX): `report = {...}` and `report[label] =
    {...}`, each value's unit from the `round(x, n)` in it."""
    import ast

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "behavior_eval.py")
    top, entry = None, None
    for node in ast.walk(ast.parse(open(path).read())):
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name) and target.id == "report":
            top = {k.value for k in node.value.keys}
        elif isinstance(target, ast.Subscript) and getattr(target.value, "id", "") == "report":
            entry = {}
            for k, v in zip(node.value.keys, node.value.values):
                digits = [c.args[1].value for c in ast.walk(v) if isinstance(c, ast.Call)
                          and getattr(c.func, "id", "") == "round"]
                entry[k.value] = 10.0 ** -digits[0] if digits else None
    return top, entry


def check_behavior(what: str, report: dict, labels: list) -> None:
    """A behavior report: the JAX script's keys, every number finite, and
    the counts consistent (falls and whole-track walks are episodes)."""
    top, entry = behavior_keys()
    if set(report) != top | set(labels):
        raise AssertionError(f"{what}: keys {sorted(report)}, expected {sorted(top)} + {labels}")
    for label in labels:
        e = report[label]
        if set(e) != set(entry) or len(entry) != 15:
            raise AssertionError(f"{what} {label}: keys {sorted(e)}, expected {sorted(entry)}")
        if not all(isinstance(v, (int, float)) and math.isfinite(v) for v in e.values()):
            raise AssertionError(f"{what} {label}: a value is missing or not finite: {e}")
        done = e["episodes_completed"]
        if not (e["falls"] <= done and e["walked_whole_track"] + e["falls_before_track_end"]
                <= done):
            raise AssertionError(f"{what} {label}: inconsistent counts {e}")


def behavior_paths(w3d_exp: str) -> dict:
    """behavior_eval.main on the card on the round-5 Walker3D loop's
    checkpoints (BEHAVIOR_RUNS): exactly each run's launches of its variant
    and nothing else, the report checked (check_behavior); the host's ms a
    control step; then one entry under torch.profiler, and one LargePlank
    entry on the card against the CPU from the same draws (integer fields
    equal, floats within 1e-3 or one unit of the key's rounding)."""
    import io

    import torch
    from torch.profiler import ProfilerActivity, profile

    from steppingstone_tpu_torch.envs import make_env
    from steppingstone_tpu_torch.envs import terrain as terr
    from steppingstone_tpu_torch.envs.vector import VecEnv
    from steppingstone_tpu_torch.physics import step_kernel
    from steppingstone_tpu_torch.runtime import behavior_eval, enjoy

    started = time.perf_counter()
    out = {}
    base = [w3d_exp, "--envs", str(BEHAVIOR_ENVS), "--steps", str(BEHAVIOR_STEPS),
            "--tag", "latest"]
    for name, (flags, variant, expected) in BEHAVIOR_RUNS.items():
        torch.cuda.synchronize()
        step_kernel.CONTROL_STEP.reset_counts()
        with counting_plain() as plain, contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            report = behavior_eval.main(base + flags)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = dict(step_kernel.CONTROL_STEP.launches)
        check_launches(f"behavior evaluation ({name})", launches, variant, expected, plain)
        labels = [k for k in report if k.startswith(("level_", "band_"))]
        check_behavior(name, report, labels)
        out[name] = dict(launches=launches[variant], seconds=seconds,
                         ms_per_step=1e3 * seconds / expected,
                         report={k: report[k] for k in labels})
    # where a step's time goes: a few steps of one LargePlank entry, after
    # the counted runs
    env = make_env("Walker3DStepperEnv-v0", plank_class="LargePlank")
    state, n = enjoy.load_params(os.path.join(w3d_exp, "checkpoints", "latest"), env, 1)
    policy = enjoy.policy_from_state(state, env, n)
    venv = VecEnv(env, BEHAVIOR_ENVS, seed=behavior_eval.SEED)
    cur = terr.default_curriculum(0, batch=BEHAVIOR_ENVS, device=env.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        behavior_eval.evaluate_entry(venv, policy, cur, 5)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    out["profile"] = device_time(prof, wall_ms, 5)
    out["card_vs_cpu"] = behavior_card_vs_cpu(w3d_exp)
    out["phase_seconds"] = time.perf_counter() - started
    print("behavior evaluation paths:", json.dumps(out), flush=True)
    return out


def behavior_card_vs_cpu(w3d_exp: str) -> dict:
    """One LargePlank entry of behavior_eval.main (BEHAVIOR_CPU_ENVS x
    BEHAVIOR_CPU_STEPS, level 0) on the card (K2) and on the CPU, from the
    same draws, made on the CPU."""
    import io

    import torch

    from steppingstone_tpu_torch.envs import make_env
    from steppingstone_tpu_torch.runtime import behavior_eval

    cpu_env = make_env("Walker3DStepperEnv-v0", device="cpu", plank_class="LargePlank")

    def draws(label, cur):
        # free-running draws from one CPU generator, on the entry's device
        g, c = torch.Generator().manual_seed(11), _to(cur, "cpu")
        reset = cpu_env.draw_reset(c, g)
        steps = iter([cpu_env.draw_step(c, g) for _ in range(BEHAVIOR_CPU_STEPS)])
        dev = cur.level.device
        return _to(reset, dev), lambda done: _to(next(steps), dev)

    argv = [w3d_exp, "--envs", str(BEHAVIOR_CPU_ENVS), "--steps", str(BEHAVIOR_CPU_STEPS),
            "--levels", "0", "--plank_class", "LargePlank"]
    with contextlib.redirect_stdout(io.StringIO()):
        card_report = behavior_eval.main(argv, draws=draws)
        cpu = behavior_eval.main(argv, device="cpu", draws=draws)["level_0"]
    check_behavior("card vs CPU", card_report, ["level_0"])
    card = card_report["level_0"]
    if card["episodes_completed"] < 1:
        raise AssertionError(f"card vs CPU: no episode ended inside the window: {card}")
    for k, unit in behavior_keys()[1].items():
        ok = (card[k] == cpu[k] if unit is None
              else abs(card[k] - cpu[k]) <= max(1e-3, unit) + 1e-9)
        if not ok:
            raise AssertionError(f"card vs CPU: {k} card {card[k]}, CPU {cpu[k]}")
    got = dict(card=card, cpu=cpu)
    print("behavior evaluation, card vs CPU:", json.dumps(got), flush=True)
    return got


def resume_is_total(num_envs: int = 256, steps: int = 16) -> dict:
    """2 + 2 updates against 4 unbroken (Walker3D, fixed curriculum, no test
    fleet, as tests/test_runtime.py runs it): every progress.csv column but
    fps within rel 1e-5 / abs 1e-6. On a miss a second unbroken run tells
    the card's run-to-run nondeterminism from a resume fault; the largest
    difference and its source are printed, and only a resume fault fails."""
    from steppingstone_tpu_torch.runtime.config import parse_cli
    from steppingstone_tpu_torch.runtime.train import Trainer

    base = ["env_name=Walker3DStepperEnv-v0", f"num_processes={num_envs}",
            f"episode_steps={num_envs * steps}", "num_tests=0", "use_curriculum=True",
            "seed=3", "checkpoint_interval=1"]
    frames = num_envs * steps

    def run(exp, updates, resume=False):
        Trainer(parse_cli(base + [f"num_frames={updates * frames}", f"experiment_dir={exp}",
                                  f"resume={resume}"])).train()
        return read_progress(os.path.join(exp, "progress.csv"))

    def largest_diff(a, b):
        """(excess over the tolerance, column, update) of the worst miss,
        or None when every value is within it."""
        if [r["iter"] for r in a] != [r["iter"] for r in b]:
            return (math.inf, "iter", None)
        misses = []
        for ra, rb in zip(a, b):
            for col in PROGRESS_HEADER:
                if col == "fps" or ra[col] == rb[col]:
                    continue
                if "" in (ra[col], rb[col]):
                    misses.append((math.inf, col, ra["iter"]))
                    continue
                va, vb = float(ra[col]), float(rb[col])
                misses.append((abs(va - vb) - (1e-6 + 1e-5 * abs(vb)), col, ra["iter"]))
        misses = [m for m in misses if m[0] > 0]
        return max(misses) if misses else None

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _, unbroken = run(os.path.join(tmp, "a"), 4)
        run(os.path.join(tmp, "b"), 2)
        _, resumed = run(os.path.join(tmp, "b"), 4, resume=True)
        miss = largest_diff(unbroken, resumed)
        got = dict(rows=len(unbroken), seconds=time.perf_counter() - t0, holds=miss is None)
        if miss is not None:
            _, again = run(os.path.join(tmp, "c"), 4)
            noise = largest_diff(unbroken, again)
            got.update(largest_excess=miss[0], column=miss[1], iter=miss[2],
                       source="the resume" if noise is None
                       else "the card's run-to-run nondeterminism", unbroken_rerun=noise)
    print("resume is total:", json.dumps(got), flush=True)
    if not got["holds"] and got["source"] == "the resume":
        raise AssertionError(f"a resumed run differs from the unbroken one: {got}")
    return got


def sharded_dryrun_path() -> dict:
    """parallel.dryrun_multichip on the card: one Walker3D training
    iteration at DRYRUN_ENVS envs x dryrun.STEPS steps (mirror on,
    minibatches of half the frames) over SHARDED_RANKS gloo ranks on the
    card, against the same iteration in this process: the losses within
    the JAX package's rel 1e-3, every rank exactly dryrun.STEPS K1 launches
    (its counts set to 0 just before) and nothing else."""
    from steppingstone_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    out = dryrun.dryrun_multichip(SHARDED_RANKS, backend="gloo", n_envs=DRYRUN_ENVS,
                                  local_rank=0)
    for r in out["ranks"]:
        check_launches(f"dry run, rank {r['rank']}", r["launches"], "K1", dryrun.STEPS, None)
    got = dict(ranks=SHARDED_RANKS, envs_per_rank=DRYRUN_ENVS // SHARDED_RANKS,
               launches=[r["launches"]["K1"] for r in out["ranks"]],
               largest_rel_loss_diff=max(out["rel"].values()), rel=out["rel"],
               losses={k: out["ranks"][0]["metrics"][k] for k in out["rel"]},
               seconds=time.perf_counter() - t0)
    print("K1 path (sharded dry run):", json.dumps(got), flush=True)
    return dict(got, single=out["single"])


def nccl_world_one(single: dict) -> dict:
    """One rank under NCCL (the card's backend) at world size 1 runs the
    dry run's iteration through every collective of the sharded trainer;
    its metrics, parameters and observations must equal the iteration
    without a process group (`single`, the dry run's) bit for bit."""
    import numpy as np

    from steppingstone_tpu_torch.parallel import dryrun, launch

    t0 = time.perf_counter()
    [rank] = launch.spawn(dryrun.rank_iteration, 1, (DRYRUN_ENVS,))
    diffs = {"metrics": max(abs(rank["metrics"][k] - single["metrics"][k])
                            for k in single["metrics"]),
             "params": float(np.abs(rank["params"] - single["params"]).max()),
             "obs": float(np.abs(rank["obs"] - single["obs"]).max())}
    got = dict(backend=rank["backend"], world=rank["world"], largest_diffs=diffs,
               bit_for_bit=(rank["metrics"] == single["metrics"]
                            and np.array_equal(rank["params"], single["params"])
                            and np.array_equal(rank["obs"], single["obs"])),
               seconds=time.perf_counter() - t0)
    print("NCCL at world size 1:", json.dumps(got), flush=True)
    if rank["backend"] != "nccl" or not got["bit_for_bit"]:
        raise AssertionError(f"NCCL at world size 1 differs from one process: {got}")
    return got


def sharded_loop_rank(exp: str) -> dict:
    """One rank of the round-5 Walker3D run over SHARDED_RANKS gloo ranks on
    the card (R5_W3D_SHARDED), from the CLI's parser: UPDATES_FIRST
    updates, then resume=True to UPDATES_RESUMED. For each call: its K2
    launches (counts set to 0 just before), which must equal its control
    steps (the test fleet's included) with no plain call; the checkpoint's
    update counter and the curriculum installed on the whole fleet; the
    update times; the time, calls and bytes of its collectives (timed
    between device synchronizations); a checksum of its learner."""
    import torch

    from steppingstone_tpu_torch.parallel import mesh as pmesh
    from steppingstone_tpu_torch.physics import step_kernel
    from steppingstone_tpu_torch.runtime.checkpoint import CheckpointManager
    from steppingstone_tpu_torch.runtime.config import parse_cli
    from steppingstone_tpu_torch.runtime.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pmesh.maybe_initialize_distributed("gloo")
    pmesh.CLOCK.enabled = True
    out = {}
    for phase, updates, extra in (("first", UPDATES_FIRST, []),
                                  ("resumed", UPDATES_RESUMED, ["resume=True"])):
        cfg = parse_cli(R5_W3D_SHARDED + [f"experiment_dir={exp}"] + extra)
        cfg = parse_cli([f"num_frames={updates * cfg.episode_steps}"], base=cfg)
        trainer = Trainer(cfg)
        torch.cuda.synchronize()
        pmesh.CLOCK.reset()
        step_kernel.CONTROL_STEP.reset_counts()
        with counting_plain() as plain:
            t0 = time.perf_counter()
            policy = trainer.train()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = dict(step_kernel.CONTROL_STEP.launches)
        steps = r5_control_steps(trainer, cfg)
        check_launches(f"sharded loop, rank {trainer.mesh.rank} ({phase})", launches, "K2",
                       steps, plain)
        # rank 0 wrote the gathered snapshot before train() returned
        snap = CheckpointManager(os.path.join(exp, "checkpoints")).restore("latest")
        check_r5_snapshot(f"sharded loop ({phase})", snap, updates)
        clock = pmesh.CLOCK
        grad_calls = max(clock.calls["gradient"], 1)
        out[phase] = dict(
            rank=trainer.mesh.rank, world=trainer.mesh.world, envs=trainer.venv.num_envs,
            test_envs=trainer.test_venv.num_envs, launches=launches["K2"],
            control_steps=steps, start_update=trainer.start_update, seconds=seconds,
            update_times=trainer.update_times,
            collectives={k: dict(calls=clock.calls[k], seconds=clock.seconds[k],
                                 bytes=clock.bytes[k]) for k in clock.calls},
            gradient_ms_per_minibatch_step=1e3 * clock.seconds["gradient"] / grad_calls,
            gradient_bytes_per_minibatch_step=clock.bytes["gradient"] // grad_calls,
            collective_s_per_update=(sum(clock.seconds.values())
                                     / (cfg.num_updates - trainer.start_update)),
            curriculum=snap["curriculum"],
            learner_checksum=float(sum(p.detach().double().sum() for p in policy.parameters())))
    return out


def sharded_loop_path(runs: str) -> dict:
    """The round-5 Walker3D run over SHARDED_RANKS ranks (sharded_loop_rank
    on each): each rank holds its slice of the fleet and the test fleet,
    launches K2 once per control step and resumes from update
    UPDATES_FIRST with the curriculum restored; the ranks end with the
    same learner; rank 0 alone wrote progress.csv (the reference header, a
    row per update, finite losses, the test columns fresh at update 1) and
    the checkpoints."""
    from steppingstone_tpu_torch.parallel.launch import spawn

    exp = os.path.join(runs, "r5_w3d_sharded")
    t0 = time.perf_counter()
    ranks = spawn(sharded_loop_rank, SHARDED_RANKS, (exp,), local_rank=0)
    seconds = time.perf_counter() - t0
    for r in ranks:
        first, resumed = r["first"], r["resumed"]
        if (first["envs"], first["test_envs"]) != (R5_ENVS // SHARDED_RANKS,
                                                   R5_TEST_ENVS // SHARDED_RANKS):
            raise AssertionError(f"rank {first['rank']} holds {first['envs']} envs and "
                                 f"{first['test_envs']} test envs")
        if resumed["start_update"] != UPDATES_FIRST:
            raise AssertionError(f"rank {first['rank']} resumed at {resumed['start_update']}")
    if len({r["resumed"]["learner_checksum"] for r in ranks}) != 1:
        raise AssertionError(f"the ranks' learners differ: "
                             f"{[r['resumed']['learner_checksum'] for r in ranks]}")
    # the resumed call restored the curriculum and carried it on
    before, after = ranks[0]["first"]["curriculum"], ranks[0]["resumed"]["curriculum"]
    if any(before[k] != after[k] for k in ("fixed_level", "fixed_frac", "anneal_start")):
        raise AssertionError(f"curriculum {before} -> {after}")
    files = sorted(os.listdir(exp))
    if any(".bak" in f for f in files) or not os.path.exists(
            os.path.join(exp, "checkpoints", "latest.pt")):
        raise AssertionError(f"the sharded run wrote {files}")
    header, rows = read_progress(os.path.join(exp, "progress.csv"))
    check_r5_progress("sharded loop", header, rows, UPDATES_RESUMED)
    got = dict(ranks=ranks, seconds=seconds, files=files,
               progress=[{k: r[k] for k in ("iter", "fps", "value_loss", "action_loss",
                                            "mean_rew", "test_mean_rew")} for r in rows])
    print("K2 path (sharded round-5 Walker3D, per rank):", json.dumps(got), flush=True)
    for r in ranks:
        for phase in ("first", "resumed"):
            p = r[phase]
            print(f"collectives, rank {p['rank']} ({phase}): gradient all-reduce "
                  f"{p['gradient_ms_per_minibatch_step']:.3f} ms and "
                  f"{p['gradient_bytes_per_minibatch_step']} bytes per minibatch step, all "
                  f"collectives {p['collective_s_per_update']:.2f} s per update", flush=True)
    return got


def main() -> int:
    import torch

    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from steppingstone_tpu_torch.envs import make_env
    from steppingstone_tpu_torch.physics import step_kernel

    card = card_line()
    print("card:", card, flush=True)
    print(f"build: {', '.join(step_kernel.VARIANTS)} "
          f"{step_kernel.CONTROL_STEP.build():.2f} s", flush=True)
    print_ptxas(step_kernel.CONTROL_STEP.build_log)

    envs = {v: variant_env(v) for v in VARIANT_ENVS}
    occupancy = {}
    for variant in step_kernel.VARIANTS:
        model, (pd, plank, rot) = envs[variant].cfg.model, step_kernel.VARIANTS[variant]
        n_stones = envs[variant].cfg.n_stones
        floats = step_kernel.warp_floats(model.nbodies, model.ncontacts, n_stones, plank)
        occupancy[variant] = dict(
            model=model.name, stones=n_stones, bytes_per_env=4 * floats,
            smem_bytes_per_block=4 * floats * step_kernel.WARP_ENVS,
            envs_per_block=step_kernel.WARP_ENVS,
            envs_per_sm=step_kernel.CONTROL_STEP.warp_envs_per_sm(model, n_stones, pd, plank,
                                                                  rot),
            sms=torch.cuda.get_device_properties(0).multi_processor_count)
    print("control_step_warp occupancy:", json.dumps(occupancy), flush=True)
    checks, timings, path_timings, feet = {}, {}, {}, []
    for variant, env in envs.items():
        batches = CHECK_BATCHES + PATH_BATCHES.get(variant, ())
        results = dict(zip(batches, (check_variant(env, variant, b) for b in batches)))
        checks[variant] = [r[0] for r in results.values()]
        feet += [check_foot_positions(env, variant, results[b][1][0][0])
                 for b in FOOT_BATCHES.get(variant, ())]
        timings[variant] = time_variant(env, variant, *results[NUM_ENVS][1])
        path_timings[variant] = {str(b): time_variant(env, variant, *results[b][1])
                                 for b in PATH_BATCHES.get(variant, ())}
        if variant in ONE_ENV:
            got, one = check_one_env(env, variant, *results[NUM_ENVS][1])
            checks[variant].append(got)
            path_timings[variant]["1"] = time_variant(env, variant, *one)
    # K2 on Mike's states, at its round-5 run's fleet and test fleet
    mike = make_env("MikeStepperEnv-v0", plank_class="LargePlank")
    checks["K2"] += [check_variant(mike, "K2", b)[0] for b in (R5_ENVS, R5_TEST_ENVS)]

    walker_rollout = rollout_path(envs["K1"], "K1", ROLLOUT_STEPS, detail=True)
    card_vs_cpu()
    # this slice's path: the measurement entry points
    measured = measurement_path()
    paths = {"K1": measured["bench"]}
    paths["K3"] = rollout_path(envs["K3"], "K3", CASSIE_DISC_STEPS, detail=False)
    paths["K2+K3"] = cassie_training_path()
    walker_plank = walker_plank_path()
    card_vs_cpu_training()
    urdf = urdf_path()
    paths["K4"], paths["K3+K4"] = urdf["K4"], urdf["K3+K4"]
    for variant in ("K4", "K3+K4"):
        checks[variant] += urdf[variant]["checks"]
    rotated_walker = rotated_loop(envs["K4"], "K4", ROT_WALKER_STEPS)
    paths["K2+K4"] = rotated_loop(envs["K2+K4"], "K2+K4", ROT_PLANK_STEPS)
    paths["K2+K3+K4"] = rotated_loop(envs["K2+K3+K4"], "K2+K3+K4", ROT_PLANK_STEPS)
    with tempfile.TemporaryDirectory() as runs:
        loop = training_loop_path(runs)
        mike_run = mike_path()
        thr = threshold_path()
        spec = specialist_path(runs, os.path.join(runs, "r5_w3d"))
        enjoyed = enjoy_paths(runs, spec["exp"])
        card_vs_cpu_episode(spec["exp"])
        behavior = behavior_paths(os.path.join(runs, "r5_w3d"))
    resume_is_total()
    # the sharded path (this slice's): the dry run, NCCL at world size 1,
    # the round-5 Walker3D run over two ranks
    dry = sharded_dryrun_path()
    nccl_world_one(dry["single"])
    with tempfile.TemporaryDirectory() as runs:
        sharded = sharded_loop_path(runs)
    paths["K2"] = dict(launches=sum(sharded["ranks"][0][p]["launches"]
                                    for p in ("first", "resumed")))
    # a variant's other paths, with their launches
    other_paths = {
        "K1": {"Walker3D rollout (VecEnv, 4096 envs)": walker_rollout["launches"],
               "entry() forward steps (128 envs)": measured["entry"]["launches"],
               "enjoy, reference pickle, one env": enjoyed["reference"]["launches"],
               "behavior evaluation, level 0 on discs, 256 envs":
                   behavior["level 0, discs"]["launches"],
               "dryrun_multichip(2), each rank": dry["launches"]},
        "K2": {"round-5 Walker3D Trainer.train over two ranks, each rank":
                   [sum(r[p]["launches"] for p in ("first", "resumed")) for r in sharded["ranks"]],
               "round-5 specialist Trainer.train, warm-started": spec["launches"],
               "behavior evaluation, LargePlank, levels 0 5 and bands 0 3, 256 envs":
                   sum(behavior[k]["launches"] for k in ("levels 0 5, LargePlank",
                                                         "bands 0 3, LargePlank")),
               "enjoy, LargePlank, one env": enjoyed["plank"]["launches"],
               "round-5 threshold-sampling Trainer.train (r5_thr150)":
                   thr["first"]["launches"] + thr["resumed"]["launches"],
               "AdaptiveSampling.pre_update (16 envs)": thr["adaptive"]["launches"],
               "round-5 Walker3D Trainer.train (fixed curriculum, one update)":
                   loop["launches"],
               "round-5 Mike Trainer.train": mike_run["launches"],
               "Walker3D LargePlank train_iteration": walker_plank["launches"]},
        "K4": {"rotated Walker3D engine.step loop": rotated_walker["launches"]},
    }

    kernels = []
    for variant, (pd, plank, rot) in step_kernel.VARIANTS.items():
        c, t = checks[variant], timings[variant]
        kernels.append(dict(
            name=f"control_step ({variant})",
            route="cuda",
            source="steppingstone_tpu_torch/csrc/control_step.cu",
            replaces="steppingstone_tpu/physics/pallas_step.py:733",
            specialization=f"pd={pd}, support_hy={1.5 if plank else None}, "
                           f"joint_rot={'set' if rot else None}",
            design="warp per env",
            launches=paths[variant]["launches"],
            other_paths=other_paths.get(variant, {}),
            max_abs_err=max(max(x["max_q_err"], x["max_qd_err"]) for x in c),
            max_q_err=max(x["max_q_err"] for x in c),
            max_qd_err=max(x["max_qd_err"] for x in c),
            limit_flips=sum(x["limit_flips"] for x in c),
            checked_batches=[x["batch"] for x in c],
            ms=t["ms"],
            plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"],
            bound_by=t["bound_by"],
            library_ms=None,
            batch=NUM_ENVS,
            wrapper_ms=t["wrapper_ms"],
            flops=t["flops"],
            bytes=t["bytes"],
            # at the batch sizes of its path (the 4096-env numbers above)
            path_batches={b: {k: p[k] for k in ("ms", "bound_ms", "plain_ms")}
                          for b, p in path_timings[variant].items()},
            occupancy=occupancy[variant],
        ))
    # timed at the bench's fleet (its launches are the bench's), and at
    # every batch checked
    foot = feet[0]
    kernels.append(dict(
        name="foot_positions",
        route="cuda",
        source="steppingstone_tpu_torch/csrc/control_step.cu",
        replaces="steppingstone_tpu_torch/physics/kinematics.py:42 "
                 "forward_kinematics(model, q).pos[:, feet]",
        specialization="any model, joint_rot or not",
        design="thread per env and foot",
        launches=FOOT_LAUNCHES["bench"],
        other_paths={k: n for k, n in FOOT_LAUNCHES.items() if k != "bench"},
        max_abs_err=max(f["max_abs_err"] for f in feet),
        checked_batches=[f"{f['robot']} {f['batch']}" for f in feet],
        ms=foot["ms"],
        plain_ms=foot["plain_ms"],
        bound_ms=foot["bound_ms"],
        bound_by=foot["bound_by"],
        batch=foot["batch"],
        wrapper_ms=foot["wrapper_ms"],
        flops=foot["flops"],
        bytes=foot["bytes"],
        path_batches={f"{f['robot']} {f['batch']}": {k: f[k] for k in ("ms", "wrapper_ms",
                                                                        "bound_ms", "plain_ms")}
                      for f in feet},
    ))
    print(f"wall: {time.perf_counter() - started:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print("card:", card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
