"""Headline benchmark of the port (counterpart of bench.py): END-TO-END
training throughput on Walker3DStepper.

    python3 -m steppingstone_tpu_torch.bench

Times training iterations (rollout + bootstrap + GAE + 10 PPO epochs of
mirror-augmented minibatch SGD) at bench.py's shape: 4096 envs x 100
steps of Walker3D on discs, minibatches of max(256, frames // 100) rows,
no test fleet, no mesh; every control step is one launch of kernel K1
(control_step_warp<0,0,0>, csrc/control_step.cu) on the card. Also times a
rollout-only rate: chunks of ROLLOUT_CHUNK steps of `policy_action` and
`VecEnv.step`. Each iteration runs what `Trainer.train_iteration` runs, in
its two halves: `Trainer.rollout` (the control steps, the bootstrap value,
GAE and the advantages' normalization), then `Trainer.update` (the PPO
epochs), with a `torch.cuda.synchronize` after each, so that
`phase_breakdown_s` holds both halves as measured. Parameters, fleet and
minibatch permutations are seeded with SEED (bench.py's PRNGKey(0)).

Warm-ups: one (WARMUPS) before each timed window. bench.py needs two
because its first call compiles for fresh inputs and its second recompiles
for the jit's committed output shardings. The port compiles nothing per
input: the first call pays what is paid once (the kernels' nvcc build at
the first launch unless the library for this source exists, loading it,
cuBLAS's handles and workspaces, the caching allocator's first blocks) and
the second runs as every later one. Each timed window ends on
`torch.cuda.synchronize`.

The K1 launches counted over the run must equal the control steps taken,
with no other variant launched: each step is one call of the control-step
wrapper, which on CUDA tensors launches or raises, so the count also
rules out the plain version. On the CPU (`run(..., device="cpu")`, for the
tests) every step runs the plain version and no launch may be counted.

Prints ONE JSON line. bench.py's `phase_breakdown_s` (`rollout`,
`update_incl_gae`) was an estimate, the frames at the rollout-only rate and
the rest, since one jitted program cannot be split; here it is measured,
as `rollout_incl_gae` and `update`, each summed over the timed iterations
and divided by their count.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from steppingstone_tpu_torch.agents.ppo import init_optimizer
from steppingstone_tpu_torch.agents.rollout import EpisodeStats, policy_action
from steppingstone_tpu_torch.device import resolve_device
from steppingstone_tpu_torch.physics.step_kernel import CONTROL_STEP
from steppingstone_tpu_torch.runtime.config import TrainConfig
from steppingstone_tpu_torch.runtime.train import Trainer

NUM_ENVS = 4096
ROLLOUT_CHUNK = 25      # control steps per rollout-only timed chunk
ROLLOUT_REPEATS = 4
TRAIN_STEPS = 100       # rollout length inside the timed train iteration
TRAIN_REPEATS = 5
WARMUPS = 1             # before each timed window (module docstring)
SEED = 0
LR = 3e-4
ENV_NAME = "Walker3DStepperEnv-v0"
VARIANT = "K1"          # torque actuation on discs
# H100 SXM published fp32 peak outside the tensor cores (NVIDIA data
# sheet, 700 W), for the utilization context number
H100_FP32_PEAK = 67e12


def _flops_per_frame(obs_dim=60, act_dim=21, hidden=256, epochs=10,
                     mirror=2, ensembles=1):
    """Update-phase matmul FLOPs per env frame (MAC*2; fwd+bwd ~ 3x fwd)."""
    actor = obs_dim * hidden + 5 * hidden * hidden + hidden * act_dim
    critic = ensembles * (obs_dim * hidden + 4 * hidden * hidden + hidden)
    fwd = 2 * (actor + critic)
    return fwd * 3 * mirror * epochs


def minibatch_rows(frames: int) -> int:
    """100 minibatches an epoch, at least 256 rows (bench.py)."""
    return max(256, frames // 100)


def bench_config(n_envs: int, steps: int) -> TrainConfig:
    frames = n_envs * steps
    return TrainConfig(env_name=ENV_NAME, num_processes=n_envs, episode_steps=frames,
                       mini_batch_size=minibatch_rows(frames), num_frames=frames, num_tests=0,
                       use_mirror=True, mesh_devices=0, seed=SEED)


@torch.no_grad()
def _rollout_only(venv, policy, env_state, obs, chunk: int, repeats: int, sync) -> float:
    """Seconds of `repeats` chunks of `chunk` control steps, after WARMUPS
    chunks."""

    def run_chunk(env_state, obs):
        for _ in range(chunk):
            action, _ = policy_action(policy, obs, False, venv.generator)
            env_state, out = venv.step(env_state, action)
            obs = out.obs
        return env_state, obs

    for _ in range(WARMUPS):
        env_state, obs = run_chunk(env_state, obs)
    sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        env_state, obs = run_chunk(env_state, obs)
    sync()
    seconds = time.perf_counter() - t0
    if not torch.isfinite(obs).all():
        raise RuntimeError("non-finite observations after the rollout-only chunks")
    return seconds


def run(n_envs: int = NUM_ENVS, steps: int = TRAIN_STEPS, rollout_chunk: int = ROLLOUT_CHUNK,
        rollout_repeats: int = ROLLOUT_REPEATS, train_repeats: int = TRAIN_REPEATS,
        device=None) -> dict:
    """The bench at `n_envs` x `steps` on `device` (None means the card);
    prints its JSON line and returns it as a dict."""
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    cfg = bench_config(n_envs, steps)
    frames = n_envs * steps
    trainer = Trainer(cfg, device=dev)
    policy = trainer.init_params()
    opt_state = init_optimizer(policy)
    env_state, obs = trainer.venv.reset()
    stats = EpisodeStats.init(n_envs, dev)
    before = dict(CONTROL_STEP.launches)

    rollout_s = _rollout_only(trainer.venv, policy, env_state, obs, rollout_chunk,
                              rollout_repeats, sync)
    rollout_rate = n_envs * rollout_chunk * rollout_repeats / rollout_s
    print(f"rollout-only: {rollout_rate:,.0f} env-steps/s", file=sys.stderr)

    def iteration(opt_state, env_state, obs, stats):
        """One train_iteration in its halves, each ended on a sync: returns
        its carry, its metrics and the halves' seconds."""
        t0 = time.perf_counter()
        env_state, obs, stats, batch, _ = trainer.rollout(policy, env_state, obs, stats)
        sync()
        t1 = time.perf_counter()
        opt_state, metrics = trainer.update(policy, opt_state, batch, LR)
        sync()
        return (opt_state, env_state, obs, stats), metrics, (t1 - t0, time.perf_counter() - t1)

    carry = (opt_state, env_state, obs, stats)
    for _ in range(WARMUPS):
        carry = iteration(*carry)[0]
    halves = [0.0, 0.0]
    t0 = time.perf_counter()
    for _ in range(train_repeats):
        carry, metrics, seconds = iteration(*carry)
        halves = [a + b for a, b in zip(halves, seconds)]
    train_s = time.perf_counter() - t0
    if not (torch.isfinite(torch.stack(list(metrics))).all()
            and all(torch.isfinite(p).all() for p in policy.parameters())):
        raise RuntimeError(f"non-finite losses or parameters after the timed iterations: {metrics}")

    launches = {k: v - before[k] for k, v in CONTROL_STEP.launches.items()}
    control_steps = (WARMUPS + rollout_repeats) * rollout_chunk + (WARMUPS + train_repeats) * steps
    expected = control_steps if dev.type == "cuda" else 0
    if launches[VARIANT] != expected or any(v for k, v in launches.items() if k != VARIANT):
        raise RuntimeError(f"launches {launches}: expected {expected} {VARIANT} launches for "
                           f"{control_steps} control steps on {dev}, and nothing else")

    train_rate = frames * train_repeats / train_s
    iter_s = train_s / train_repeats
    fpf = _flops_per_frame()
    achieved = train_rate * fpf  # update-phase matmul FLOP/s (est.)
    route = (f"control_step_warp {VARIANT}, cuda" if dev.type == "cuda"
             else f"plain control step, {dev.type}")
    result = {
        "metric": (f"end-to-end train env-steps/s (Walker3DStepper, {n_envs} envs, "
                   f"rollout+GAE+10-epoch PPO, {route})"),
        "value": train_rate,
        "unit": "env-steps/s",
        "rollout_only_steps_per_s": rollout_rate,
        "seconds_per_iteration": iter_s,
        "phase_breakdown_s": {"rollout_incl_gae": halves[0] / train_repeats,
                              "update": halves[1] / train_repeats},
        # utilization context (all estimates share the same assumed
        # per-frame matmul FLOP count — divide them out yourself):
        "update_matmul_flops_per_frame_assumed": fpf,
        "update_achieved_flops_per_s_est": achieved,
        # an H100 share only of a rate measured on the card
        "vs_h100_fp32_peak_67tf": achieved / H100_FP32_PEAK if dev.type == "cuda" else None,
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else None,
        "device": str(dev),
        "launches": launches,
        "control_steps": control_steps,
        "matmul_precision": {
            "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
        },
        "envs": n_envs, "steps": steps, "minibatch_rows": cfg.mini_batch_size,
        "num_mini_batch": cfg.num_mini_batch, "train_repeats": train_repeats,
        "rollout_chunk": rollout_chunk, "rollout_repeats": rollout_repeats, "warmups": WARMUPS,
        "train_timed_s": train_s, "rollout_timed_s": rollout_s, "seed": SEED,
        "final_losses": {k: float(v) for k, v in metrics._asdict().items()},
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    run()
