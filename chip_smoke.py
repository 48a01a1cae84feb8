#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (steppingstone_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds every kernel from this checkout's
sources. Phases, in order; any failure exits non-zero and no phase's
failure is caught:

1. card: name and power limit (nvidia-smi)
2. build: kernel K1 (csrc/control_step.cu) with nvcc
3. K1 against its plain PyTorch version on the card, Walker3D at B=4096
   and a ragged B=1000, on states from a short rollout plus random
   perturbations (contacts and joint limits engage); then timings
4. main path: make_env, VecEnv(4096), a fresh 256-wide ActorCritic on
   cuda; reset; collect_rollout for 100 steps; K1 must launch exactly 100
   times and every output must be finite; then the split of a step
   (policy / env), a short torch.profiler trace (device idle share), and
   a small rollout on the card against the same rollout on the CPU with
   shared random draws
5. one JSON line `{"kernels": [...]}`, the card line, and last
   `{"ok": true, "device": {...}}`
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

NUM_ENVS = 4096
ROLLOUT_STEPS = 100
CHECK_BATCHES = (4096, 1000)
TIMED_LAUNCHES = 50
# H100 SXM published peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


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


def k1_inputs(env, batch: int, seed: int):
    """K1 inputs at batch size `batch`: the state after a short random-action
    rollout of the port, perturbed as in tests/test_pallas_step.py."""
    import torch

    from steppingstone_tpu_torch.envs import terrain as terr
    from steppingstone_tpu_torch.envs.vector import VecEnv

    venv = VecEnv(env, batch, seed=seed)
    g = venv.generator
    state, _ = venv.reset()
    for _ in range(12):
        state, _ = venv.step(state, 0.5 * torch.randn((batch, 21), generator=g, device="cuda"))
    q, qd = state.phys.q.clone(), state.phys.qd.clone()
    q[:, 2] += 0.05 * torch.randn(batch, generator=g, device="cuda") - 0.03
    q[:, 7:] += 0.1 * torch.randn(q[:, 7:].shape, generator=g, device="cuda")
    qd += 0.3 * torch.randn(qd.shape, generator=g, device="cuda")
    tau = 20.0 * torch.randn((batch, 21), generator=g, device="cuda")
    r_eff = state.stone_radius + env.cfg.radius_extra * (1.0 - terr.level_scale(state.cur.assist))
    use_ground = torch.rand(batch, generator=g, device="cuda") < 0.5
    return q, qd, tau, state.terrain.contiguous(), r_eff.contiguous(), use_ground


def check_k1(env, batch: int):
    """K1 against engine._step_scan on the same inputs; raises on a miss.
    Returns (metrics, the inputs)."""
    import torch

    from steppingstone_tpu_torch.physics import engine, step_kernel

    model = env.cfg.model
    args = k1_inputs(env, batch, seed=batch)
    q, qd, info = step_kernel.control_step(model, *args)
    st, ref = engine._step_scan(model, engine.PhysicsState(args[0], args[1]), *args[2:])
    torch.cuda.synchronize()
    agree = lambda a, b: float((a == b).float().mean())
    got = dict(
        batch=batch,
        max_q_err=float((q - st.q).abs().max()),
        max_qd_err=float((qd - st.qd).abs().max()),
        foot_contact_agreement=agree(info.foot_contact, ref.foot_contact),
        foot_stone_agreement=agree(info.foot_stone, ref.foot_stone),
        at_limit_agreement=agree(info.joint_at_limit, ref.joint_at_limit),
        max_foot_force_err=float((info.foot_normal_force - ref.foot_normal_force).abs().max()),
        contact_fraction=float(ref.foot_contact.float().mean()),
        on_stone_fraction=float((ref.foot_stone >= 0).float().mean()),
        at_limit_fraction=float(ref.joint_at_limit.float().mean()),
    )
    print("K1 vs plain:", json.dumps(got), flush=True)
    # tolerances of tests/test_pallas_step.py
    torch.testing.assert_close(q, st.q, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(qd, st.qd, rtol=2e-3, atol=2e-2)
    torch.testing.assert_close(info.foot_normal_force, ref.foot_normal_force, rtol=1e-2, atol=1.0)
    if not (got["foot_contact_agreement"] > 0.999 and got["foot_stone_agreement"] > 0.995
            and got["at_limit_agreement"] > 0.999):
        raise AssertionError(f"K1 diagnostics disagree with the plain version: {got}")
    if not (0 < got["contact_fraction"] < 1 and got["on_stone_fraction"] > 0
            and got["at_limit_fraction"] > 0):
        raise AssertionError(f"inputs did not engage contacts and limits: {got}")
    return got, args


def time_k1(env, args) -> dict:
    from steppingstone_tpu_torch.physics import engine, step_kernel

    model, kernel = env.cfg.model, step_kernel.CONTROL_STEP
    soa = step_kernel.to_kernel_layout(*args)
    cp = env.cfg.contact
    ms = cuda_ms(lambda: kernel.launch(model, *soa, cp, engine.SUBSTEPS), TIMED_LAUNCHES)
    wrapper_ms = cuda_ms(lambda: step_kernel.control_step(model, *args), TIMED_LAUNCHES)
    plain_ms = cuda_ms(lambda: engine._step_scan(
        model, engine.PhysicsState(args[0], args[1]), *args[2:]), 3)
    n_stones = args[3].shape[1]
    flops = step_kernel.control_step_flops(model, n_stones, engine.SUBSTEPS) * NUM_ENVS
    nbytes = step_kernel.control_step_bytes(model, n_stones) * NUM_ENVS
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    return dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                flops=flops, bytes=nbytes)


def main_path(env) -> dict:
    """The port's rollout path as a user drives it, with K1's launches counted."""
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
    step_kernel.CONTROL_STEP.launches = 0
    t0 = time.perf_counter()
    state, obs, stats, traj, aux = collect_rollout(venv, policy, state, obs, stats, ROLLOUT_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = step_kernel.CONTROL_STEP.launches
    if launches != ROLLOUT_STEPS:
        raise AssertionError(f"K1 launched {launches} times in {ROLLOUT_STEPS} steps")
    if traj.obs.shape != (ROLLOUT_STEPS, NUM_ENVS, env.observation_dim):
        raise AssertionError(f"trajectory obs shape {tuple(traj.obs.shape)}")
    for name, t in [*traj._asdict().items(), ("last_obs", obs), ("q", state.phys.q),
                    ("qd", state.phys.qd), ("terrain", state.terrain)]:
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite {name} after the rollout")
    # the split of a rollout step, timed after the counted run
    with torch.no_grad():
        policy_ms = cuda_ms(lambda: (policy_action(policy, obs, False, venv.generator),
                                     policy.value(obs)), 10)
    env_step_ms = cuda_ms(lambda: venv.step(state, traj.actions[-1]), 10)
    out = dict(launches=launches, seconds=seconds,
               env_steps_per_s=NUM_ENVS * ROLLOUT_STEPS / seconds,
               step_ms=1e3 * seconds / ROLLOUT_STEPS, policy_ms=policy_ms,
               env_step_ms=env_step_ms, hits=int(aux["hits"]),
               dones=int(aux["ep_done"].sum()), mean_reward=float(traj.rewards.mean()))
    print("main path:", json.dumps(out), flush=True)
    print("profile:", json.dumps(profile_rollout(venv, policy, state, obs)), flush=True)
    return out


def profile_rollout(venv, policy, state, obs, steps: int = 5) -> dict:
    """A few rollout steps under torch.profiler: device kernel time summed
    over the trace against the host clock. The profiler slows the host,
    so the idle share it gives is an upper estimate."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from steppingstone_tpu_torch.agents.rollout import EpisodeStats, collect_rollout

    stats = EpisodeStats.init(obs.shape[0], obs.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        collect_rollout(venv, policy, state, obs, stats, steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k1_ms = sum(e.self_device_time_total for e in kernels if "control_step_kernel" in e.key) / 1e3
    return dict(steps=steps, wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                kernels_per_step=sum(e.count for e in kernels) / steps,
                k1_share_of_device_time=k1_ms / busy_ms)


def _to(x, device):
    """A (nested) NamedTuple of tensors moved to `device`."""
    if isinstance(x, tuple):
        return type(x)(*(_to(y, device) for y in x))
    return x.to(device)


def card_vs_cpu(steps: int = 8, batch: int = 16) -> dict:
    """The whole rollout on the card against the plain path on the CPU, on
    the same draws: the card run goes through K1, the CPU run through the
    plain PyTorch version that the CPU tests hold against the JAX package.
    Not teacher forced, so fp32 differences compound through contact over
    the steps: held to 1e-3 (the CPU tests see ~5e-5 against JAX over 10
    steps); episode ends must agree."""
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
                                    action_noise=noise.to(dev),
                                    env_draws=[_to(d, dev) for d in draws])
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from steppingstone_tpu_torch.envs import make_env
    from steppingstone_tpu_torch.physics import step_kernel

    card = card_line()
    print("card:", card, flush=True)
    print(f"build: K1 {step_kernel.CONTROL_STEP.build():.2f} s", flush=True)
    for line in step_kernel.CONTROL_STEP.build_log.splitlines():
        if "registers" in line or "stack frame" in line:
            print("ptxas:", line.strip(), flush=True)

    env = make_env("Walker3DStepperEnv-v0")
    checks, inputs = zip(*(check_k1(env, b) for b in CHECK_BATCHES))
    timing = time_k1(env, inputs[CHECK_BATCHES.index(NUM_ENVS)])
    print("K1 timing:", json.dumps(timing), flush=True)

    path = main_path(env)
    card_vs_cpu()

    k1 = dict(
        name="control_step (K1)",
        route="cuda",
        source="steppingstone_tpu_torch/csrc/control_step.cu",
        replaces="steppingstone_tpu/physics/pallas_step.py:733",
        launches=path["launches"],
        max_abs_err=max(max(c["max_q_err"], c["max_qd_err"]) for c in checks),
        max_q_err=max(c["max_q_err"] for c in checks),
        max_qd_err=max(c["max_qd_err"] for c in checks),
        ms=timing["ms"],
        plain_ms=timing["plain_ms"],
        bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"],
        library_ms=None,
        batch=NUM_ENVS,
        wrapper_ms=timing["wrapper_ms"],
        flops=timing["flops"],
        bytes=timing["bytes"],
    )
    print(json.dumps({"kernels": [k1]}))
    print("card:", card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
