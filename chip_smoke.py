#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (steppingstone_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds every kernel from this checkout's
sources. Phases, in order; any failure exits non-zero and no phase's
failure is caught:

1. card: name and power limit (nvidia-smi)
2. build: the control-step kernels (csrc/control_step.cu, one nvcc run for
   the four variants K1, K2, K3, K2+K3) and ptxas's registers and stack
   frame for each
3. each variant against its plain PyTorch version (engine._step_scan) on
   the card at B=4096 and a ragged B=1000, on states from a short rollout
   of the port plus random perturbations, so that contacts, on-stone feet,
   joint limits and (planks) feet beyond the disc radius but on the plank
   all occur; K1 on Walker3D torques over discs, K2 on Walker3D torques
   over LargePlank planks, K3 on Cassie stable PD over discs, K2+K3 on
   Cassie stable PD over planks; then each variant's time per launch
4. paths, each driven through the entry points a user calls, with the
   launch counts set to 0 just before and read just after (and no call of
   the plain version allowed):
   - K1: Walker3D rollout, VecEnv(4096), 100 steps, exactly 100 K1
     launches; the split of a step, a torch.profiler trace, and a small
     rollout on the card against the same rollout on the CPU
   - K3: Cassie (disc support) rollout, 4096 envs, 25 steps, exactly 25
   - K2+K3: the round-5 Cassie training configuration (CassieStepper-v1,
     LargePlank, phase mirror, 2 critics, KL guard), 4096 envs x 100
     steps, 2 Trainer.train_iterations (GAE, 10 epochs x 100 minibatches
     of 4096 rows), exactly 200 launches, every output finite; then the
     rollout / update split of a third iteration and profiles of both
   - K2: Walker3D LargePlank train_iteration with mirror-augmented PPO,
     4096 envs x 25 steps, exactly 25 launches
   - one Cassie LargePlank training iteration on the card against the
     same iteration on the CPU, on shared draws
5. one JSON line `{"kernels": [...]}`, the card line, and last
   `{"ok": true, "device": {...}}`
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
import time

NUM_ENVS = 4096
ROLLOUT_STEPS = 100
CHECK_BATCHES = (4096, 1000)
TIMED_LAUNCHES = 50
CASSIE_DISC_STEPS = 25
TRAIN_STEPS = 100
TRAIN_ITERATIONS = 2
WALKER_PLANK_STEPS = 25
LR = 3e-4
# the round-5 Cassie run (scripts/round5_runs.sh), at one card's env count
CASSIE_RUN = dict(env_name="CassieStepper-v1", plank_class="LargePlank", use_phase_mirror=True,
                  num_ensembles=2, kl_cutoff=0.12)
# H100 SXM published peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# variant -> the env whose states and support it is checked on
VARIANT_ENVS = {
    "K1": ("Walker3DStepperEnv-v0", {}),
    "K2": ("Walker3DStepperEnv-v0", {"plank_class": "LargePlank"}),
    "K3": ("CassieStepper-v1", {}),
    "K2+K3": ("CassieStepper-v1", {"plank_class": "LargePlank"}),
}
SPECIALIZATION = {"K1": "pd=False, support_hy=None", "K2": "pd=False, support_hy=1.5",
                  "K3": "pd=True, support_hy=None", "K2+K3": "pd=True, support_hy=1.5"}
# template arguments <PD, PLANK> as they appear in the kernels' mangled names
MANGLED = {"ILb0ELb0E": "K1", "ILb0ELb1E": "K2", "ILb1ELb0E": "K3", "ILb1ELb1E": "K2+K3"}


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


def print_ptxas(build_log: str) -> None:
    """ptxas's registers and stack frame of each kernel variant."""
    current = "?"
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            current = next((v for m, v in MANGLED.items() if m in line), "?")
        elif "registers" in line or "stack frame" in line:
            print(f"ptxas {current}:", line.strip(), flush=True)


@contextlib.contextmanager
def counting_plain():
    """Counts calls of the plain control step (engine._step_scan) in the
    block; a path on the card must make none."""
    from steppingstone_tpu_torch.physics import engine

    calls = [0]
    plain = engine._step_scan

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    engine._step_scan = counted
    try:
        yield calls
    finally:
        engine._step_scan = plain


def check_launches(what: str, launches: dict, variant: str, expected: int, plain_calls: int):
    others = {k: v for k, v in launches.items() if k != variant and v}
    if launches[variant] != expected or others or plain_calls:
        raise AssertionError(f"{what}: launches {launches}, plain calls {plain_calls}; "
                             f"expected {expected} {variant} launches and nothing else")


def check_finite(what: str, tensors: dict) -> None:
    import torch

    for name, t in tensors.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite {name} in {what}")


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


def plain_version(model, args, kw):
    from steppingstone_tpu_torch.physics import engine

    pd = (kw["target"], kw["power"]) if "target" in kw else None
    return engine._step_scan(model, engine.PhysicsState(args[0], args[1]), *args[2:], pd=pd,
                             support_hy=kw.get("support_hy"))


def plank_only_fraction(env, args, kw) -> float:
    """Share of contact spheres that a plank supports and a disc of the same
    radius would not (stones only, no ground)."""
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
    return float(((plank.stone_index >= 0) & (disc.stone_index < 0)).float().mean())


def check_variant(env, variant: str, batch: int):
    """A kernel variant against engine._step_scan on the same inputs;
    raises on a miss. Returns (metrics, the inputs)."""
    import torch

    from steppingstone_tpu_torch.physics import step_kernel

    model = env.cfg.model
    args, kw = kernel_inputs(env, batch, seed=batch)
    if step_kernel.variant("target" in kw, "support_hy" in kw) != variant:
        raise AssertionError(f"{variant} inputs select another variant")
    q, qd, info = step_kernel.control_step(model, *args, **kw)
    st, ref = plain_version(model, args, kw)
    torch.cuda.synchronize()
    agree = lambda a, b: float((a == b).float().mean())
    got = dict(
        variant=variant,
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
    if "support_hy" in kw:
        got["plank_only_fraction"] = plank_only_fraction(env, args, kw)
    print(f"{variant} vs plain:", json.dumps(got), flush=True)
    # tolerances of tests/test_pallas_step.py
    torch.testing.assert_close(q, st.q, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(qd, st.qd, rtol=2e-3, atol=2e-2)
    torch.testing.assert_close(info.foot_normal_force, ref.foot_normal_force, rtol=1e-2, atol=1.0)
    if not (got["foot_contact_agreement"] > 0.999 and got["foot_stone_agreement"] > 0.995
            and got["at_limit_agreement"] > 0.999):
        raise AssertionError(f"{variant} diagnostics disagree with the plain version: {got}")
    if not (0 < got["contact_fraction"] < 1 and got["on_stone_fraction"] > 0
            and got["at_limit_fraction"] > 0 and got.get("plank_only_fraction", 1) > 0):
        raise AssertionError(f"inputs did not engage contacts, limits and planks: {got}")
    return got, (args, kw)


def time_variant(env, variant: str, args, kw) -> dict:
    from steppingstone_tpu_torch.physics import engine, step_kernel

    model, kernel = env.cfg.model, step_kernel.CONTROL_STEP
    soa = step_kernel.to_kernel_layout(*args)
    pd, hy = "target" in kw, kw.get("support_hy")
    launch_kw = dict(support_hy=hy)
    if pd:
        launch_kw.update(target_t=kw["target"].t().contiguous(), power=kw["power"])
    cp = env.cfg.contact
    ms = cuda_ms(lambda: kernel.launch(model, *soa, cp, engine.SUBSTEPS, **launch_kw),
                 TIMED_LAUNCHES)
    wrapper_ms = cuda_ms(lambda: step_kernel.control_step(model, *args, **kw), TIMED_LAUNCHES)
    plain_ms = cuda_ms(lambda: plain_version(model, args, kw), 3)
    n_stones = args[3].shape[1]
    flops = step_kernel.control_step_flops(model, n_stones, engine.SUBSTEPS, pd, hy) * NUM_ENVS
    nbytes = step_kernel.control_step_bytes(model, n_stones, pd) * NUM_ENVS
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    got = dict(variant=variant, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
               bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               flops=flops, bytes=nbytes)
    print(f"{variant} timing:", json.dumps(got), flush=True)
    return got


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
    check_launches(f"{env.cfg.name} rollout", launches, variant, steps, plain[0])
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


def device_time(prof, wall_ms: float, steps: int, key: str = "control_step_kernel") -> dict:
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


def profile_update(trainer, policy, opt_state, batch, steps: int = 10) -> dict:
    """`steps` PPO minibatch steps of the trainer's minibatch size under
    torch.profiler (one epoch over the first steps x rows of the batch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from steppingstone_tpu_torch.agents.ppo import ppo_update

    rows = batch["obs"].shape[0] // trainer.ppo_cfg.num_mini_batch
    cfg = dataclasses.replace(trainer.ppo_cfg, ppo_epoch=1, num_mini_batch=steps)
    sub = {k: v[:steps * rows] for k, v in batch.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ppo_update(policy, opt_state, cfg, sub, LR, generator=trainer.generator)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    out = device_time(prof, wall_ms, steps)
    out.pop("control_step_share_of_device_time")
    return dict(rows_per_step=rows, **out)


def cassie_training_path() -> dict:
    """The round-5 Cassie configuration through Trainer.train_iteration:
    4096 envs x 100 steps, 2 iterations, every step one K2+K3 launch."""
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
    metrics = []
    with counting_plain() as plain:
        t0 = time.perf_counter()
        for _ in range(TRAIN_ITERATIONS):
            policy, opt_state, state, obs, stats, m, aux = trainer.train_iteration(
                policy, opt_state, state, obs, stats, LR)
            metrics.append(m)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(step_kernel.CONTROL_STEP.launches)
    check_launches("Cassie training", launches, "K2+K3", TRAIN_ITERATIONS * TRAIN_STEPS, plain[0])
    check_finite("Cassie training", {
        **{f"param {n}": p.detach() for n, p in policy.named_parameters()},
        "adam mu": opt_state.mu, "adam nu": opt_state.nu, "last_obs": obs,
        "q": state.phys.q, "qd": state.phys.qd, "ep_return": aux["ep_return"],
        **{f"metric {k}": v for m in metrics for k, v in m._asdict().items()}})
    frames = NUM_ENVS * TRAIN_STEPS * TRAIN_ITERATIONS
    out = dict(launches=launches["K2+K3"], seconds=seconds,
               seconds_per_iteration=seconds / TRAIN_ITERATIONS, env_steps_per_s=frames / seconds,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               metrics=[{k: float(v) for k, v in m._asdict().items()} for m in metrics])
    # the rollout / update split, on a third iteration driven in its halves
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, obs, stats, batch, aux = trainer.rollout(policy, state, obs, stats)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    opt_state, m = trainer.update(policy, opt_state, batch, LR)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check_finite("Cassie training batch", {**batch, "rewards": aux["rewards"]})
    out.update(split_rollout_s=t1 - t0, split_update_s=t2 - t1,
               rollout_env_steps_per_s=NUM_ENVS * TRAIN_STEPS / (t1 - t0),
               update_ms_per_minibatch=1e3 * (t2 - t1) / (cfg.ppo_epoch * cfg.num_mini_batch),
               hits=int(aux["hits"]), dones=int(aux["ep_done"].sum()),
               mean_reward=float(aux["rewards"].mean()))
    print("K2+K3 path (Cassie training):", json.dumps(out), flush=True)
    print("K2+K3 path profile (rollout):",
          json.dumps(profile_rollout(trainer.venv, policy, state, obs)), flush=True)
    print("K2+K3 path profile (update):",
          json.dumps(profile_update(trainer, policy, opt_state, batch)), flush=True)
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
    check_launches("Walker3D LargePlank training", launches, "K2", WALKER_PLANK_STEPS, plain[0])
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
    print(f"build: K1, K2, K3, K2+K3 {step_kernel.CONTROL_STEP.build():.2f} s", flush=True)
    print_ptxas(step_kernel.CONTROL_STEP.build_log)

    envs = {v: make_env(name, **kw) for v, (name, kw) in VARIANT_ENVS.items()}
    checks, timings = {}, {}
    for variant, env in envs.items():
        results = [check_variant(env, variant, b) for b in CHECK_BATCHES]
        checks[variant] = [r[0] for r in results]
        args, kw = results[CHECK_BATCHES.index(NUM_ENVS)][1]
        timings[variant] = time_variant(env, variant, args, kw)

    paths = {"K1": rollout_path(envs["K1"], "K1", ROLLOUT_STEPS, detail=True)}
    card_vs_cpu()
    paths["K3"] = rollout_path(envs["K3"], "K3", CASSIE_DISC_STEPS, detail=False)
    paths["K2+K3"] = cassie_training_path()
    paths["K2"] = walker_plank_path()
    card_vs_cpu_training()

    kernels = []
    for variant in VARIANT_ENVS:
        c, t = checks[variant], timings[variant]
        kernels.append(dict(
            name=f"control_step ({variant})",
            route="cuda",
            source="steppingstone_tpu_torch/csrc/control_step.cu",
            replaces="steppingstone_tpu/physics/pallas_step.py:733",
            specialization=SPECIALIZATION[variant],
            launches=paths[variant]["launches"],
            max_abs_err=max(max(x["max_q_err"], x["max_qd_err"]) for x in c),
            max_q_err=max(x["max_q_err"] for x in c),
            max_qd_err=max(x["max_qd_err"] for x in c),
            ms=t["ms"],
            plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"],
            bound_by=t["bound_by"],
            library_ms=None,
            batch=NUM_ENVS,
            wrapper_ms=t["wrapper_ms"],
            flops=t["flops"],
            bytes=t["bytes"],
        ))
    print(json.dumps({"kernels": kernels}))
    print("card:", card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
