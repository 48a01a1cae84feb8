"""Structure of the PyTorch/CUDA port, checked on the CPU: it imports no
JAX, its entry points default to the card, the control-step wrapper
refuses what the kernels cannot take and broadcasts unbatched operands,
and the sources are where the builds expect them. The card-only tests
hold the eight control-step variants (K1..K4 and their combinations)
against their plain version, and the value grid's eval fleet on K2, and
skip on a host without a GPU (run them on the card with
`python3 -m pytest --noconftest tests/test_torch_structure.py`); all eight
are control_step_warp<PD, PLANK, ROT>, a warp per env."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from steppingstone_tpu_torch.physics import engine, step_kernel, urdf
from steppingstone_tpu_torch.physics.model import with_rotated_frames
from steppingstone_tpu_torch.physics.robots.cassie import cassie
from steppingstone_tpu_torch.physics.robots.walker3d import walker3d

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "steppingstone_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "steppingstone_tpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    # "steppingstone_tpu_torch" starts with "steppingstone_tpu": compare
    # whole dotted components, not prefixes
    return module.split(".")[0] in FORBIDDEN


def test_port_imports_no_jax():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    for module in ("physics/robots/cassie.py", "agents/gae.py", "agents/mirror.py",
                   "agents/ppo.py", "runtime/config.py", "runtime/train.py",
                   "physics/urdf.py", "physics/mjcf_export.py", "runtime/checkpoint.py",
                   "runtime/curriculum.py", "runtime/loggers.py", "runtime/schedules.py",
                   "viz/sampling_prob.py", "runtime/enjoy.py", "runtime/torch_import.py",
                   "viz/render.py", "viz/stats_hud.py", "viz/value_grids.py",
                   "viz/plot_from_csv.py", "viz/fast_plot.py"):
        assert PACKAGE / module in files, module
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f) if _forbidden(m)]
    assert bad == []
    assert not _forbidden("steppingstone_tpu_torch.physics")
    assert _forbidden("steppingstone_tpu.physics") and _forbidden("jax.numpy")
    assert _forbidden("orbax.checkpoint")


def test_inference_pulls_in_no_matplotlib():
    """The card's machine has no matplotlib: enjoy, the warm start and the
    viz modules that import it lazily load without it."""
    code = ("import sys\n"
            "import steppingstone_tpu_torch.runtime.enjoy, steppingstone_tpu_torch.runtime.train\n"
            "import steppingstone_tpu_torch.viz.render, steppingstone_tpu_torch.viz.stats_hud\n"
            "import steppingstone_tpu_torch.viz.value_grids, steppingstone_tpu_torch.viz.plot_from_csv\n"
            "import steppingstone_tpu_torch.viz.sampling_prob\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('matplotlib', 'pandas', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"


def test_entry_points_default_to_the_card():
    from steppingstone_tpu_torch.agents.networks import ActorCritic
    from steppingstone_tpu_torch.envs import make_env
    from steppingstone_tpu_torch.envs.vector import VecEnv

    from steppingstone_tpu_torch.runtime.config import TrainConfig
    from steppingstone_tpu_torch.runtime.train import Trainer, main

    if torch.cuda.is_available():
        assert make_env("Walker3DStepperEnv-v0").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_env("Walker3DStepperEnv-v0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_env("CassieStepper-v1", plank_class="LargePlank")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_env("MikeStepperEnv-v0", plank_class="LargePlank")
    cfg = TrainConfig(num_processes=4, episode_steps=8, num_frames=8, num_tests=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    # the training CLI runs on the card: without one it raises before it
    # writes anything
    for env_name in ("Walker3DStepperEnv-v0", "MikeStepperEnv-v0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([f"env_name={env_name}", "num_processes=4", "episode_steps=8",
                  "num_frames=8", "num_tests=0", "experiment_dir=/nonexistent/never-created"])
    assert Trainer(cfg, device="cpu").venv.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ActorCritic(60, 21)
    env = make_env("Walker3DStepperEnv-v0", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VecEnv(env, 4)
    assert VecEnv(env, 4, device="cpu").device.type == "cpu"
    assert next(ActorCritic(60, 21, device="cpu").parameters()).device.type == "cpu"
    # inference: enjoy's CLI and its loader run on the card (checked before
    # any file is read)
    from steppingstone_tpu_torch.runtime import enjoy

    with pytest.raises(RuntimeError, match="device='cpu'"):
        enjoy.main(["--net", "/nonexistent/latest", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        enjoy.load_params("/nonexistent/latest", env, 1)


def _k1_args(b=4, n_stones=20):
    m = walker3d()
    st = engine.default_state(m, b)
    return m, [st.q, st.qd, torch.zeros(b, m.njoints), torch.zeros(b, n_stones, 6),
               torch.full((b,), 0.25), torch.zeros(b, dtype=torch.bool)]


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "batch", "model", "target",
                                  "power"])
def test_k1_wrapper_rejects_bad_inputs(case):
    m, args = _k1_args()
    kw = {}
    if case == "target":
        kw, err = dict(target=torch.zeros(4, m.njoints - 1)), ValueError
    elif case == "power":
        kw, err = dict(target=torch.zeros(4, m.njoints), power=torch.ones(4).double()), TypeError
    elif case == "dtype":
        args[0], err = args[0].double(), TypeError
    elif case == "shape":
        args[2], err = args[2][:, :20].contiguous(), ValueError
    elif case == "contiguity":
        args[3], err = torch.zeros(20, 4, 6).transpose(0, 1), ValueError
    elif case == "batch":
        args[4], err = torch.full((3,), 0.25), ValueError
    else:
        args[3], err = torch.zeros(4, step_kernel.MAXS + 1, 6), ValueError
    with pytest.raises(err):
        step_kernel.control_step(m, *args, **kw)


def test_wrapper_runs_rotated_frames_on_cpu():
    """Rotated joint frames are no longer refused: on the CPU the wrapper
    runs the plain version (no launch) and it matches JAX's jnp path to the
    Pallas test's bars, on tests/test_pallas_step.py's pendulum with its
    0.4 rad x-rotated joint frame."""
    jax = pytest.importorskip("jax")  # the card machine needs no JAX
    from steppingstone_tpu.physics import engine as jeng
    from steppingstone_tpu.physics.model import build_model as jbuild

    from steppingstone_tpu_torch.physics.model import build_model

    bodies = [
        dict(name="base", mass=5.0, inertia=(0.5, 0.5, 0.5), root_height=1.0),
        dict(name="arm", parent="base", anchor=(0, 0, 0), axis=(0, 1, 0), mass=1.0,
             com=(0, 0, -0.5), inertia=(0.05, 0.05, 0.05), damping=0.1, limits=(-2.0, 2.0)),
    ]
    contacts = [dict(body="arm", offset=(0, 0, -0.5), radius=0.05),
                dict(body="base", offset=(0, 0, -0.1), radius=0.05)]
    rot = np.array([[1, 0, 0, 0], [np.cos(0.2), np.sin(0.2), 0, 0]], np.float32)
    m = dataclasses.replace(build_model("pendulum", bodies, contacts), joint_rot=rot)
    mj = dataclasses.replace(jbuild("pendulum", bodies, contacts), joint_rot=rot)
    g = torch.Generator().manual_seed(0)
    st = engine.default_state(m, 4)
    args = [st.q.clone(), 0.3 * torch.randn(st.qd.shape, generator=g),
            20 * torch.randn(4, m.njoints, generator=g), torch.zeros(4, 6, 6),
            torch.full((4,), 0.25), torch.ones(4, dtype=torch.bool)]
    args[0][:, 2] -= 0.5  # the tilted arm's sphere touches the ground
    q, qd, info = step_kernel.control_step(m, *args)
    assert sum(step_kernel.CONTROL_STEP.launches.values()) == 0
    assert step_kernel.variant(False, False, True) == "K4"
    ref = jax.jit(jax.vmap(lambda *a: jeng._step_scan(mj, jeng.PhysicsState(a[0], a[1]),
                                                      *a[2:])[0]))(*(a.numpy() for a in args))
    np.testing.assert_allclose(q.numpy(), np.asarray(ref.q), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(qd.numpy(), np.asarray(ref.qd), rtol=2e-3, atol=2e-2)
    assert (info.contact_force_sum > 0).any()


def test_k1_wrapper_runs_the_plain_version_on_cpu():
    m, args = _k1_args()
    q, qd, info = step_kernel.control_step(m, *args)
    st, ref = engine._step_scan(m, engine.PhysicsState(args[0], args[1]), *args[2:])
    assert torch.equal(q, st.q) and torch.equal(qd, st.qd)
    assert torch.equal(info.foot_stone, ref.foot_stone)
    assert step_kernel.CONTROL_STEP.launches == dict.fromkeys(step_kernel.COUNTED, 0)


def test_wrapper_broadcasts_unbatched_operands():
    """The stepper's PD path passes one env's zero torques and a scalar
    power; the wrapper repeats unbatched operands over the batch, as the
    JAX package's vmap rule does, and runs the plain version on the CPU."""
    m = cassie()
    st = engine.default_state(m, 3)
    stones = torch.zeros(20, 6)
    target = engine.pd_target_from_action(m, torch.linspace(-1, 1, m.action_dim)[None])[0]
    out = step_kernel.control_step(m, st.q, st.qd, torch.zeros(m.njoints), stones, 0.25, False,
                                   target=target, power=0.7, support_hy=1.5)
    ref = engine._step_scan(m, st, torch.zeros(3, m.njoints), stones.expand(3, 20, 6),
                            torch.full((3,), 0.25), torch.zeros(3, dtype=torch.bool),
                            pd=(target.expand(3, -1), torch.full((3,), 0.7)), support_hy=1.5)
    assert torch.equal(out[0], ref[0].q) and torch.equal(out[1], ref[0].qd)
    assert sum(step_kernel.CONTROL_STEP.launches.values()) == 0
    assert [step_kernel.variant(pd, hy, rot) for rot in (False, True) for pd, hy in
            [(False, False), (False, True), (True, False), (True, True)]] == list(
        step_kernel.VARIANTS)


def test_kernel_source_is_the_only_one():
    sources = sorted(p.relative_to(PACKAGE) for ext in ("*.cu", "*.cuh", "*.cpp", "*.c")
                     for p in PACKAGE.rglob(ext) if "build" not in p.parts)
    assert sources == [Path("csrc/control_step.cu")]
    assert step_kernel.SOURCE == PACKAGE / "csrc" / "control_step.cu"
    text = step_kernel.SOURCE.read_text()
    assert "pallas_step.py" in text and "sm_90a" in text
    assert "compute_90a,code=sm_90a" in " ".join(step_kernel.NVCC_FLAGS)
    assert "steppingstone_tpu_torch/build/" in (ROOT / ".gitignore").read_text()
    # the second build product: the URDF parser, from the repo's native
    # source, with the host compiler, into the same ignored directory
    assert urdf.SOURCE == ROOT / "native" / "urdf_loader.cpp" and urdf.SOURCE.exists()
    assert urdf.BUILD_DIR == step_kernel.BUILD_DIR
    assert urdf.library_path().parent == urdf.BUILD_DIR
    assert urdf.library_path().name.startswith("liburdf_loader_")


def test_k1_bound_counts():
    m = walker3d()
    # 198 f32 in and 83 f32 out per env and control step
    assert step_kernel.control_step_bytes(m, 20) == 4 * (198 + 83)
    flops = step_kernel.control_step_flops(m, 20, 4)
    assert 5e4 < flops < 5e5
    # planks: 20 stones' axes once, and 7 more operations per stone test
    assert step_kernel.control_step_flops(m, 20, 4, support_hy=1.5) == (
        flops + 31 * 20 + 4 * 12 * 7 * 20)
    # Cassie's stable PD: 10 actuated joints, targets and power read
    c = cassie()
    assert step_kernel.control_step_bytes(c, 20, pd=True) == (
        step_kernel.control_step_bytes(c, 20) + 4 * (14 + 1))
    assert step_kernel.control_step_flops(c, 20, 4, pd=True) == (
        step_kernel.control_step_flops(c, 20, 4) + 4 * 13 * 10)
    # rotated frames: one Hamilton product (28 operations) per substep for
    # each row that is not the identity; the bytes do not change
    for model in (m, c):
        r = with_rotated_frames(model, seed=0)
        rows = int(np.sum(np.any(r.joint_rot != np.array([1, 0, 0, 0]), axis=1)))
        assert 0 < rows < model.nbodies - 1
        for kw in (dict(), dict(pd=True, support_hy=1.5)):
            assert step_kernel.control_step_flops(r, 20, 4, rot=True, **kw) == (
                step_kernel.control_step_flops(model, 20, 4, **kw) + 4 * 28 * rows)
        assert step_kernel.control_step_bytes(r, 20) == step_kernel.control_step_bytes(model, 20)


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("batch", [64, 1000])
def test_k1_matches_plain_on_the_card(batch):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(batch)
    m, args = _k1_args(batch)
    args = [a.cuda() for a in args]
    args[0][:, 2] -= 0.25
    args[0][:, 7:] += 0.1 * torch.randn(args[0][:, 7:].shape, generator=g, device="cuda")
    args[1] += 0.3 * torch.randn(args[1].shape, generator=g, device="cuda")
    args[2] += 20 * torch.randn(args[2].shape, generator=g, device="cuda")
    args[3][..., :2] = torch.rand(args[3][..., :2].shape, generator=g, device="cuda") - 0.5
    args[5] = torch.rand(batch, generator=g, device="cuda") < 0.5
    before = step_kernel.CONTROL_STEP.launches["K1"]
    q, qd, info = step_kernel.control_step(m, *args)
    assert step_kernel.CONTROL_STEP.launches["K1"] == before + 1
    st, ref = engine._step_scan(m, engine.PhysicsState(args[0], args[1]), *args[2:])
    torch.cuda.synchronize()
    torch.testing.assert_close(q, st.q, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(qd, st.qd, rtol=2e-3, atol=2e-2)
    assert (info.foot_contact == ref.foot_contact).float().mean() > 0.999
    assert (info.foot_stone == ref.foot_stone).float().mean() > 0.995


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("variant", ["K2", "K3", "K2+K3"])
def test_k2_k3_match_plain_on_the_card(variant):
    """K2 on Walker3D torques over LargePlank planks, K3 on Cassie PD over
    discs, K2+K3 on Cassie PD over planks, against the plain version."""
    _check_variant_on_the_card(variant)


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("variant", ["K4", "K2+K4", "K3+K4", "K2+K3+K4"])
def test_k4_variants_match_plain_on_the_card(variant):
    """The rotated-frame variants on Walker3D (torques) and Cassie (PD)
    with fixed joint rotations drawn from a seed, over discs and planks,
    against the plain version."""
    _check_variant_on_the_card(variant)


@pytest.fixture
def card():
    """Skips the test on a host without a CUDA card: decided when the test
    runs, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


@pytest.mark.card
@pytest.mark.parametrize("batch", [4096, 64, 1])
@pytest.mark.parametrize("variant", ["K1", "K2", "K3", "K2+K3", "K4", "K3+K4", "K2+K4",
                                     "K2+K3+K4"])
def test_warp_design_matches_plain_on_the_card(card, variant, batch):
    """Every variant runs control_step_warp<PD, PLANK, ROT> (a warp per
    env): against the plain version at the main path's 4096 envs, at 64
    (one warp on an SM) and at 1 (enjoy's single env: one block, one live
    warp behind the tail guard), counted under the variant and never as the
    thread-per-env design."""
    thread = f"{variant}@thread"
    before = step_kernel.CONTROL_STEP.launches[thread]
    _check_variant_on_the_card(variant, batch)
    assert step_kernel.CONTROL_STEP.launches[thread] == before


def _to(x, device):
    """A tensor, or a (nested) NamedTuple of them, moved to `device`."""
    if isinstance(x, tuple):
        return type(x)(*(_to(y, device) for y in x))
    return x.to(device)


@pytest.mark.card
def test_value_grid_runs_k2_on_the_card(card):
    """The value grid's eval fleet (16 envs, Walker3D on LargePlank) steps
    through K2 on the card, one launch a step; its candidate observations
    and critic values on the fleet's last state equal the CPU's on the same
    state (1e-3)."""
    from steppingstone_tpu_torch.agents.networks import ActorCritic
    from steppingstone_tpu_torch.envs import make_env
    from steppingstone_tpu_torch.envs.stepper import create_temp_states
    from steppingstone_tpu_torch.runtime.curriculum import EVAL_ENVS, make_value_grid_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    env = make_env("Walker3DStepperEnv-v0", plank_class="LargePlank")
    policy = ActorCritic(60, 21, 2, generator=torch.Generator().manual_seed(0))
    fn = make_value_grid_fn(env, max_steps=20)
    before = dict(step_kernel.CONTROL_STEP.launches)
    grid, count = fn(policy)
    after = step_kernel.CONTROL_STEP.launches
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {"K2": 20}
    assert fn.venv.num_envs == EVAL_ENVS and grid.shape == (11, 11)
    assert torch.isfinite(grid).all()
    assert float(grid.abs().max()) == pytest.approx(1.0 if int(count) else 0.0, abs=1e-6)
    state, obs = fn.venv.reset()
    for _ in range(5):
        state, out = fn.venv.step(state, policy.action_mean(obs).detach())
        obs = out.obs
    temp = fn.venv.create_temp_states(state)
    cpu_env = make_env("Walker3DStepperEnv-v0", device="cpu", plank_class="LargePlank")
    temp_cpu = create_temp_states(cpu_env.cfg, _to(state, "cpu"))
    torch.testing.assert_close(temp.cpu(), temp_cpu, rtol=1e-3, atol=1e-3)
    with torch.no_grad():
        values = policy.ensemble_values(temp).cpu()
        values_cpu = policy.to("cpu").ensemble_values(temp_cpu)
    torch.testing.assert_close(values, values_cpu, rtol=1e-3, atol=1e-3)


def _check_variant_on_the_card(variant, batch=1000):
    torch.backends.cuda.matmul.allow_tf32 = False
    pd, plank, rot = step_kernel.VARIANTS[variant]
    g = torch.Generator(device="cuda").manual_seed(7)
    m = cassie() if pd else walker3d()
    if rot:
        m = with_rotated_frames(m, seed=1)
    st = engine.default_state(m, batch, "cuda")
    q = st.q.clone()
    q[:, 2] -= 0.15
    q[:, 7:] += 0.1 * torch.randn(q[:, 7:].shape, generator=g, device="cuda")
    qd = 0.3 * torch.randn(st.qd.shape, generator=g, device="cuda")
    stones = torch.zeros(batch, 20, 6, device="cuda")
    stones[..., :2] = torch.rand(stones[..., :2].shape, generator=g, device="cuda") - 0.5
    stones[..., 3] = torch.rand(stones[..., 3].shape, generator=g, device="cuda") - 0.5
    stones[..., 2] = -0.15
    args = [q, qd, torch.zeros(batch, m.njoints, device="cuda") if pd else
            20 * torch.randn(batch, m.njoints, generator=g, device="cuda"), stones,
            torch.full((batch,), 0.25, device="cuda"),
            torch.rand(batch, generator=g, device="cuda") < 0.5]
    kw = dict(support_hy=1.5 if plank else None)
    if pd:
        action = 2 * torch.rand(batch, m.action_dim, generator=g, device="cuda") - 1
        kw.update(target=engine.pd_target_from_action(m, action),
                  power=0.5 + 0.5 * torch.rand(batch, generator=g, device="cuda"))
    before = step_kernel.CONTROL_STEP.launches[variant]
    q1, qd1, info = step_kernel.control_step(m, *args, **kw)
    assert step_kernel.CONTROL_STEP.launches[variant] == before + 1
    pd_args = (kw["target"], kw["power"]) if pd else None
    ref_st, ref = engine._step_scan(m, engine.PhysicsState(q, qd), *args[2:], pd=pd_args,
                                    support_hy=kw["support_hy"])
    torch.cuda.synchronize()
    torch.testing.assert_close(q1, ref_st.q, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(qd1, ref_st.qd, rtol=2e-3, atol=2e-2)
    assert (info.foot_contact == ref.foot_contact).float().mean() > 0.999
    assert (info.foot_stone == ref.foot_stone).float().mean() > 0.995
    assert (info.joint_at_limit == ref.joint_at_limit).float().mean() > 0.999
