"""Structure of the PyTorch/CUDA port, checked on the CPU: it imports no
JAX, its entry points default to the card, the K1 wrapper refuses what the
kernel cannot take, and the kernel's source is where the build expects
it. The card-only test holds K1 against its plain version and skips on a
host without a GPU (run it on the card with `pytest tests/test_torch_structure.py`)."""

import ast
from pathlib import Path

import pytest
import torch

from steppingstone_tpu_torch.physics import engine, step_kernel
from steppingstone_tpu_torch.physics.robots.walker3d import walker3d

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "steppingstone_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "steppingstone_tpu")


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
    assert len(files) > 15
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f) if _forbidden(m)]
    assert bad == []
    assert not _forbidden("steppingstone_tpu_torch.physics")
    assert _forbidden("steppingstone_tpu.physics") and _forbidden("jax.numpy")


def test_entry_points_default_to_the_card():
    from steppingstone_tpu_torch.agents.networks import ActorCritic
    from steppingstone_tpu_torch.envs import make_env
    from steppingstone_tpu_torch.envs.vector import VecEnv

    if torch.cuda.is_available():
        assert make_env("Walker3DStepperEnv-v0").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_env("Walker3DStepperEnv-v0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ActorCritic(60, 21)
    env = make_env("Walker3DStepperEnv-v0", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VecEnv(env, 4)
    assert VecEnv(env, 4, device="cpu").device.type == "cpu"
    assert next(ActorCritic(60, 21, device="cpu").parameters()).device.type == "cpu"


def _k1_args(b=4, n_stones=20):
    m = walker3d()
    st = engine.default_state(m, b)
    return m, [st.q, st.qd, torch.zeros(b, m.njoints), torch.zeros(b, n_stones, 6),
               torch.full((b,), 0.25), torch.zeros(b, dtype=torch.bool)]


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "batch", "model"])
def test_k1_wrapper_rejects_bad_inputs(case):
    m, args = _k1_args()
    if case == "dtype":
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
        step_kernel.control_step(m, *args)


def test_k1_wrapper_refuses_rotated_frames():
    import dataclasses

    import numpy as np

    m, args = _k1_args()
    rot = np.tile(np.array([1, 0, 0, 0], np.float32), (m.nbodies, 1))
    with pytest.raises(NotImplementedError, match="K4"):
        step_kernel.control_step(dataclasses.replace(m, joint_rot=rot), *args)


def test_k1_wrapper_runs_the_plain_version_on_cpu():
    m, args = _k1_args()
    q, qd, info = step_kernel.control_step(m, *args)
    st, ref = engine._step_scan(m, engine.PhysicsState(args[0], args[1]), *args[2:])
    assert torch.equal(q, st.q) and torch.equal(qd, st.qd)
    assert torch.equal(info.foot_stone, ref.foot_stone)
    assert step_kernel.CONTROL_STEP.launches == 0


def test_kernel_source_is_the_only_one():
    sources = sorted(p.relative_to(PACKAGE) for ext in ("*.cu", "*.cuh", "*.cpp", "*.c")
                     for p in PACKAGE.rglob(ext) if "build" not in p.parts)
    assert sources == [Path("csrc/control_step.cu")]
    assert step_kernel.SOURCE == PACKAGE / "csrc" / "control_step.cu"
    text = step_kernel.SOURCE.read_text()
    assert "pallas_step.py" in text and "sm_90a" in text
    assert "compute_90a,code=sm_90a" in " ".join(step_kernel.NVCC_FLAGS)
    assert "steppingstone_tpu_torch/build/" in (ROOT / ".gitignore").read_text()


def test_k1_bound_counts():
    m = walker3d()
    # 198 f32 in and 83 f32 out per env and control step
    assert step_kernel.control_step_bytes(m, 20) == 4 * (198 + 83)
    flops = step_kernel.control_step_flops(m, 20, 4)
    assert 5e4 < flops < 5e5


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
    before = step_kernel.CONTROL_STEP.launches
    q, qd, info = step_kernel.control_step(m, *args)
    assert step_kernel.CONTROL_STEP.launches == before + 1
    st, ref = engine._step_scan(m, engine.PhysicsState(args[0], args[1]), *args[2:])
    torch.cuda.synchronize()
    torch.testing.assert_close(q, st.q, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(qd, st.qd, rtol=2e-3, atol=2e-2)
    assert (info.foot_contact == ref.foot_contact).float().mean() > 0.999
    assert (info.foot_stone == ref.foot_stone).float().mean() > 0.995
