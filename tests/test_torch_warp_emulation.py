"""control_step_warp<PD, PLANK, ROT> (all eight variants, K1..K4 and their
combinations) run on the CPU, where there is no card: the kernel's part of
csrc/control_step.cu is compiled with the host C++ compiler against
tests/warp_emulation.h, which runs each lane as a thread and meets a
warp's lanes at a barrier for __syncwarp and the shuffles, block after
block. Its outputs are held to the plain version (engine._step_scan) with
the Pallas kernel's bars (q 2e-4, qd 2e-3/2e-2, foot force 1e-2/1.0),
contact_force_sum (1e-3/1.0) and the diagnostics exactly: on Walker3D and
Cassie torques over discs and planks, on Cassie stable PD over discs and
planks, on a 2-body pendulum over 6 stones (2 spheres, so 16 lanes a
sphere) and on a PD pendulum whose one joint has only kp and the other
only kd (the gate kp != 0 || kd != 0), on Walker3D torques (K4, K2+K4) and
Cassie stable PD (K3+K4, K2+K3+K4) with fixed joint rotations drawn from
a seed, over discs and planks, and on the rotated pendulum of
tests/test_torch_urdf.py (K4, K2+K4), at ragged batches (the last block
has idle warps); on the robots' planks a disc-bound run of the same inputs
must differ, so the box bound bears load. The emulated K3 and K2+K3 are
also held to the JAX Pallas kernel's `pd=True` variant, and the emulated
K4, K3+K4, K2+K4 and K2+K3+K4 to its `joint_rot` variant (with
`support_hy` for the last two), in interpret mode (the bars of
tests/test_torch_physics.py) on a slice of its 1024-env tile. This checks
the kernel's lane mapping, indexing, tables, synchronisation, PD terms,
plank bound and rotated frames; its speed and the CUDA compiler's view of
it only the card shows (tests/test_torch_structure.py, chip_smoke.py)."""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_physics import _check_step, _pd_draws, _pd_pendulum
from test_torch_physics import _pendulum as _pallas_pendulum  # the pendulum of either package
from test_torch_physics import _inputs as _jax_inputs  # numpy inputs, JAX's default state

from steppingstone_tpu.physics import contact as jct
from steppingstone_tpu.physics import dynamics as jdyn
from steppingstone_tpu.physics import engine as jeng
from steppingstone_tpu.physics import pallas_step
from steppingstone_tpu.physics.model import build_model as jbuild
from steppingstone_tpu_torch.physics import engine, kinematics, step_kernel
from steppingstone_tpu_torch.physics.contact import ContactParams
from steppingstone_tpu_torch.physics.model import build_model, with_rotated_frames
from steppingstone_tpu_torch.physics.robots.cassie import cassie
from steppingstone_tpu_torch.physics.robots.walker3d import walker3d

HERE = Path(__file__).resolve().parent

HARNESS = r"""
#include "warp_emulation.h"
#include <memory>
#include <thread>
#include <vector>

float smem[1 << 18];  // the kernel's extern __shared__ array
#include "kernel_part.inc"

typedef void (*LaneBody)(const ModelData*, const WarpLayout&, int, int, float, unsigned,
                         const float*, int, int, const int*, const float*, const float*,
                         const float*, const float*, const float*, const float*, const float*,
                         const float*, float*, float*, float*);

template <bool PD, bool PLANK, bool ROT>
void lane_body(const ModelData* m, const WarpLayout& lay, int B, int S, float hy_margin,
               unsigned rot_rows, const float* jrot, int nlev, int npairs, const int* tab,
               const float* q, const float* qd, const float* tau, const float* target,
               const float* power, const float* st, const float* sr, const float* ug,
               float* q_out, float* qd_out, float* info_out) {
  control_step_warp<PD, PLANK, ROT>(*m, m, lay, B, S, hy_margin, rot_rows, jrot, nlev, npairs,
                                    tab, q, qd, tau, target, power, st, sr, ug, q_out, qd_out,
                                    info_out);
}

// the instantiations that control_step_launch dispatches: all eight
extern "C" int emulate_warp(const ModelData* m, int B, int S, int pd, int plank, int rot,
                            float hy_margin, unsigned rot_rows, const float* jrot, int nlev,
                            int npairs, const int* tab, const float* q, const float* qd,
                            const float* tau, const float* target, const float* power,
                            const float* st, const float* sr, const float* ug, float* q_out,
                            float* qd_out, float* info_out) {
  const LaneBody bodies[8] = {lane_body<false, false, false>, lane_body<false, true, false>,
                              lane_body<true, false, false>, lane_body<true, true, false>,
                              lane_body<false, false, true>, lane_body<false, true, true>,
                              lane_body<true, false, true>, lane_body<true, true, true>};
  const LaneBody run = bodies[4 * (rot != 0) + 2 * (pd != 0) + (plank != 0)];
  const WarpLayout lay = warp_layout(m->nb, m->nc, S, plank != 0);
  if ((long)WARP_ENVS * lay.size > (long)(sizeof(smem) / sizeof(float))) return -1;
  for (int b = 0; b < (B + WARP_ENVS - 1) / WARP_ENVS; ++b) {
    std::memset(smem, 0xff, sizeof(float) * WARP_ENVS * lay.size);  // NaN until written
    std::vector<std::unique_ptr<Warp>> warps;
    for (int w = 0; w < WARP_ENVS; ++w) warps.emplace_back(new Warp());
    std::vector<std::thread> lanes;
    for (int t = 0; t < WARP_ENVS * 32; ++t)
      lanes.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = WARP_ENVS * 32;
        this_warp = warps[t >> 5].get();
        run(m, lay, B, S, hy_margin, rot_rows, jrot, nlev, npairs, tab, q, qd, tau, target,
            power, st, sr, ug, q_out, qd_out, info_out);
      });
    for (auto& lane : lanes) lane.join();
  }
  return lay.size;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed"
    tmp = tmp_path_factory.mktemp("warp_emulation")
    src = step_kernel.SOURCE.read_text()
    # the kernels and host helpers, without the launch code (<<< >>>)
    cut = src.index("template <bool PD, bool PLANK, bool ROT>\nstatic void launch(")
    (tmp / "kernel_part.inc").write_text(src[:cut].replace("#include <cuda_runtime.h>", ""))
    (tmp / "harness.cpp").write_text(HARNESS)
    lib = tmp / "libwarp_emulation.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", str(HERE),
                    "-o", str(lib), str(tmp / "harness.cpp")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).emulate_warp
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.POINTER(step_kernel._ModelData)] + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_uint, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 12)
    return fn


def _emulate(emulated, model, args, target=None, power=None, support_hy=None):
    """One control step of the emulated control_step_warp on (B, k) inputs
    as control_step takes them -> (q, qd, engine.StepInfo)."""
    cp, (batch, n_stones) = ContactParams(), args[3].shape[:2]
    pd, plank, rot = target is not None, support_hy is not None, model.joint_rot is not None
    md = step_kernel._model_data(model, cp, engine.SUBSTEPS)
    jrot, rot_rows = step_kernel._joint_rotations(model, "cpu") if rot else (None, 0)
    tab, nlev, npairs = step_kernel.kernel_tables(model)
    soa = step_kernel.to_kernel_layout(*args)
    pd_ins = (target.t().contiguous(), power) if pd else (None, None)
    ins = (torch.as_tensor(tab), *soa[:3], *pd_ins, *soa[3:])
    outs = [torch.empty((n, batch)) for n in (model.nq, model.ndof, model.njoints + 7)]
    hy_margin = float(support_hy) + cp.margin if plank else 0.0
    ptr = lambda t: None if t is None else t.data_ptr()
    size = emulated(ctypes.byref(md), batch, n_stones, int(pd), int(plank), int(rot), hy_margin,
                    rot_rows, ptr(jrot), nlev, npairs, *(ptr(t) for t in (*ins, *outs)))
    assert size == step_kernel.warp_floats(model.nbodies, model.ncontacts, n_stones, plank)
    q, qd, info = outs[0].t(), outs[1].t(), outs[2]
    nj = model.njoints
    return q, qd, engine.StepInfo(
        foot_contact=info[0:2].t() > 0.0, foot_stone=info[2:4].t().long(),
        foot_normal_force=info[4:6].t(), joint_at_limit=info[6:6 + nj].t() > 0.5,
        contact_force_sum=info[6 + nj])


def _pendulum():
    bodies = [
        dict(name="base", mass=5.0, inertia=(0.5, 0.5, 0.5), root_height=1.0),
        dict(name="arm", parent="base", anchor=(0, 0, 0), axis=(0, 1, 0), mass=1.0,
             com=(0, 0, -0.5), inertia=(0.05, 0.05, 0.05), damping=0.1, limits=(-2.0, 2.0)),
    ]
    contacts = [dict(body="arm", offset=(0, 0, -0.5), radius=0.05),
                dict(body="base", offset=(0, 0, -0.1), radius=0.05)]
    return build_model("pendulum", bodies, contacts)


def _gate_pendulum():
    """A two-link PD pendulum as long as the one above: the upper joint has
    only kp, the lower only kd (the kernel's gate kp != 0 || kd != 0)."""
    link = dict(mass=0.5, com=(0, 0, -0.25), inertia=(0.01, 0.01, 0.01), damping=0.1,
                limits=(-2.0, 2.0), torque_limit=45.0)
    bodies = [
        dict(name="base", mass=5.0, inertia=(0.5, 0.5, 0.5), root_height=1.0),
        dict(name="upper", parent="base", anchor=(0, 0, 0), axis=(0, 1, 0), kp=60.0, **link),
        dict(name="lower", parent="upper", anchor=(0, 0, -0.25), axis=(1, 0, 0), kd=6.0, **link),
    ]
    contacts = [dict(body="lower", offset=(0, 0, -0.25), radius=0.05),
                dict(body="base", offset=(0, 0, -0.1), radius=0.05)]
    return build_model("pd_gate_pendulum", bodies, contacts)


# tests/test_torch_urdf.py's rotated pendulum: the arm's joint frame turned
# 0.4 rad about x (tests/test_pallas_step.py's rotated_small_model)
PENDULUM_ROT = np.array([[1, 0, 0, 0], [np.cos(0.2), np.sin(0.2), 0, 0]], np.float32)


def _rot_pendulum():
    return dataclasses.replace(_pendulum(), joint_rot=PENDULUM_ROT)


def _rot_walker3d():
    return with_rotated_frames(walker3d(), seed=3)


def _rot_cassie():
    return with_rotated_frames(cassie(), seed=3)


def _inputs(model, batch, n_stones, plank, seed):
    """Perturbed standing states over a field of tilted stones, lowered so
    that feet touch stones and the ground (rotated frames: at the
    unrotated robot's foot height); the first env and about a quarter of
    the others with the first joint past its upper limit; planks shift
    half the envs sideways. Returns (args, PD target, PD power), the
    target from random actions (some beyond [-1, 1]) and the power in
    [0.5, 1]."""
    g = torch.Generator().manual_seed(seed)
    q = engine.default_state(model, batch).q.clone()
    q[:, 2] -= 0.15 if "pendulum" not in model.name else 0.47
    q[:, 7:] += 0.1 * torch.randn(q[:, 7:].shape, generator=g)
    past = torch.rand(batch, generator=g) < 0.25
    past[0] = True
    q[past, 7] = float(model.joint_upper[0]) + 0.3
    qd = 0.3 * torch.randn((batch, model.ndof), generator=g)
    stones = torch.zeros(batch, n_stones, 6)
    stones[..., :2] = torch.rand(stones[..., :2].shape, generator=g) - 0.5
    stones[..., 2] = -0.15
    stones[..., 3] = torch.rand(stones[..., 3].shape, generator=g) - 0.5
    stones[..., 4:] = 0.1 * torch.randn(stones[..., 4:].shape, generator=g)
    if plank:
        q[:, 1] += (torch.rand(batch, generator=g) < 0.5) * (2.4 * torch.rand(batch, generator=g)
                                                             - 1.2)
    if model.joint_rot is not None:
        # rotated frames move the feet: lower each env until its lowest
        # sphere is where the unrotated robot's would be, so that feet
        # reach the stones
        lowest = lambda m: kinematics.contact_points(
            m, kinematics.forward_kinematics(m, q))[..., 2].min(dim=1).values
        q[:, 2] -= lowest(model) - lowest(dataclasses.replace(model, joint_rot=None))
    tau = 20 * torch.randn(batch, model.njoints, generator=g)
    args = [q, qd, tau, stones, torch.full((batch,), 0.25),
            torch.rand(batch, generator=g) < 0.5]
    action = 2.4 * torch.rand(batch, model.action_dim, generator=g) - 1.2
    power = 0.5 + 0.5 * torch.rand(batch, generator=g)
    return args, engine.pd_target_from_action(model, action), power


CASES = {  # model, planks, stone count, batch, stable PD
    "walker3d_disc": (walker3d, False, 20, 6, False),
    "walker3d_plank": (walker3d, True, 20, 6, False),
    "walker3d_plank_7_stones": (walker3d, True, 7, 5, False),
    "cassie_disc": (cassie, False, 20, 5, False),
    "cassie_plank": (cassie, True, 20, 6, False),
    "pendulum_disc": (_pendulum, False, 6, 5, False),
    "cassie_pd_disc": (cassie, False, 20, 7, True),
    "cassie_pd_plank": (cassie, True, 20, 6, True),
    "pd_gate_pendulum_disc": (_gate_pendulum, False, 6, 5, True),
    "pd_gate_pendulum_plank": (_gate_pendulum, True, 6, 7, True),
    "walker3d_rot_disc": (_rot_walker3d, False, 20, 6, False),
    "cassie_rot_pd_disc": (_rot_cassie, False, 20, 7, True),
    "rot_pendulum_disc": (_rot_pendulum, False, 6, 5, False),
    "walker3d_rot_plank": (_rot_walker3d, True, 20, 6, False),
    "cassie_rot_pd_plank": (_rot_cassie, True, 20, 7, True),
    "rot_pendulum_plank": (_rot_pendulum, True, 6, 5, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_warp_kernel_matches_plain(emulated, case):
    torch.set_num_threads(1)
    make, plank, n_stones, batch, pd = CASES[case]
    model, cp = make(), ContactParams()
    args, target, power = _inputs(model, batch, n_stones, plank, seed=len(case))
    hy = 1.5 if plank else None
    pd_kw = dict(target=target, power=power) if pd else {}
    q, qd, info = _emulate(emulated, model, args, support_hy=hy, **pd_kw)
    st, ref = engine._step_scan(model, engine.PhysicsState(args[0], args[1]), *args[2:],
                                cp, pd=(target, power) if pd else None, support_hy=hy)
    torch.testing.assert_close(q, st.q, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(qd, st.qd, rtol=2e-3, atol=2e-2)
    torch.testing.assert_close(info.foot_normal_force, ref.foot_normal_force, rtol=1e-2, atol=1.0)
    torch.testing.assert_close(info.contact_force_sum, ref.contact_force_sum, rtol=1e-3, atol=1.0)
    assert torch.equal(info.foot_contact, ref.foot_contact)
    assert torch.equal(info.foot_stone, ref.foot_stone)
    assert torch.equal(info.joint_at_limit, ref.joint_at_limit)
    if "pendulum" not in model.name:  # contacts, stones and limits engage
        assert (ref.contact_force_sum > 0).any() and (ref.foot_stone >= 0).any()
        assert ref.joint_at_limit.any()
        if plank:  # and the plank's box bears load where a disc would not
            disc = _emulate(emulated, model, args, **pd_kw)
            assert (disc[1] - qd).abs().max() > 1e-2
    if model.name == "pd_gate_pendulum":
        # the kp-only and the kd-only joint each move otherwise without PD
        kp, kd, _ = engine.pd_gains(model, "cpu")
        assert kp.tolist() == [60.0, 0.0] and kd.tolist() == [0.0, 6.0]
        free, _ = engine._step_scan(model, engine.PhysicsState(args[0], args[1]), *args[2:],
                                    cp, pd=(target, 0.0 * power), support_hy=hy)
        assert ((st.qd[:, 6:] - free.qd[:, 6:]).abs() > 1e-2).all()


@pytest.mark.parametrize("support_hy", [None, 0.6])
def test_emulated_pd_kernel_matches_pallas_interpret(emulated, support_hy):
    """The emulated K3 (discs) and K2+K3 (planks of half-width 0.6) against
    the TPU kernel's `pd=True` variant itself, run in interpret mode at one
    1024-env tile on the PD pendulum with the inputs of
    tests/test_torch_physics.py's Pallas PD test; the first 30 envs of the
    tile are emulated (a ragged last block) and held to the Pallas test's
    bars."""
    torch.set_num_threads(1)
    slice_ = 30
    mj, mt = _pd_pendulum(jbuild), _pd_pendulum(build_model)
    n = pallas_step.TILE
    rng = np.random.default_rng(10)
    q, qd, _, stones, sr, ug = _jax_inputs(rng, mj, b=n, n_stones=6, drop=0.47, stone_drop=0.0)
    q[::3, 7] = 2.05  # a third of the arms start past the joint limit
    action, power = _pd_draws(rng, mj, n)
    target = np.array(jax.vmap(lambda a: jeng.pd_target_from_action(mj, a))(action))
    tau = np.zeros((n, mj.njoints), np.float32)
    fn = pallas_step.build_batched_step(
        mj, jct.ContactParams(), 4, 6, jeng.SIM_DT, jeng.LIMIT_K, jeng.LIMIT_C,
        jeng.MAX_QD, jdyn.GRAVITY, interpret=True, pd=True, support_hy=support_hy)
    qn, qdn, d = fn(*(jnp.asarray(x) for x in (q, qd, tau, target, power, stones, sr, ug)))
    ref = jax.tree.map(lambda x: np.asarray(x)[:slice_], (qn, qdn, jeng.StepInfo(**d)))
    args = [torch.as_tensor(x[:slice_]) for x in (q, qd, tau, stones, sr, ug)]
    out = _emulate(emulated, mt, args, target=torch.as_tensor(target[:slice_]),
                   power=torch.as_tensor(power[:slice_]), support_hy=support_hy)
    _check_step(out, ref)
    info = out[2]
    assert (info.contact_force_sum > 0).any() and info.joint_at_limit.any()


@pytest.mark.parametrize("pd,support_hy", [
    pytest.param(False, None, id="False"), pytest.param(True, None, id="True"),
    pytest.param(False, 0.6, id="False-0.6"), pytest.param(True, 0.6, id="True-0.6")])
def test_emulated_rotated_kernel_matches_pallas_interpret(emulated, pd, support_hy):
    """The emulated K4 (torques) and K3+K4 (stable PD), and on planks of
    half-width 0.6 K2+K4 and K2+K3+K4, against the TPU kernel's `joint_rot`
    variant itself (with `pd=True` for PD, `support_hy` for planks), run
    in interpret mode at one 1024-env tile on the rotated pendulum of
    tests/test_torch_urdf.py and on its PD twin (the same rotation on the
    PD pendulum); the first 30 envs of the tile are emulated (a ragged last
    block) and held to the Pallas test's bars."""
    torch.set_num_threads(1)
    slice_ = 30
    make = _pd_pendulum if pd else _pallas_pendulum
    mj, mt = (dataclasses.replace(make(b), joint_rot=PENDULUM_ROT) for b in (jbuild, build_model))
    n = pallas_step.TILE
    rng = np.random.default_rng(14)
    q, qd, tau, stones, sr, ug = _jax_inputs(rng, mj, b=n, n_stones=6, drop=0.47, stone_drop=0.0)
    q[::3, 7] = 2.05  # a third of the arms start past the joint limit
    ins, pd_kw = (q, qd, tau, stones, sr, ug), {}
    if pd:
        action, power = _pd_draws(rng, mj, n)
        target = np.array(jax.vmap(lambda a: jeng.pd_target_from_action(mj, a))(action))
        tau = np.zeros((n, mj.njoints), np.float32)
        ins = (q, qd, tau, target, power, stones, sr, ug)
        pd_kw = dict(target=torch.as_tensor(target[:slice_]),
                     power=torch.as_tensor(power[:slice_]))
    fn = pallas_step.build_batched_step(
        mj, jct.ContactParams(), 4, 6, jeng.SIM_DT, jeng.LIMIT_K, jeng.LIMIT_C,
        jeng.MAX_QD, jdyn.GRAVITY, interpret=True, pd=pd, support_hy=support_hy)
    qn, qdn, d = fn(*(jnp.asarray(x) for x in ins))
    ref = jax.tree.map(lambda x: np.asarray(x)[:slice_], (qn, qdn, jeng.StepInfo(**d)))
    args = [torch.as_tensor(x[:slice_]) for x in (q, qd, tau, stones, sr, ug)]
    out = _emulate(emulated, mt, args, support_hy=support_hy, **pd_kw)
    _check_step(out, ref)
    info = out[2]
    assert (info.contact_force_sum > 0).any() and info.joint_at_limit.any()
    # the rotation matters: the unrotated kernel puts the arm elsewhere
    plain = _emulate(emulated, dataclasses.replace(mt, joint_rot=None), args,
                     support_hy=support_hy, **pd_kw)
    assert (plain[1] - out[1]).abs().max() > 1e-2
    if support_hy is not None:  # and so does the plank: a disc bound differs
        disc = _emulate(emulated, mt, args, **pd_kw)
        assert (disc[1] - out[1]).abs().max() > 1e-2
