"""control_step_warp<PD, PLANK, ROT> (all eight variants, K1..K4 and their
combinations) run on the CPU, where there is no card: the kernel's part of
csrc/control_step.cu is compiled with the host C++ compiler against
tests/warp_emulation.h, which runs each lane as a fiber on one thread: a
warp's lanes in turn, each up to the warp's next meeting point (__syncwarp
and the shuffles), warp after warp and block after block. Every step runs
twice, the lanes in ascending and then in descending order, and the two
must agree bit for bit, so a missing meeting point shows as a difference
or a NaN (test_emulation_sees_a_missing_syncwarp plants one). Its outputs
are held to the plain version (engine._step_scan) with
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
it only the card shows (tests/test_torch_structure.py, chip_smoke.py).
The same build emulates foot_positions, the feet's world origins, against
the plain forward kinematics on Walker3D, Cassie and rotated Walker3D, and
adam_step, the PPO step's optimizer, bit for bit against the plain
optimizer (agents/ppo.py `_adam_plain`)."""

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
from steppingstone_tpu_torch.agents import ppo
from steppingstone_tpu_torch.envs.stepper import _foot_bodies
from steppingstone_tpu_torch.physics import engine, kinematics, step_kernel
from steppingstone_tpu_torch.physics.contact import ContactParams
from steppingstone_tpu_torch.physics.model import build_model, with_rotated_frames
from steppingstone_tpu_torch.physics.robots.cassie import cassie
from steppingstone_tpu_torch.physics.robots.walker3d import walker3d

HERE = Path(__file__).resolve().parent

HARNESS = r"""
#include "warp_emulation.h"

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

// the instantiations that control_step_launch dispatches: all eight, the
// lanes of each warp in ascending order between meeting points, or in
// descending order; returns the layout's floats, -1 if the blocks' shared
// memory does not fit, -2 if a warp's lanes diverge at a meeting point
extern "C" int emulate_warp(const ModelData* m, int B, int S, int pd, int plank, int rot,
                            float hy_margin, unsigned rot_rows, const float* jrot, int nlev,
                            int npairs, const int* tab, const float* q, const float* qd,
                            const float* tau, const float* target, const float* power,
                            const float* st, const float* sr, const float* ug, float* q_out,
                            float* qd_out, float* info_out, int descending) {
  const LaneBody bodies[8] = {lane_body<false, false, false>, lane_body<false, true, false>,
                              lane_body<true, false, false>, lane_body<true, true, false>,
                              lane_body<false, false, true>, lane_body<false, true, true>,
                              lane_body<true, false, true>, lane_body<true, true, true>};
  const LaneBody run = bodies[4 * (rot != 0) + 2 * (pd != 0) + (plank != 0)];
  const WarpLayout lay = warp_layout(m->nb, m->nc, S, plank != 0);
  if ((long)WARP_ENVS * lay.size > (long)(sizeof(smem) / sizeof(float))) return -1;
  const std::function<void()> body = [&] {
    run(m, lay, B, S, hy_margin, rot_rows, jrot, nlev, npairs, tab, q, qd, tau, target, power,
        st, sr, ug, q_out, qd_out, info_out);
  };
  for (int b = 0; b < (B + WARP_ENVS - 1) / WARP_ENVS; ++b) {
    std::memset(smem, 0xff, sizeof(float) * WARP_ENVS * lay.size);  // NaN until written
    for (int w = 0; w < WARP_ENVS; ++w)
      if (!warp_emulation::run_warp(body, b, w, WARP_ENVS * 32, descending != 0))
        return -2;
  }
  return lay.size;
}

// foot_positions over a batch as foot_positions_launch grids it: block after
// block of FOOT_THREADS threads, warp after warp; returns the blocks, or -2
// if a warp's lanes diverge at a meeting point
extern "C" int emulate_feet(const ModelData* m, const int* chains, int nchains,
                            const float* jrot, int B, const float* q, float* out) {
  const int blocks = (int)(((long)B * nchains + FOOT_THREADS - 1) / FOOT_THREADS);
  const std::function<void()> body = [&] { foot_positions(m, chains, nchains, jrot, B, q, out); };
  for (int b = 0; b < blocks; ++b)
    for (int w = 0; w < FOOT_THREADS / 32; ++w)
      if (!warp_emulation::run_warp(body, b, w, FOOT_THREADS, false)) return -2;
  return blocks;
}

// adam_step over `total` elements as adam_step_launch grids it: block after
// block of ADAM_THREADS threads, warp after warp; returns the blocks, or -2
// if a warp's lanes diverge at a meeting point
extern "C" int emulate_adam(const float* g, float* mu, float* nu, const long long* table,
                            int nparams, long long total, const float* gnorm,
                            const float* approx_kl, const float* lr, const int* count,
                            float max_norm, float b1, float b2, float one_minus_b1,
                            float one_minus_b2, float eps, int gate, float kl_cutoff) {
  const int blocks = (int)((total + ADAM_THREADS - 1) / ADAM_THREADS);
  const std::function<void()> body = [&] {
    adam_step(g, mu, nu, table, nparams, total, gnorm, approx_kl, lr, count, max_norm, b1, b2,
              one_minus_b1, one_minus_b2, eps, gate, kl_cutoff);
  };
  for (int b = 0; b < blocks; ++b)
    for (int w = 0; w < ADAM_THREADS / 32; ++w)
      if (!warp_emulation::run_warp(body, b, w, ADAM_THREADS, false)) return -2;
  return blocks;
}
"""
# the host-launch code starts here (<<< >>>); the kernels and helpers before it
CUT = "template <bool PD, bool PLANK, bool ROT>\nstatic cudaError_t warp_prepare("


def _build(tmp, src):
    """The kernels' part of `src` (control_step_warp, foot_positions and
    adam_step) compiled against warp_emulation.h into `tmp` -> the library,
    with its `emulate_warp`, `emulate_feet` and `emulate_adam`."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed"
    part = src[:src.index(CUT)].replace("#include <cuda_runtime.h>", "")
    (tmp / "kernel_part.inc").write_text(part)
    (tmp / "harness.cpp").write_text(HARNESS)
    lib = tmp / "libwarp_emulation.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(HERE), "-o", str(lib),
                    str(tmp / "harness.cpp")], check=True, capture_output=True)
    built = ctypes.CDLL(str(lib))
    fn = built.emulate_warp
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.POINTER(step_kernel._ModelData)] + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_uint, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 12 + [ctypes.c_int])
    feet = built.emulate_feet
    feet.restype = ctypes.c_int
    feet.argtypes = [ctypes.POINTER(step_kernel._ModelData), ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    adam = built.emulate_adam
    adam.restype = ctypes.c_int
    adam.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong]
                     + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_float])
    return built


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("warp_emulation"), step_kernel.SOURCE.read_text())


@pytest.fixture(scope="module")
def emulated(emulated_library):
    return emulated_library.emulate_warp


def _run(emulated, model, args, target=None, power=None, support_hy=None, descending=False):
    """One control step of the emulated control_step_warp on (B, k) inputs
    as control_step takes them, the lanes of each warp in ascending or
    descending order between meeting points -> its (nq, B), (ndof, B) and
    (NJ + 7, B) outputs."""
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
                    rot_rows, ptr(jrot), nlev, npairs, *(ptr(t) for t in (*ins, *outs)),
                    int(descending))
    assert size == step_kernel.warp_floats(model.nbodies, model.ncontacts, n_stones, plank)
    return outs


def _bit_equal(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def _emulate(emulated, model, args, target=None, power=None, support_hy=None):
    """One control step of the emulated control_step_warp, run twice: the
    lanes in ascending, then in descending order between meeting points.
    The two must agree bit for bit (a read of another lane's shared-memory
    write with no meeting point in between reads NaN or a stale value in
    one of the orders) -> (q, qd, engine.StepInfo)."""
    up, down = (_run(emulated, model, args, target, power, support_hy, descending)
                for descending in (False, True))
    assert _bit_equal(up, down), "the two lane orders disagree: a missing meeting point"
    q, qd, info = up[0].t(), up[1].t(), up[2]
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


def test_emulation_sees_a_missing_syncwarp(emulated, tmp_path):
    """The harness finds a missing meeting point: with the __syncwarp
    before the contact tests taken out of the source, the stone-test lanes
    read the sphere centers that other lanes write with no meeting point in
    between, and on a Walker3D plank case the two lane orders then disagree
    or an output is NaN; the kernel as it is agrees with itself there."""
    src = step_kernel.SOURCE.read_text()
    contacts = "\n\n    // ---- contacts: the deepest valid support"
    assert src.count("    __syncwarp();" + contacts) == 1
    faulty = _build(tmp_path, src.replace("    __syncwarp();" + contacts, contacts)).emulate_warp
    make, plank, n_stones, batch, _ = CASES["walker3d_plank"]
    model = make()
    args, _, _ = _inputs(model, batch, n_stones, plank, seed=3)
    intact = [_run(emulated, model, args, support_hy=1.5, descending=d) for d in (False, True)]
    assert _bit_equal(*intact)
    up, down = (_run(faulty, model, args, support_hy=1.5, descending=d) for d in (False, True))
    assert not _bit_equal(up, down) or any(torch.isnan(t).any() for t in (*up, *down))


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


FOOT_MODELS = {"walker3d": walker3d, "cassie": cassie, "walker3d_rotated": _rot_walker3d}


@pytest.mark.parametrize("name", list(FOOT_MODELS))
def test_emulated_foot_kernel_matches_plain_kinematics(emulated_library, name):
    """foot_positions, emulated at a ragged batch (the last block has idle
    threads), against the plain forward kinematics' feet (1e-5 + 1e-6 |x|)
    on random poses: root anywhere and turned anyhow, joints past their
    limits; in one env a NaN in the angle of the joint above the right foot
    makes that foot NaN and leaves the left one finite, as in the plain
    version."""
    torch.set_num_threads(1)
    model = FOOT_MODELS[name]()
    feet = _foot_bodies(model)
    batch = 70
    g = torch.Generator().manual_seed(len(name))
    q = engine.default_state(model, batch).q.clone()
    q[:, :3] += torch.randn((batch, 3), generator=g)
    quat = torch.randn((batch, 4), generator=g)
    q[:, 3:7] = quat / quat.norm(dim=1, keepdim=True)
    lo, hi = (torch.as_tensor(x, dtype=torch.float32) for x in (model.joint_lower,
                                                                 model.joint_upper))
    q[:, 7:] = lo - 0.3 + (hi - lo + 0.6) * torch.rand((batch, model.njoints), generator=g)
    above = int(model.parent[feet[0]])
    q[5, 6 + above] = float("nan")
    md = step_kernel._model_data(model, ContactParams(), engine.SUBSTEPS)
    chains = torch.as_tensor(step_kernel.foot_chains(model, feet))
    jrot = None if model.joint_rot is None else step_kernel._joint_rotations(model, "cpu")[0]
    out = torch.full((batch, len(feet), 3), -7.0)
    blocks = emulated_library.emulate_feet(
        ctypes.byref(md), chains.data_ptr(), len(feet), None if jrot is None else jrot.data_ptr(),
        batch, q.data_ptr(), out.data_ptr())
    assert blocks == 2  # 140 threads, 128 a block
    ref = kinematics.forward_kinematics(model, q).pos[:, list(feet)]
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-5, equal_nan=True)
    assert torch.equal(out.isnan(), ref.isnan())
    assert out[5, 0].isnan().all() and out[5, 1].isfinite().all()
    assert out[torch.arange(batch) != 5].isfinite().all()
    torch.testing.assert_close(step_kernel.foot_positions(model, q, feet), ref, rtol=0, atol=0,
                               equal_nan=True)  # the CPU entry is the plain version
    if model.joint_rot is not None:  # the rotations move the feet
        plain = kinematics.forward_kinematics(dataclasses.replace(model, joint_rot=None), q)
        assert (plain.pos[:, list(feet)] - ref)[:5].abs().max() > 1e-2


# (gradient scale, a NaN in the gradient, count, KL guard: None off, else
# (approx_kl, cutoff))
ADAM_CASES = {"unclipped": (0.01, False, 5, None), "clipped": (40.0, False, 12_345, None),
              "gate_fires": (40.0, False, 7, (0.5, 0.12)),
              "gate_holds": (0.01, False, 1, (0.05, 0.12)),
              "nan_gate_fires": (0.01, True, 3, (0.5, 0.12))}


@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_emulated_adam_kernel_matches_plain_optimizer(emulated_library, case, monkeypatch):
    """adam_step, emulated over parameters of ragged sizes (556 elements: the
    last of 3 blocks has idle threads), against the plain optimizer on the
    same inputs bit for bit: mu, nu and every parameter; an unclipped and a
    clipped gradient, counts from 1 to 12,345, the KL guard off, holding
    and firing (the step size 0). A NaN in the gradient makes every norm,
    moment and parameter NaN, with the guard firing too (0 x NaN)."""
    scale, nan, count, guard = ADAM_CASES[case]
    cfg = ppo.PPOConfig()
    g = torch.Generator().manual_seed(len(case))
    shapes = [(7, 13), (13,), (50, 3), (1,), (301,)]
    # parameters of the step's size, so that a step's last bit shows in them
    params = [1e-4 * torch.randn(s, generator=g) for s in shapes]
    total = sum(p.numel() for p in params)
    grad = scale * torch.randn(total, generator=g)
    if nan:
        grad[100] = float("nan")
    mu = 0.1 * torch.randn(total, generator=g)
    nu = 0.01 * torch.rand(total, generator=g)
    gnorm = torch.sqrt(torch.sum(grad * grad))
    assert bool(gnorm < cfg.max_grad_norm) == (scale < 1.0) or nan
    kl = torch.tensor(0.0 if guard is None else guard[0])
    lr = torch.tensor(3e-4)
    counter = torch.tensor(count, dtype=torch.int32)
    cutoff = None if guard is None else guard[1]

    before = [p.clone() for p in params]
    plain_before = ppo.AdamState(counter.clone(), mu.clone(), nu.clone())
    plain = ppo.AdamState(counter.clone(), mu.clone(), nu.clone())
    plain_params = [p.clone() for p in params]
    # PyTorch's CPU sqrt (MKL's) may miss the correctly rounded root by an
    # ulp; its CUDA sqrt, which the kernel's __fsqrt_rn meets, does not: the
    # plain optimizer here takes the correctly rounded root (numpy's)
    ieee_sqrt = lambda x: torch.from_numpy(np.sqrt(x.numpy()))
    monkeypatch.setattr(torch, "sqrt", ieee_sqrt)
    ppo._adam_plain(plain_params, plain, cfg, grad, gnorm, kl, lr, cutoff)
    monkeypatch.undo()

    ends = np.cumsum([p.numel() for p in params])
    table = torch.as_tensor(np.concatenate([[p.data_ptr() for p in params], ends]),
                            dtype=torch.int64)
    blocks = emulated_library.emulate_adam(
        grad.data_ptr(), mu.data_ptr(), nu.data_ptr(), table.data_ptr(), len(params), total,
        gnorm.data_ptr(), kl.data_ptr(), lr.data_ptr(), counter.data_ptr(),
        *step_kernel.adam_constants(cfg.max_grad_norm, ppo.ADAM_B1, ppo.ADAM_B2, cfg.eps,
                                    cutoff))
    assert blocks == 3  # 556 threads, 256 a block

    def same(a, b):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a[~a.isnan()], b[~b.isnan()])

    same(mu, plain.mu)
    same(nu, plain.nu)
    for p, q in zip(params, plain_params):
        same(p, q)
    if nan:
        assert all(x.isnan().all() for x in (mu, nu, *params))
    elif guard is not None and guard[0] > guard[1]:  # no step, the moments advance
        assert all(torch.equal(p, b) for p, b in zip(params, before))
        assert not torch.equal(mu, plain_before.mu)
    else:
        assert all(not torch.equal(p, b) for p, b in zip(params, before))
