"""control_step_warp (kernels K1 and K2) run on the CPU, where there is no
card: the kernel's part of csrc/control_step.cu is compiled with the host
C++ compiler against tests/warp_emulation.h, which runs each lane as a
thread and meets a warp's lanes at a barrier for __syncwarp and the
shuffles, block after block. Its outputs are held to the plain version
(engine._step_scan) with the Pallas kernel's bars (q 2e-4, qd 2e-3/2e-2,
foot force 1e-2/1.0), contact_force_sum (1e-3/1.0) and the diagnostics
exactly, on Walker3D and Cassie torques over discs and planks and on a
2-body pendulum over 6 stones (2 spheres, so 16 lanes a sphere), at ragged
batches (the last block has idle warps). This checks the kernel's lane
mapping, indexing, tables and synchronisation; its speed and the CUDA
compiler's view of it only the card shows (tests/test_torch_structure.py,
chip_smoke.py)."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from steppingstone_tpu_torch.physics import engine, step_kernel
from steppingstone_tpu_torch.physics.contact import ContactParams
from steppingstone_tpu_torch.physics.model import build_model
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

extern "C" int emulate_warp(const ModelData* m, int B, int S, int plank, float hy_margin,
                            int nlev, int npairs, const int* tab, const float* q,
                            const float* qd, const float* tau, const float* st, const float* sr,
                            const float* ug, float* q_out, float* qd_out, float* info_out) {
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
        if (plank)
          control_step_warp<true>(*m, m, lay, B, S, hy_margin, nlev, npairs, tab, q, qd, tau, st,
                                  sr, ug, q_out, qd_out, info_out);
        else
          control_step_warp<false>(*m, m, lay, B, S, hy_margin, nlev, npairs, tab, q, qd, tau,
                                   st, sr, ug, q_out, qd_out, info_out);
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
    fn.argtypes = ([ctypes.POINTER(step_kernel._ModelData)] + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10)
    return fn


def _pendulum():
    bodies = [
        dict(name="base", mass=5.0, inertia=(0.5, 0.5, 0.5), root_height=1.0),
        dict(name="arm", parent="base", anchor=(0, 0, 0), axis=(0, 1, 0), mass=1.0,
             com=(0, 0, -0.5), inertia=(0.05, 0.05, 0.05), damping=0.1, limits=(-2.0, 2.0)),
    ]
    contacts = [dict(body="arm", offset=(0, 0, -0.5), radius=0.05),
                dict(body="base", offset=(0, 0, -0.1), radius=0.05)]
    return build_model("pendulum", bodies, contacts)


def _inputs(model, batch, n_stones, plank, seed):
    """Perturbed standing states over a field of tilted stones, lowered so
    that feet touch stones and the ground; the first env and about a
    quarter of the others with the first joint past its upper limit; planks
    shift half the envs sideways."""
    g = torch.Generator().manual_seed(seed)
    q = engine.default_state(model, batch).q.clone()
    q[:, 2] -= 0.15 if model.name != "pendulum" else 0.47
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
    tau = 20 * torch.randn(batch, model.njoints, generator=g)
    return [q, qd, tau, stones, torch.full((batch,), 0.25),
            torch.rand(batch, generator=g) < 0.5]


CASES = {
    "walker3d_disc": (walker3d, False, 20, 6),
    "walker3d_plank": (walker3d, True, 20, 6),
    "walker3d_plank_7_stones": (walker3d, True, 7, 5),
    "cassie_disc": (cassie, False, 20, 5),
    "cassie_plank": (cassie, True, 20, 6),
    "pendulum_disc": (_pendulum, False, 6, 5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_warp_kernel_matches_plain(emulated, case):
    torch.set_num_threads(1)
    make, plank, n_stones, batch = CASES[case]
    model, cp = make(), ContactParams()
    args = _inputs(model, batch, n_stones, plank, seed=len(case))
    hy = 1.5 if plank else None
    md = step_kernel._model_data(model, cp, engine.SUBSTEPS)
    tab, nlev, npairs = step_kernel.kernel_tables(model)
    soa = step_kernel.to_kernel_layout(*args)
    outs = [torch.empty((n, batch)) for n in (model.nq, model.ndof, model.njoints + 7)]
    hy_margin = float(hy) + cp.margin if plank else 0.0
    size = emulated(ctypes.byref(md), batch, n_stones, int(plank), hy_margin, nlev, npairs,
                    *(t.data_ptr() for t in (torch.as_tensor(tab), *soa, *outs)))
    assert size == step_kernel.warp_floats(model.nbodies, model.ncontacts, n_stones, plank)
    st, ref = engine._step_scan(model, engine.PhysicsState(args[0], args[1]), *args[2:],
                                cp, support_hy=hy)
    q, qd, info = outs[0].t(), outs[1].t(), outs[2]
    nj = model.njoints
    torch.testing.assert_close(q, st.q, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(qd, st.qd, rtol=2e-3, atol=2e-2)
    torch.testing.assert_close(info[4:6].t(), ref.foot_normal_force, rtol=1e-2, atol=1.0)
    torch.testing.assert_close(info[6 + nj], ref.contact_force_sum, rtol=1e-3, atol=1.0)
    assert torch.equal(info[0:2].t() > 0.0, ref.foot_contact)
    assert torch.equal(info[2:4].t().long(), ref.foot_stone)
    assert torch.equal(info[6:6 + nj].t() > 0.5, ref.joint_at_limit)
    if model.name != "pendulum":  # contacts, stones and limits engage
        assert (ref.contact_force_sum > 0).any() and (ref.foot_stone >= 0).any()
        assert ref.joint_at_limit.any()
