"""Kernels K1..K4, the fused 60 Hz control step on the card, and their
wrapper.

The kernels (csrc/control_step.cu, CUDA C++ for sm_90a) replace the TPU
kernel steppingstone_tpu/physics/pallas_step.py `build_batched_step` in
each of its specializations:

- K1: torque actuation, disc support (pd=False, support_hy=None);
- K2: plank support (support_hy=<float>);
- K3: stable PD (pd=True, a per-joint target and a per-env power);
- K4: rotated joint frames (a model with `joint_rot`, from a URDF);
- their combinations K2+K3, K2+K4, K3+K4 and K2+K3+K4.

Every variant runs `control_step_warp<PD, PLANK, ROT>` (a warp per env,
its scratch in shared memory laid out by `warp_layout`, the tree walked
with the model's `kernel_tables`). The first design, the thread-per-env
template `control_step_kernel<PD, PLANK, ROT>`, stays built for timing the
two designs against each other (`launch(..., thread_design=True)`, counted
as "K1@thread" ... "K2+K3+K4@thread", `THREAD_DESIGN`); no path takes it.

It is built with nvcc from the repo's source at first use into `build/`
(listed in .gitignore) and bound with ctypes; each call builds nothing once
the library for the current source exists.

`control_step` is the only entry: CPU tensors run the plain PyTorch
version `engine._step_scan`; CUDA tensors launch the kernel or raise —
there is no fallback. `CONTROL_STEP.launches[key]` counts launches of
each variant (`COUNTED`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from steppingstone_tpu_torch.physics import engine
from steppingstone_tpu_torch.physics.contact import ContactParams
from steppingstone_tpu_torch.physics.dynamics import GRAVITY, _ancestor_mask
from steppingstone_tpu_torch.physics.model import RobotModel

# compile-time maxima of csrc/control_step.cu
MAXB, MAXC, MAXS = 32, 16, 32
MAXJ = MAXB - 1
MAXD = MAXJ + 6
# control_step_warp: envs (warps) per block, and the sections of the model's
# tables (mirrors of WARP_ENVS and T_* in csrc/control_step.cu)
WARP_ENVS = 4
T_LEVEL = 0
T_ORDER = T_LEVEL + MAXB + 1
T_CHILD = T_ORDER + MAXB
T_CHILDREN = T_CHILD + MAXB + 1
T_PAIRS = T_CHILDREN + MAXB
T_SIZE = T_PAIRS + MAXD * (MAXD + 1) // 2

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "control_step.cu"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# (pd, plank, rot) of each variant, as in the kernel's template arguments
VARIANTS = {"K1": (False, False, False), "K2": (False, True, False),
            "K3": (True, False, False), "K2+K3": (True, True, False),
            "K4": (False, False, True), "K2+K4": (False, True, True),
            "K3+K4": (True, False, True), "K2+K3+K4": (True, True, True)}
# the thread-per-env design of each variant, launched only to time the
# two designs
THREAD_DESIGN = {f"{v}@thread": v for v in VARIANTS}
COUNTED = (*VARIANTS, *THREAD_DESIGN)


def variant(pd: bool, plank: bool, rot: bool) -> str:
    return {v: k for k, v in VARIANTS.items()}[(bool(pd), bool(plank), bool(rot))]


def warp_layout(nb: int, nc: int, n_stones: int, plank: bool) -> dict:
    """One env's scratch of `control_step_warp` in shared memory, name ->
    (offset, floats) in order: mirror of `warp_layout` in
    csrc/control_step.cu, sized by the model and the stone count."""
    nd, S = nb + 5, n_stones
    sizes = dict(q=nb + 6, qd=nd, sc=3 * S, sn=3 * S, su=3 * S if plank else 0,
                 sv=3 * S if plank else 0, pos=3 * nb, quat=4 * nb, phi=6 * nd, vel=6 * nb,
                 acc=6 * nb, fb=6 * nb, ic=10 * nb, F=6 * nd, A=nd * (nd + 1) // 2, rhs=nd,
                 cpt=3 * nc, cpv=3 * nc, cft=6 * nc, cfn=nc, csi=nc)
    layout, offset = {}, 0
    for name, n in sizes.items():
        layout[name] = (offset, n)
        offset += n
    return layout


def warp_floats(nb: int, nc: int, n_stones: int, plank: bool) -> int:
    """Floats of one env's scratch in `control_step_warp`."""
    offset, n = list(warp_layout(nb, nc, n_stones, plank).values())[-1]
    return offset + n


def kernel_tables(model: RobotModel):
    """The model's tables for `control_step_warp`, as a (T_SIZE,) int32
    array, with the number of tree levels and of mass-matrix entries:
    bodies by tree level (level 0 is the root, each body one level below
    its parent, ties by index), each body's children in decreasing index
    (the order in which the serial loop adds them into their parent), and
    the nonzeros (k, l), l <= k, of the ancestor pattern as (k << 16) | l."""
    nb, parent = model.nbodies, [int(p) for p in model.parent]
    depth = [0] * nb
    for i in range(1, nb):
        depth[i] = depth[parent[i]] + 1
    nlev = max(depth) + 1
    order = sorted(range(nb), key=lambda i: (depth[i], i))
    tab = np.zeros(T_SIZE, np.int32)
    tab[T_LEVEL:T_LEVEL + nlev + 1] = np.searchsorted([depth[i] for i in order], np.arange(nlev + 1))
    tab[T_ORDER:T_ORDER + nb] = order
    children = [sorted((c for c in range(1, nb) if parent[c] == i), reverse=True)
                for i in range(nb)]
    tab[T_CHILD:T_CHILD + nb + 1] = np.cumsum([0] + [len(c) for c in children])
    flat = [c for cs in children for c in cs]
    tab[T_CHILDREN:T_CHILDREN + len(flat)] = flat
    mask = _ancestor_mask(model)
    pairs = [(k << 16) | l for k in range(model.ndof) for l in range(k + 1) if mask[k, l]]
    tab[T_PAIRS:T_PAIRS + len(pairs)] = pairs
    return tab, nlev, len(pairs)

_f, _i = ctypes.c_float, ctypes.c_int


class _ModelData(ctypes.Structure):
    """Mirror of `struct ModelData` in csrc/control_step.cu."""

    _fields_ = [
        ("anc", ctypes.c_uint64 * MAXD),
        ("nb", _i), ("nc", _i), ("substeps", _i), ("unused", _i),
        ("parent", _i * MAXB),
        ("cbody", _i * MAXC),
        ("cfoot", _i * MAXC),
        ("axis", (_f * 3) * MAXB),
        ("anchor", (_f * 3) * MAXB),
        ("com", (_f * 3) * MAXB),
        ("inertia", (_f * 3) * MAXB),
        ("mass", _f * MAXB),
        ("jlo", _f * MAXJ), ("jhi", _f * MAXJ), ("jdamp", _f * MAXJ),
        ("jstiff", _f * MAXJ), ("jref", _f * MAXJ),
        ("kp", _f * MAXJ), ("kd", _f * MAXJ), ("tlim", _f * MAXJ),
        ("coff", (_f * 3) * MAXC),
        ("crad", _f * MAXC),
        ("kn", _f), ("cn", _f), ("mu", _f), ("kt", _f), ("margin", _f),
        ("dt", _f), ("limit_k", _f), ("limit_c", _f), ("max_qd", _f),
        ("gravity", _f), ("reg", _f),
    ]


def check_model(model: RobotModel, n_stones: int) -> None:
    """Raise if the kernel cannot take this model or stone count."""
    if model.nbodies > MAXB or model.ncontacts > MAXC or n_stones > MAXS:
        raise ValueError(
            f"{model.name}: {model.nbodies} bodies, {model.ncontacts} contacts, "
            f"{n_stones} stones exceed the kernel's maxima {MAXB}/{MAXC}/{MAXS}"
        )


def _model_data(model: RobotModel, cparams: ContactParams, substeps: int) -> _ModelData:
    md = _ModelData()
    nb, nj, nc = model.nbodies, model.njoints, model.ncontacts
    mask = _ancestor_mask(model)
    for k in range(model.ndof):
        md.anc[k] = sum(1 << l for l in range(k + 1) if mask[k, l])
    md.nb, md.nc, md.substeps = nb, nc, substeps
    view = np.ctypeslib.as_array
    view(md.parent)[:nb] = model.parent
    view(md.cbody)[:nc] = model.contact_body
    view(md.cfoot)[:nc] = model.foot_of_contact
    view(md.axis)[:nb] = model.joint_axis
    view(md.anchor)[:nb] = model.joint_anchor
    view(md.com)[:nb] = model.com
    view(md.inertia)[:nb] = model.inertia
    view(md.mass)[:nb] = model.mass
    view(md.jlo)[:nj] = model.joint_lower
    view(md.jhi)[:nj] = model.joint_upper
    view(md.jdamp)[:nj] = model.joint_damping
    view(md.jstiff)[:nj] = model.joint_stiffness
    view(md.jref)[:nj] = model.joint_spring_ref
    for field, gains in zip(("kp", "kd", "tlim"), engine.pd_gains(model, "cpu")):
        view(getattr(md, field))[:nj] = gains.numpy()
    view(md.coff)[:nc] = model.contact_offset
    view(md.crad)[:nc] = model.contact_radius
    md.kn, md.cn, md.mu, md.kt, md.margin = (float(x) for x in cparams)
    md.dt, md.limit_k, md.limit_c = engine.SIM_DT, engine.LIMIT_K, engine.LIMIT_C
    md.max_qd, md.gravity, md.reg = engine.MAX_QD, GRAVITY, engine.REG
    return md


def _joint_rotations(model: RobotModel, device):
    """K4's operands: the (NB, 4) fixed joint rotations as a float32 tensor
    on `device`, and the bit mask of the rows that are not exactly the
    identity (those rows skip the product; nothing is snapped)."""
    rot = np.asarray(model.joint_rot, np.float32)
    rows = sum(1 << i for i in range(model.nbodies)
               if not np.array_equal(rot[i], np.array([1, 0, 0, 0], np.float32)))
    return torch.as_tensor(rot, device=device).contiguous(), rows


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the control-step kernels")
    return nvcc


class ControlStepKernel:
    """Builds, loads and launches the control-step kernels from `source`
    (by default the package's csrc/control_step.cu); `launches` counts the
    launches of each variant (`COUNTED`)."""

    def __init__(self, source: Path = SOURCE):
        self.source = Path(source)
        self.reset_counts()
        self.build_log = ""  # ptxas's register / local-memory report of the library
        self._lib = None
        self._models: dict = {}
        self._rotations: dict = {}
        self._tables: dict = {}
        self._model_copies: dict = {}

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"libcontrol_step_{digest.hexdigest()[:16]}.so"

    def build(self) -> float:
        """Compile (unless the library for this source exists) and load;
        ptxas's report is kept beside the library. Returns the seconds
        spent."""
        t0 = time.perf_counter()
        if self._lib is None:
            path = self.library_path()
            log = path.with_suffix(".log")
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
                                          check=True, capture_output=True, text=True)
                    log.write_text(done.stderr)
                    os.replace(tmp, path)  # atomic: concurrent builds agree
                except subprocess.CalledProcessError as err:
                    raise RuntimeError(f"nvcc failed on {self.source}:\n{err.stderr}") from err
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
            self.build_log = log.read_text() if log.exists() else ""
            lib = ctypes.CDLL(str(path))
            lib.control_step_model_size.restype = ctypes.c_int
            lib.control_step_model_size.argtypes = []
            lib.control_step_launch.restype = ctypes.c_int
            lib.control_step_launch.argtypes = (
                [ctypes.POINTER(_ModelData), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint, ctypes.c_int,
                 ctypes.c_int]
                + [ctypes.c_void_p] * 15
            )
            lib.control_step_launch_thread.restype = ctypes.c_int
            lib.control_step_launch_thread.argtypes = (
                [ctypes.POINTER(_ModelData), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint]
                + [ctypes.c_void_p] * 13
            )
            lib.control_step_warp_floats.restype = ctypes.c_int
            lib.control_step_warp_floats.argtypes = [ctypes.c_int] * 4
            lib.control_step_warp_envs_per_sm.restype = ctypes.c_int
            lib.control_step_warp_envs_per_sm.argtypes = [ctypes.c_int] * 6
            for fn in (lib.control_step_model_size, lib.control_step_tables_size,
                       lib.control_step_warp_envs_per_block):
                fn.restype = ctypes.c_int
                fn.argtypes = []
            mirrors = {"ModelData bytes": (lib.control_step_model_size(),
                                           ctypes.sizeof(_ModelData)),
                       "T_SIZE": (lib.control_step_tables_size(), T_SIZE),
                       "WARP_ENVS": (lib.control_step_warp_envs_per_block(), WARP_ENVS)}
            for name, (kernel, binding) in mirrors.items():
                if kernel != binding:
                    raise RuntimeError(f"{name} mismatch: kernel {kernel}, binding {binding}")
            self._lib = lib
        return time.perf_counter() - t0

    def reset_counts(self) -> None:
        self.launches = dict.fromkeys(COUNTED, 0)

    def _warp_operands(self, key, model, n_stones: int, plank: bool, device):
        """control_step_warp's device operands, cached: the model data of
        `key` (a key of `_models`) copied to `device`, whose per-body,
        per-joint and per-sphere arrays the lanes read each at its own
        index, and the model's tables, after checking that the binding's
        `warp_layout` mirror has the kernel's size for this model and stone
        count."""
        copy_key = (*key, device)
        if copy_key not in self._model_copies:
            self._model_copies[copy_key] = torch.frombuffer(
                bytearray(self._models[key]), dtype=torch.uint8).to(device)
        key = (model, n_stones, plank, device)
        if key not in self._tables:
            kernel = self._lib.control_step_warp_floats(model.nbodies, model.ncontacts, n_stones,
                                                         int(plank))
            binding = warp_floats(model.nbodies, model.ncontacts, n_stones, plank)
            if kernel != binding:
                raise RuntimeError(f"warp_layout mismatch for {model.name}: kernel {kernel} "
                                   f"floats, binding {binding}")
            tab, nlev, npairs = kernel_tables(model)
            self._tables[key] = (torch.as_tensor(tab, device=device), nlev, npairs)
        return (self._model_copies[copy_key], *self._tables[key])

    def warp_envs_per_sm(self, model, n_stones: int, pd: bool, plank: bool,
                         rot: bool = False) -> int:
        """Envs of control_step_warp<pd, plank, rot> resident on one SM of
        the current card for this model and stone count (the CUDA occupancy
        calculator)."""
        self.build()
        n = self._lib.control_step_warp_envs_per_sm(model.nbodies, model.ncontacts, n_stones,
                                                     int(pd), int(plank), int(rot))
        if n < 0:
            raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
        return n

    def launch(self, model, q_t, qd_t, tau_t, stones_t, stone_radius, use_ground,
               cparams: ContactParams, substeps: int, target_t=None, power=None,
               support_hy=None, thread_design: bool = False):
        """One launch on CUDA tensors in the kernel's struct-of-arrays
        layout, env index fastest: q_t (nq, B), qd_t (ndof, B), tau_t
        (NJ, B), stones_t (6 S, B), stone_radius (B,), use_ground (B,) as
        float32 0/1; for stable PD also target_t (NJ, B) and power (B,);
        for planks `support_hy` (a float); a model with `joint_rot` runs a
        K4 variant. `thread_design` launches the variant's thread-per-env
        body in place of control_step_warp, for timing the two. Returns
        new (nq, B), (ndof, B) and (NJ + 7, B) tensors. Callers check
        inputs (`control_step` does)."""
        self.build()
        model_key = (model, cparams, substeps)
        md = self._models.get(model_key)
        if md is None:
            md = self._models[model_key] = _model_data(model, cparams, substeps)
        pd, plank = target_t is not None, support_hy is not None
        rot = model.joint_rot is not None
        name = variant(pd, plank, rot)
        B, S = q_t.shape[1], stones_t.shape[0] // 6
        outs = [torch.empty((n, B), dtype=torch.float32, device=q_t.device)
                for n in (model.nq, model.ndof, model.njoints + 7)]
        ptr = lambda t: None if t is None else t.data_ptr()
        # the plank bound |y_l| <= hy + margin, rounded to f32 once, as the
        # plain version compares against the same sum
        hy_margin = float(support_hy) + cparams.margin if plank else 0.0
        jrot, rot_rows = None, 0
        if rot:
            key = (model, q_t.device)
            if key not in self._rotations:
                self._rotations[key] = _joint_rotations(model, q_t.device)
            jrot, rot_rows = self._rotations[key]
        with torch.cuda.device(q_t.device):
            stream = torch.cuda.current_stream(q_t.device).cuda_stream
            if thread_design:
                name += "@thread"
                err = self._lib.control_step_launch_thread(
                    ctypes.byref(md), B, S, int(pd), int(plank), int(rot), hy_margin, rot_rows,
                    *(ptr(t) for t in (jrot, q_t, qd_t, tau_t, target_t, power, stones_t,
                                       stone_radius, use_ground, *outs)), stream)
            else:
                md_dev, tables, nlev, npairs = self._warp_operands(model_key, model, S, plank,
                                                                   q_t.device)
                ins = (md_dev, tables, jrot, q_t, qd_t, tau_t, target_t, power, stones_t,
                       stone_radius, use_ground)
                err = self._lib.control_step_launch(
                    ctypes.byref(md), B, S, int(pd), int(plank), int(rot), hy_margin, rot_rows,
                    nlev, npairs, *(ptr(t) for t in ins + tuple(outs)), stream)
        if err != 0:
            raise RuntimeError(f"control_step kernel launch failed: CUDA error {err}")
        self.launches[name] += 1
        return outs


def to_kernel_layout(q, qd, tau, stones, stone_radius, use_ground):
    """(B, k) inputs -> the kernel's (k, B) layout (pallas_step.py pack)."""
    B = q.shape[0]
    return (q.t().contiguous(), qd.t().contiguous(), tau.t().contiguous(),
            stones.reshape(B, -1).t().contiguous(), stone_radius,
            use_ground.to(torch.float32))


CONTROL_STEP = ControlStepKernel()


def _check_inputs(model: RobotModel, q, qd, tau, stones, stone_radius, use_ground,
                  target=None, power=None):
    B = q.shape[0] if q.dim() == 2 else -1
    expect = {
        "q": (q, (B, model.nq), torch.float32),
        "qd": (qd, (B, model.ndof), torch.float32),
        "tau": (tau, (B, model.njoints), torch.float32),
        "stones": (stones, (B, stones.shape[1] if stones.dim() == 3 else -1, 6),
                   torch.float32),
        "stone_radius": (stone_radius, (B,), torch.float32),
        "use_ground": (use_ground, (B,), torch.bool),
    }
    if target is not None:
        expect["target"] = (target, (B, model.njoints), torch.float32)
        expect["power"] = (power, (B,), torch.float32)
    for name, (t, shape, dtype) in expect.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape or B <= 0:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, q on {q.device}")


def _batched(x, B: int, unbatched_dim: int, dtype, device):
    """x as a tensor; an operand with `unbatched_dim` dims (one env's, or a
    scalar) is repeated over the batch, as engine.py's vmap rule does."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=dtype, device=device)
    if x.dim() == unbatched_dim:
        x = x.expand((B,) + tuple(x.shape)).contiguous()
    return x


def control_step(
    model: RobotModel,
    q: torch.Tensor,             # (B, nq) float32
    qd: torch.Tensor,            # (B, ndof) float32
    tau: torch.Tensor,           # (B, NJ) or (NJ,) float32 joint torques
    stones: torch.Tensor,        # (B, S, 6) or (S, 6) float32
    stone_radius,                # (B,) float32 or a scalar
    use_ground,                  # (B,) bool or a scalar
    cparams: ContactParams = ContactParams(),
    substeps: int = engine.SUBSTEPS,
    target=None,                 # stable PD: (B, NJ) or (NJ,) float32 joint targets
    power=None,                  # stable PD: (B,) float32 or a scalar torque scale
    support_hy=None,             # plank support: lateral half-extent (a float)
):
    """One control step for B envs -> (q', qd', engine.StepInfo). CPU
    tensors run the plain version; CUDA tensors run K1, K2 (support_hy),
    K3 (target), K4 (a model with joint_rot) or their combination.
    Operands with no batch axis are broadcast."""
    B, dev = q.shape[0], q.device
    tau = _batched(tau, B, 1, torch.float32, dev)
    stones = _batched(stones, B, 2, torch.float32, dev)
    stone_radius = _batched(stone_radius, B, 0, torch.float32, dev)
    use_ground = _batched(use_ground, B, 0, torch.bool, dev)
    if target is not None:
        target = _batched(target, B, 1, torch.float32, dev)
        power = _batched(1.0 if power is None else power, B, 0, torch.float32, dev)
    _check_inputs(model, q, qd, tau, stones, stone_radius, use_ground, target, power)
    check_model(model, stones.shape[1])
    if dev.type == "cpu":
        st, info = engine._step_scan(
            model, engine.PhysicsState(q, qd), tau, stones, stone_radius, use_ground,
            cparams, substeps, pd=None if target is None else (target, power),
            support_hy=support_hy)
        return st.q, st.qd, info
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    q_t, qd_t, info = CONTROL_STEP.launch(
        model, *to_kernel_layout(q, qd, tau, stones, stone_radius, use_ground),
        cparams, substeps, target_t=None if target is None else target.t().contiguous(),
        power=power, support_hy=support_hy)
    nj = model.njoints
    return q_t.t().contiguous(), qd_t.t().contiguous(), engine.StepInfo(
        foot_contact=(info[0:2] > 0.0).t(),
        foot_stone=info[2:4].t().to(torch.long),
        foot_normal_force=info[4:6].t(),
        joint_at_limit=(info[6:6 + nj] > 0.5).t(),
        contact_force_sum=info[6 + nj].clone(),
    )


def control_step_bytes(model: RobotModel, n_stones: int, pd: bool = False) -> int:
    """Bytes a control step must move per env: every input read once,
    every output written once (f32); stable PD adds the targets and the
    power."""
    inputs = model.nq + model.ndof + model.njoints + 6 * n_stones + 2
    if pd:
        inputs += model.njoints + 1
    outputs = model.nq + model.ndof + model.njoints + 7
    return 4 * (inputs + outputs)


def control_step_flops(model: RobotModel, n_stones: int, substeps: int,
                       pd: bool = False, support_hy=None, rot: bool = False) -> int:
    """fp32 operations one env's control step needs, counted section by
    section from csrc/control_step.cu: each add, multiply, divide,
    min/max, abs, sqrt, rsqrt and sin/cos counts one (an FMA counts two).
    The Cholesky factor and solves are counted at the ancestor sparsity of
    the mass matrix (no fill-in for a tree), the work the function needs;
    the kernel's dense loops do more. Stable PD adds the per-joint torque
    and the two diagonal terms on every joint with a gain; planks add each
    stone's in-plane axes (once per control step) and the second bound of
    the box test; rotated frames (`rot`, the model's `joint_rot`) add one
    Hamilton product (16 multiplies, 12 adds) per row that is not the
    identity."""
    nb, nj, nd, nc, S = model.nbodies, model.njoints, model.ndof, model.ncontacts, n_stones
    mask = _ancestor_mask(model)
    pairs = int(mask.sum())                      # nonzeros of the lower triangle
    fk = nj * 67 + nb * 96                       # joint frames; R, CoM, world inertia
    vel = nj * 54                                # motion axes, body velocities
    # per stone and sphere: relative position (3), height (5), lateral (6),
    # penetration (1), bound (disc: |lat| 6; plank: two projections 10,
    # two abs 2, one compare more 1), validity and the running max (3)
    per_stone = 24 if support_hy is None else 31
    contact = nc * (33 + per_stone * S + 2 + 53)  # per sphere: pose, S stone tests, force
    joints = nj * 22                             # limit, passive, implicit diagonals
    if pd:
        # kp (target - q) - kd qd (5), clamp (2), power x torque and its add
        # (2), power x kd and x kp and their adds (4)
        joints += 13 * int(np.count_nonzero((model.kp != 0) | (model.kd != 0)))
    crba = nb * 32 + nj * 10 + nd * 42 + pairs * 12
    rnea = nj * 42 + nb * 126 + nj * 6 + nd * 12
    chol = 0
    for j in range(nd):
        col = [i for i in range(j, nd) if mask[i, j]]
        chol += 2 + len(col)                      # pivot, scale the column
        for k in col[1:]:
            chol += 2 * sum(1 for i in col if i >= k)
    solves = 2 * (2 * (pairs - nd) + nd)
    euler = 3 * nd + 40 + 2 * nc
    if rot:
        fk += 28 * bin(_joint_rotations(model, "cpu")[1]).count("1")
    per_substep = fk + vel + contact + joints + crba + rnea + nd * 5 + chol + solves + euler
    # stone normals (7 per stone); plank axes: heading cos/sin (2), h.n (5),
    # projection (6), norm and scale (9), n x ux (9)
    per_step = 7 * S + (31 * S if support_hy is not None else 0)
    return substeps * per_substep + per_step
