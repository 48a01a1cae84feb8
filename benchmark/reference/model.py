"""Articulated rigid-body model description (own copy of
steppingstone_tpu/physics/model.py; numpy data, no framework).

All model data is static numpy. `tensor(model, field, device)` hands out
cached torch copies of the numeric fields for the batched PyTorch code;
the CUDA kernel receives the same fields packed into one struct
(physics/step_kernel.py).

Topology: body 0 is the floating root (6 DoF); every other body is
connected to its parent by a single revolute joint whose frame origin
coincides with the body frame origin. Generalized coordinates:

    q  = [root_pos(3), root_quat(4, wxyz), joint_angles(NJ)]
    qd = [omega_world(3), v_root_world(3), joint_vels(NJ)]

where NJ = nbodies - 1 and ndof = 6 + NJ.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class RobotModel:
    """Static description of one robot morphology (all numpy).

    eq=False keeps identity-based hashing so models can key caches
    (numpy fields are unhashable).
    """

    name: str
    # --- topology -------------------------------------------------------
    parent: np.ndarray        # (NB,) int, parent[0] = -1, parent[i] < i
    joint_axis: np.ndarray    # (NB, 3) unit axis in body frame (row 0 unused)
    joint_anchor: np.ndarray  # (NB, 3) joint origin in *parent* frame (row 0 unused)
    # --- inertial -------------------------------------------------------
    mass: np.ndarray          # (NB,)
    com: np.ndarray           # (NB, 3) CoM offset in body frame
    inertia: np.ndarray       # (NB, 3) principal rotational inertia about CoM (body axes)
    # --- joints ---------------------------------------------------------
    joint_lower: np.ndarray   # (NJ,) lower position limit (rad)
    joint_upper: np.ndarray   # (NJ,)
    joint_damping: np.ndarray  # (NJ,) passive viscous damping
    joint_stiffness: np.ndarray  # (NJ,) passive spring stiffness (0 = none)
    joint_spring_ref: np.ndarray  # (NJ,) spring reference angle
    # --- actuation ------------------------------------------------------
    actuated: np.ndarray      # (NJ,) bool — which joints the policy drives
    torque_limit: np.ndarray  # (NJ,) |tau| cap; action in [-1,1] scales this
    kp: np.ndarray            # (NJ,) PD position gain (used by PD-controlled robots)
    kd: np.ndarray            # (NJ,) PD velocity gain
    # --- contact geometry ----------------------------------------------
    contact_body: np.ndarray    # (NC,) int body index of each contact sphere
    contact_offset: np.ndarray  # (NC, 3) sphere center in body frame
    contact_radius: np.ndarray  # (NC,)
    foot_of_contact: np.ndarray  # (NC,) int: 0=right foot, 1=left foot, -1=other
    # --- metadata -------------------------------------------------------
    joint_names: tuple
    body_names: tuple
    # indices into the *action* vector for each actuated joint, and initial pose
    init_q_joints: np.ndarray  # (NJ,) initial joint angles
    root_height: float         # initial root height above the stance surface
    # (NB, 4) fixed wxyz rotation from parent frame to the joint frame at
    # q=0 — identity for hand-built models; URDF <origin rpy> lands here
    joint_rot: np.ndarray | None = None

    # ------------------------------------------------------------------
    @property
    def nbodies(self) -> int:
        return int(self.parent.shape[0])

    @property
    def njoints(self) -> int:
        return self.nbodies - 1

    @property
    def ndof(self) -> int:
        return 6 + self.njoints

    @property
    def nq(self) -> int:
        return 7 + self.njoints

    @property
    def action_dim(self) -> int:
        return int(self.actuated.sum())

    @property
    def ncontacts(self) -> int:
        return int(self.contact_body.shape[0])

    @property
    def actuated_idx(self) -> np.ndarray:
        return np.nonzero(self.actuated)[0]

    @property
    def total_mass(self) -> float:
        return float(self.mass.sum())

    def ancestors(self, i: int) -> list:
        """Body indices on the path from body i up to (and incl.) the root."""
        out = []
        while i >= 0:
            out.append(i)
            i = int(self.parent[i])
        return out


def _np(x, dtype=np.float32):
    return np.asarray(x, dtype=dtype)


def build_model(
    name: str,
    bodies: Sequence[dict],
    contacts: Sequence[dict],
) -> RobotModel:
    """Assemble a RobotModel from per-body dict specs (see robots/*.py).

    Each body dict (after the root) needs: name, parent (name), anchor,
    axis, mass, com, inertia, and optional joint fields.
    """
    names = [b["name"] for b in bodies]
    index = {n: i for i, n in enumerate(names)}
    nb = len(bodies)
    parent = np.full(nb, -1, dtype=np.int32)
    joint_axis = np.zeros((nb, 3), dtype=np.float32)
    joint_anchor = np.zeros((nb, 3), dtype=np.float32)
    mass = np.zeros(nb, dtype=np.float32)
    com = np.zeros((nb, 3), dtype=np.float32)
    inertia = np.zeros((nb, 3), dtype=np.float32)

    nj = nb - 1
    jl = np.full(nj, -np.inf, dtype=np.float32)
    ju = np.full(nj, np.inf, dtype=np.float32)
    jdamp = np.zeros(nj, dtype=np.float32)
    jstiff = np.zeros(nj, dtype=np.float32)
    jref = np.zeros(nj, dtype=np.float32)
    act = np.zeros(nj, dtype=bool)
    tlim = np.zeros(nj, dtype=np.float32)
    kp = np.zeros(nj, dtype=np.float32)
    kd = np.zeros(nj, dtype=np.float32)
    q0 = np.zeros(nj, dtype=np.float32)
    joint_names = []

    for i, b in enumerate(bodies):
        mass[i] = b["mass"]
        com[i] = _np(b.get("com", (0, 0, 0)))
        inertia[i] = _np(b["inertia"])
        if i == 0:
            assert "parent" not in b, "root must have no parent"
            continue
        p = index[b["parent"]]
        assert p < i, f"bodies must be topologically ordered ({b['name']})"
        parent[i] = p
        ax = _np(b["axis"])
        joint_axis[i] = ax / np.linalg.norm(ax)
        joint_anchor[i] = _np(b["anchor"])
        j = i - 1
        joint_names.append(b.get("joint_name", b["name"]))
        lo, hi = b.get("limits", (-np.pi, np.pi))
        jl[j], ju[j] = lo, hi
        jdamp[j] = b.get("damping", 0.1)
        jstiff[j] = b.get("stiffness", 0.0)
        jref[j] = b.get("spring_ref", 0.0)
        act[j] = b.get("actuated", True)
        tlim[j] = b.get("torque_limit", 100.0)
        kp[j] = b.get("kp", 0.0)
        kd[j] = b.get("kd", 0.0)
        q0[j] = b.get("init_angle", 0.0)

    cb = np.array([index[c["body"]] for c in contacts], dtype=np.int32)
    co = _np([c["offset"] for c in contacts]).reshape(len(contacts), 3)
    cr = _np([c["radius"] for c in contacts])
    cf = np.array([c.get("foot", -1) for c in contacts], dtype=np.int32)

    return RobotModel(
        name=name,
        parent=parent,
        joint_axis=joint_axis,
        joint_anchor=joint_anchor,
        mass=mass,
        com=com,
        inertia=inertia,
        joint_lower=jl,
        joint_upper=ju,
        joint_damping=jdamp,
        joint_stiffness=jstiff,
        joint_spring_ref=jref,
        actuated=act,
        torque_limit=tlim,
        kp=kp,
        kd=kd,
        contact_body=cb,
        contact_offset=co,
        contact_radius=cr,
        foot_of_contact=cf,
        joint_names=tuple(joint_names),
        body_names=tuple(names),
        init_q_joints=q0,
        root_height=float(bodies[0].get("root_height", 1.0)),
    )


_TENSORS: dict = {}


def tensor(model: RobotModel, field: str, device, dtype=None) -> torch.Tensor:
    """Cached torch copy of a numeric model field on `device` (float fields
    as float32, integer/bool fields keep their kind). Keyed by the model's
    identity, so the batched code does not copy host arrays every call."""
    dev = torch.device(device)
    key = (model, field, str(dev), dtype)
    t = _TENSORS.get(key)
    if t is None:
        arr = np.asarray(getattr(model, field))
        if dtype is None and arr.dtype.kind == "f":
            dtype = torch.float32
        t = torch.as_tensor(arr, device=dev, dtype=dtype)
        _TENSORS[key] = t
    return t
