"""URDF -> RobotModel, via the native C++ parser native/urdf_loader.cpp
(own copy of steppingstone_tpu/physics/urdf.py).

The C++ library parses the XML; this wrapper orders the kinematic tree,
merges fixed joints (lumped inertia via the parallel-axis theorem),
converts URDF inertial conventions to the engine's (diagonal inertia about
the CoM: off-diagonal products are dropped with a warning), and emits a
RobotModel whose `joint_rot` holds each joint's fixed `<origin rpy>`
rotation (kernel K4 on the card).

The library is built at first use with the host C++ compiler (`CXX`, else
g++ or c++) into this package's `build/` directory (listed in
.gitignore), under a name hashed from the source and the flags, and moved
into place atomically; a failed build raises with the compiler's output.

Limitations: revolute/continuous/fixed joints only (no prismatic or
floating: the root is always a free joint); only sphere collision geoms
become contact points.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import warnings
from pathlib import Path

import numpy as np

from steppingstone_tpu_torch.physics.model import RobotModel

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR.parent / "native" / "urdf_loader.cpp"
BUILD_DIR = PACKAGE_DIR / "build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (set CXX): needed to build the URDF parser")
    return cxx


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"liburdf_loader_{digest.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, path)  # atomic: concurrent builds agree
    except subprocess.CalledProcessError as err:
        raise RuntimeError(f"building {SOURCE} failed:\n{err.stderr}") from err
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    vp, cp, i, dp = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_double)
    for name, restype, argtypes in (
        ("urdf_load", vp, [cp]),
        ("urdf_free", None, [vp]),
        ("urdf_error", i, [vp, cp, i]),
        ("urdf_name", None, [vp, cp, i]),
        ("urdf_num_links", i, [vp]),
        ("urdf_num_joints", i, [vp]),
        ("urdf_link", None, [vp, i, cp, i, dp]),
        ("urdf_link_num_spheres", i, [vp, i]),
        ("urdf_link_sphere", None, [vp, i, i, dp]),
        ("urdf_joint", None, [vp, i, cp, i, cp, i, cp, i, cp, i, dp]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _lib = lib
    return lib


def _rpy_to_quat(rpy):
    roll, pitch, yaw = rpy
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    return np.array([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ])


def _quat_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def parse_urdf(xml: str) -> dict:
    """Parse URDF XML via the native library into plain dicts."""
    lib = _load_lib()
    h = lib.urdf_load(xml.encode())
    try:
        err = ctypes.create_string_buffer(512)
        if lib.urdf_error(h, err, 512):
            raise ValueError(f"URDF parse error: {err.value.decode()}")
        name_buf = ctypes.create_string_buffer(256)

        links = {}
        link_order = []
        for i in range(lib.urdf_num_links(h)):
            rec = (ctypes.c_double * 13)()
            lib.urdf_link(h, i, name_buf, 256, rec)
            nm = name_buf.value.decode()
            spheres = []
            for s in range(lib.urdf_link_num_spheres(h, i)):
                sp = (ctypes.c_double * 4)()
                lib.urdf_link_sphere(h, i, s, sp)
                spheres.append(list(sp))
            links[nm] = dict(
                mass=rec[0], com=list(rec[1:4]), com_rpy=list(rec[4:7]),
                inertia=list(rec[7:13]), spheres=spheres,
            )
            link_order.append(nm)

        joints = []
        tbuf = ctypes.create_string_buffer(64)
        pbuf = ctypes.create_string_buffer(256)
        cbuf = ctypes.create_string_buffer(256)
        for i in range(lib.urdf_num_joints(h)):
            rec = (ctypes.c_double * 13)()
            lib.urdf_joint(h, i, name_buf, 256, tbuf, 64, pbuf, 256, cbuf, 256, rec)
            joints.append(dict(
                name=name_buf.value.decode(), type=tbuf.value.decode(),
                parent=pbuf.value.decode(), child=cbuf.value.decode(),
                xyz=list(rec[0:3]), rpy=list(rec[3:6]), axis=list(rec[6:9]),
                lower=rec[9], upper=rec[10], effort=rec[11], damping=rec[12],
            ))
        lib.urdf_name(h, name_buf, 256)
        return dict(name=name_buf.value.decode(), links=links, link_order=link_order,
                    joints=joints)
    finally:
        lib.urdf_free(h)


def load_urdf(
    path_or_xml: str,
    root_height: float = 1.0,
    torque_limit_scale: float = 1.0,
    kp: float = 0.0,
    kd: float = 0.0,
) -> RobotModel:
    """Load a URDF file (or raw XML string) into a RobotModel."""
    if os.path.exists(path_or_xml):
        with open(path_or_xml) as f:
            xml = f.read()
    else:
        xml = path_or_xml
    raw = parse_urdf(xml)
    links, joints = raw["links"], raw["joints"]

    # root link = the one that is never a child
    children = {j["child"] for j in joints}
    roots = [n for n in raw["link_order"] if n not in children]
    if len(roots) != 1:
        raise ValueError(f"expected exactly one root link, got {roots}")
    root = roots[0]

    by_parent: dict = {}
    for j in joints:
        by_parent.setdefault(j["parent"], []).append(j)

    # Depth-first walk; fixed joints merge the child into the current
    # moving body (lumped mass + parallel-axis inertia, diagonal approx).
    bodies = []      # list of dicts accumulating RobotModel rows

    def lump(into: dict, link: dict, offset, rot_q):
        """Merge `link`'s inertial + spheres into body dict `into`,
        positioned at (offset, rot) in that body's frame."""
        m2 = link["mass"]
        if m2 <= 0 and not link["spheres"]:
            return
        R = _quat_mat(rot_q)
        com2 = np.asarray(offset) + R @ np.asarray(link["com"])
        m1 = into["mass"]
        com1 = np.asarray(into["com"])
        m = m1 + m2
        com = (m1 * com1 + m2 * com2) / m if m > 0 else com1
        ixx, iyy, izz, ixy, ixz, iyz = link["inertia"]
        if abs(ixy) + abs(ixz) + abs(iyz) > 1e-8:
            warnings.warn("URDF link has inertia products; dropping off-diagonals")
        I2 = R @ np.diag([ixx, iyy, izz]) @ R.T
        d2 = com2 - com
        d1 = com1 - com
        I_new = (
            np.diag(np.asarray(into["inertia"]))
            + m1 * (np.dot(d1, d1) * np.eye(3) - np.outer(d1, d1))
            + I2
            + m2 * (np.dot(d2, d2) * np.eye(3) - np.outer(d2, d2))
        )
        into["mass"] = m
        into["com"] = list(com)
        into["inertia"] = list(np.clip(np.diag(I_new), 1e-6, None))
        for sp in link["spheres"]:
            p = np.asarray(offset) + R @ np.asarray(sp[:3])
            into["spheres"].append([p[0], p[1], p[2], sp[3]])

    def new_body(name, link, parent_idx, joint=None):
        b = dict(name=name, mass=0.0, com=[0, 0, 0], inertia=[0, 0, 0], spheres=[],
                 parent=parent_idx, joint=joint)
        lump(b, link, np.zeros(3), np.array([1.0, 0, 0, 0]))
        bodies.append(b)
        return len(bodies) - 1

    def walk(link_name, body_idx, offset, rot_q):
        """Attach link_name's child joints; (offset, rot) locate link_name's
        frame within body `body_idx` (non-trivial after fixed-joint merges)."""
        for j in by_parent.get(link_name, []):
            child = j["child"]
            j_off = np.asarray(offset) + _quat_mat(rot_q) @ np.asarray(j["xyz"])
            j_rot = _quat_mul(rot_q, _rpy_to_quat(j["rpy"]))
            if j["type"] == "fixed":
                lump(bodies[body_idx], links[child], j_off, j_rot)
                walk(child, body_idx, j_off, j_rot)
            elif j["type"] in ("revolute", "continuous"):
                idx = new_body(child, links[child], body_idx,
                               joint=dict(j, anchor=list(j_off), rot=list(j_rot)))
                walk(child, idx, np.zeros(3), np.array([1.0, 0, 0, 0]))
            else:
                raise ValueError(f"unsupported joint type {j['type']!r} ({j['name']})")

    new_body(root, links[root], -1)
    walk(root, 0, np.zeros(3), np.array([1.0, 0, 0, 0]))

    nj = len(bodies) - 1
    moving = bodies[1:]
    spheres = [(i, b["name"], sp) for i, b in enumerate(bodies) for sp in b["spheres"]]

    def foot(name):
        # 0 = right foot, 1 = left foot, -1 = not a foot
        if "foot" not in name and "toe" not in name:
            return -1
        return 0 if "right" in name else 1 if "left" in name else -1

    return RobotModel(
        name=raw["name"],
        parent=np.array([b["parent"] for b in bodies], np.int32),
        joint_axis=np.array([[0, 0, 1]] + [b["joint"]["axis"] for b in moving], np.float32),
        joint_anchor=np.array([[0, 0, 0]] + [b["joint"]["anchor"] for b in moving], np.float32),
        joint_rot=np.array([[1, 0, 0, 0]] + [b["joint"]["rot"] for b in moving], np.float32),
        mass=np.array([max(b["mass"], 1e-4) for b in bodies], np.float32),
        com=np.array([b["com"] for b in bodies], np.float32),
        inertia=np.array([np.clip(b["inertia"], 1e-5, None) for b in bodies], np.float32),
        joint_lower=np.array([b["joint"]["lower"] for b in moving], np.float32),
        joint_upper=np.array([b["joint"]["upper"] for b in moving], np.float32),
        joint_damping=np.array([b["joint"]["damping"] for b in moving], np.float32),
        joint_stiffness=np.zeros(nj, np.float32),
        joint_spring_ref=np.zeros(nj, np.float32),
        actuated=np.ones(nj, bool),
        torque_limit=np.array([b["joint"]["effort"] * torque_limit_scale for b in moving],
                              np.float32),
        kp=np.full(nj, kp, np.float32),
        kd=np.full(nj, kd, np.float32),
        contact_body=np.array([i for i, _, _ in spheres], np.int32),
        contact_offset=np.array([sp[:3] for _, _, sp in spheres], np.float32).reshape(-1, 3),
        contact_radius=np.array([sp[3] for _, _, sp in spheres], np.float32),
        foot_of_contact=np.array([foot(name) for _, name, _ in spheres], np.int32),
        joint_names=tuple(b["name"] for b in moving),
        body_names=tuple(b["name"] for b in bodies),
        init_q_joints=np.array([np.clip(0.0, b["joint"]["lower"], b["joint"]["upper"])
                                for b in moving], np.float32),
        root_height=root_height,
    )
