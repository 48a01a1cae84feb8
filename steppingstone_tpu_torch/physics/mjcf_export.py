"""Export a RobotModel to MJCF for cross-validation against MuJoCo (own
copy of steppingstone_tpu/physics/mjcf_export.py).

MuJoCo serves as an independent oracle for the from-scratch engine:
`to_mjcf` emits the same kinematic tree / inertials / actuators, so a
trajectory of this package's engine can be compared with MuJoCo's on the
same model. `mujoco` is imported only by the functions that need it.

MuJoCo conventions handled here:
- free-joint root: qpos = [pos(3), quat wxyz] (same as our convention)
- each RobotModel body -> nested <body pos=anchor> with a <joint
  type="hinge"> at the body origin; joint limits/damping mirrored
- contact spheres -> <geom type="sphere"> with contype/conaffinity set so
  only robot-vs-floor collisions happen (our engine has no self-collision)
- actuators: <motor gear=torque_limit ctrlrange=[-1,1]> per actuated
  joint, identical to our `torque_actuation` scaling
- like the JAX copy, the export ignores `joint_rot` (a URDF model's fixed
  joint rotations): the emitted bodies carry no `quat`
"""

from __future__ import annotations

import numpy as np

from steppingstone_tpu_torch.physics.model import RobotModel


def _fmt(v) -> str:
    return " ".join(f"{float(x):.8g}" for x in np.atleast_1d(v))


def to_mjcf(
    model: RobotModel,
    timestep: float = 1.0 / 240.0,
    with_floor: bool = True,
    friction: float = 0.9,
) -> str:
    """MJCF document for `model`. Bodies keep their RobotModel names."""
    nb = model.nbodies
    children: list[list[int]] = [[] for _ in range(nb)]
    for i in range(1, nb):
        children[int(model.parent[i])].append(i)

    lines: list[str] = []

    def emit_body(i: int, indent: str):
        name = model.body_names[i]
        if i == 0:
            pos = np.array([0.0, 0.0, model.root_height])
        else:
            pos = model.joint_anchor[i]
        lines.append(f'{indent}<body name="{name}" pos="{_fmt(pos)}">')
        if i == 0:
            lines.append(f'{indent}  <freejoint name="root"/>')
        else:
            j = i - 1
            jn = model.joint_names[j]
            rng = f"{model.joint_lower[j]:.8g} {model.joint_upper[j]:.8g}"
            lines.append(
                f'{indent}  <joint name="{jn}" type="hinge" '
                f'axis="{_fmt(model.joint_axis[i])}" pos="0 0 0" '
                f'range="{rng}" damping="{model.joint_damping[j]:.8g}" '
                f'stiffness="{model.joint_stiffness[j]:.8g}" '
                f'springref="{model.joint_spring_ref[j]:.8g}" '
                f'limited="true"/>'
            )
        lines.append(
            f'{indent}  <inertial pos="{_fmt(model.com[i])}" '
            f'mass="{model.mass[i]:.8g}" '
            f'diaginertia="{_fmt(model.inertia[i])}"/>'
        )
        # contact spheres (collision geoms); tiny visual marker otherwise
        any_geom = False
        for c in range(model.ncontacts):
            if int(model.contact_body[c]) == i:
                any_geom = True
                lines.append(
                    f'{indent}  <geom type="sphere" '
                    f'size="{model.contact_radius[c]:.8g}" '
                    f'pos="{_fmt(model.contact_offset[c])}" '
                    f'contype="1" conaffinity="2" friction="{friction} 0 0" '
                    f'mass="0"/>'
                )
        if not any_geom:
            # massless marker so MuJoCo accepts bodies without geoms
            lines.append(
                f'{indent}  <geom type="sphere" size="0.01" '
                f'contype="0" conaffinity="0" mass="0"/>'
            )
        for ch in children[i]:
            emit_body(ch, indent + "  ")
        lines.append(f"{indent}</body>")

    emit_body(0, "    ")
    body_xml = "\n".join(lines)

    motors = "\n".join(
        f'    <motor name="m_{model.joint_names[j]}" '
        f'joint="{model.joint_names[j]}" gear="{model.torque_limit[j]:.8g}" '
        f'ctrlrange="-1 1" ctrllimited="true"/>'
        for j in np.nonzero(model.actuated)[0]
    )
    floor = (
        f'    <geom name="floor" type="plane" size="50 50 1" '
        f'contype="2" conaffinity="1" friction="{friction} 0 0"/>'
        if with_floor else ""
    )
    return f"""<mujoco model="{model.name}">
  <option timestep="{timestep}" gravity="0 0 -9.8" integrator="Euler"/>
  <worldbody>
{floor}
{body_xml}
  </worldbody>
  <actuator>
{motors}
  </actuator>
</mujoco>
"""


def make_mj_model(model: RobotModel, **kw):
    """Compiled mujoco.MjModel (requires the mujoco package)."""
    import mujoco

    return mujoco.MjModel.from_xml_string(to_mjcf(model, **kw))


def set_state(mj_model, mj_data, q: np.ndarray, qd: np.ndarray | None = None):
    """Write our (q, qd) into MjData.

    Our layout: q = [pos(3), quat wxyz(4), joints], qd = [omega_world(3),
    v_origin_world(3), joint_vels]. MuJoCo free joint: qpos likewise;
    qvel = [v_origin_world(3), omega_BODY(3)] (linear first, angular in the
    child body frame).
    """
    import mujoco

    q = np.asarray(q, np.float64)
    mj_data.qpos[:3] = q[:3]
    mj_data.qpos[3:7] = q[3:7]
    mj_data.qpos[7:] = q[7:]
    if qd is not None:
        qd = np.asarray(qd, np.float64)
        w, x, y, z = q[3:7]
        R = _quat_to_mat(w, x, y, z)
        mj_data.qvel[0:3] = qd[3:6]
        mj_data.qvel[3:6] = R.T @ qd[0:3]  # world omega -> body frame
        mj_data.qvel[6:] = qd[6:]
    mujoco.mj_forward(mj_model, mj_data)


def get_state(mj_data) -> tuple[np.ndarray, np.ndarray]:
    """Read MjData back into our (q, qd) layout."""
    q = np.asarray(mj_data.qpos, np.float64).copy()
    qv = np.asarray(mj_data.qvel, np.float64)
    w, x, y, z = q[3:7]
    R = _quat_to_mat(w, x, y, z)
    omega_world = R @ qv[3:6]
    qd = np.concatenate([omega_world, qv[0:3], qv[6:]])
    return q, qd


def _quat_to_mat(w, x, y, z):
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
