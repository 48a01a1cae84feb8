"""Walker3D and Mike humanoid morphologies (own copy of
steppingstone_tpu/physics/robots/walker3d.py).

21 actuated DoF in the exact action order of the reference's HUD labels
(reference `common/render_utils.py:47-69`): abdomen z/y/x, right hip x/z/y,
right knee, right ankle, left hip x/z/y, left knee, left ankle, right
shoulder x/z/y, right elbow, left shoulder x/z/y, left elbow. Obs/action
dims (60/21) are pinned by the reference checkpoints (SURVEY.md §2.8).

The floating root is the TORSO (chest) link, standing at z ~ 1.32 — the
`mocca_envs` Walker3D convention (its `base_position` z and the stepper's
`robot_init_position`); the abdomen chain hangs the pelvis + legs below it
and the shoulders attach to the torso directly. Per-joint torque caps are
the mocca `power_coef` table (action in [-1,1] scales them directly).

Sign conventions (y-axis hinges): knee bent = negative, hip flexion
(thigh forward) = negative — matching the mocca "running_start" pose that
sets right hip_y / knee to -pi/8.

3-DoF joints (abdomen, hips, shoulders) are chains of single-axis revolute
joints through two low-mass intermediate links, ordered so that
joint index == action index.

Frame convention: x forward, y left, z up; right side of the body is -y.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from .model import RobotModel, build_model

# mirror metadata in *joint index* space (== action index space here):
# joints rotating about x or z flip sign under the y -> -y reflection.
MIRROR = {
    "neg_joints": [0, 2, 3, 4, 8, 9, 13, 14, 17, 18],
    "right_joints": [3, 4, 5, 6, 7, 13, 14, 15, 16],
    "left_joints": [8, 9, 10, 11, 12, 17, 18, 19, 20],
}

# mocca power_coef (N*m torque caps per actuated joint, action order)
TORQUES = {
    "abdomen_z": 60.0, "abdomen_y": 80.0, "abdomen_x": 60.0,
    "hip_x": 80.0, "hip_z": 60.0, "hip_y": 100.0,
    "knee": 90.0, "ankle": 60.0,
    "shoulder_x": 60.0, "shoulder_z": 60.0, "shoulder_y": 50.0,
    "elbow": 60.0,
}


def _leg(side: str, sign: float, mass_scale: float, len_scale: float):
    s = len_scale
    # thigh hangs from the pelvis; knee 0.403 below the hip; ankle 0.39
    # below the knee; foot sole ~0.06 below the ankle
    hip_anchor = (0.0, sign * 0.10 * s, -0.04 * s)
    return [
        dict(name=f"{side}_hip_x", parent="pelvis", anchor=hip_anchor,
             axis=(1, 0, 0), mass=0.5 * mass_scale, inertia=(0.004, 0.004, 0.004),
             limits=(-0.7, 0.7), torque_limit=TORQUES["hip_x"], damping=1.0),
        dict(name=f"{side}_hip_z", parent=f"{side}_hip_x", anchor=(0, 0, 0),
             axis=(0, 0, 1), mass=0.5 * mass_scale, inertia=(0.004, 0.004, 0.004),
             limits=(-1.05, 1.05), torque_limit=TORQUES["hip_z"], damping=1.0),
        # hip_y: thigh forward (flexion) = negative angle
        dict(name=f"{side}_thigh", parent=f"{side}_hip_z", anchor=(0, 0, 0),
             joint_name=f"{side}_hip_y", axis=(0, 1, 0),
             mass=4.5 * mass_scale, com=(0, 0, -0.20 * s),
             inertia=(0.07, 0.07, 0.02),
             limits=(-1.92, 0.35), torque_limit=TORQUES["hip_y"], damping=1.0,
             init_angle=0.0),
        # knee: bent = negative angle (axis flipped vs the bare +y hinge)
        dict(name=f"{side}_shin", parent=f"{side}_thigh", anchor=(0, 0, -0.403 * s),
             joint_name=f"{side}_knee", axis=(0, -1, 0),
             mass=2.7 * mass_scale, com=(0, 0, -0.19 * s),
             inertia=(0.04, 0.04, 0.007),
             limits=(-2.62, -0.02), torque_limit=TORQUES["knee"], damping=1.0,
             init_angle=-0.2),
        dict(name=f"{side}_foot", parent=f"{side}_shin", anchor=(0, 0, -0.39 * s),
             joint_name=f"{side}_ankle", axis=(0, 1, 0),
             mass=1.2 * mass_scale, com=(0.04 * s, 0, -0.03 * s),
             inertia=(0.004, 0.012, 0.012),
             limits=(-0.87, 0.87), torque_limit=TORQUES["ankle"], damping=1.0,
             init_angle=0.0),
    ]


def _arm(side: str, sign: float, mass_scale: float, len_scale: float):
    s = len_scale
    return [
        dict(name=f"{side}_shoulder_x", parent="torso",
             anchor=(0.0, sign * 0.17 * s, 0.06 * s),
             axis=(1, 0, 0), mass=0.3 * mass_scale, inertia=(0.004, 0.004, 0.004),
             limits=(-1.48, 1.48), torque_limit=TORQUES["shoulder_x"], damping=1.5),
        dict(name=f"{side}_shoulder_z", parent=f"{side}_shoulder_x", anchor=(0, 0, 0),
             axis=(0, 0, 1), mass=0.3 * mass_scale, inertia=(0.004, 0.004, 0.004),
             limits=(-1.48, 1.48), torque_limit=TORQUES["shoulder_z"], damping=1.5),
        dict(name=f"{side}_upper_arm", parent=f"{side}_shoulder_z", anchor=(0, 0, 0),
             joint_name=f"{side}_shoulder_y", axis=(0, 1, 0),
             mass=1.6 * mass_scale, com=(0, 0, -0.14 * s),
             inertia=(0.011, 0.011, 0.008),
             limits=(-2.0, 1.0), torque_limit=TORQUES["shoulder_y"], damping=1.5),
        # elbow: bent (hand forward) = negative
        dict(name=f"{side}_forearm", parent=f"{side}_upper_arm",
             anchor=(0, 0, -0.28 * s),
             joint_name=f"{side}_elbow", axis=(0, 1, 0),
             mass=1.2 * mass_scale, com=(0, 0, -0.12 * s),
             inertia=(0.007, 0.007, 0.004),
             limits=(-1.57, 0.87), torque_limit=TORQUES["elbow"], damping=1.5,
             init_angle=-0.3),
    ]


def _humanoid(name: str, mass_scale: float, len_scale: float) -> RobotModel:
    s = len_scale
    # Standing stack (root = torso): torso 1.32 -> waist (abdomen z/y)
    # -0.26 -> pelvis (abdomen x) -0.165 -> hip -0.04 -> knee -0.403
    # -> ankle -0.39 -> sole ~ -0.06. Root height 1.32 * len_scale.
    bodies = [
        dict(name="torso", mass=17.0 * mass_scale, com=(0, 0, 0.09 * s),
             inertia=(0.55, 0.48, 0.26), root_height=1.32 * s),
        dict(name="waist", parent="torso", anchor=(0, 0, -0.26 * s),
             joint_name="abdomen_z", axis=(0, 0, 1),
             mass=1.2 * mass_scale, inertia=(0.01, 0.01, 0.01),
             limits=(-0.79, 0.79), torque_limit=TORQUES["abdomen_z"], damping=2.0),
        dict(name="waist2", parent="waist", anchor=(0, 0, 0),
             joint_name="abdomen_y", axis=(0, 1, 0),
             mass=1.3 * mass_scale, inertia=(0.01, 0.01, 0.01),
             limits=(-0.52, 1.31), torque_limit=TORQUES["abdomen_y"], damping=2.0),
        dict(name="pelvis", parent="waist2", anchor=(0, 0, -0.165 * s),
             joint_name="abdomen_x", axis=(1, 0, 0),
             mass=6.5 * mass_scale, com=(0, 0, 0.02 * s),
             inertia=(0.055, 0.065, 0.05),
             limits=(-0.61, 0.61), torque_limit=TORQUES["abdomen_x"], damping=2.0),
        *_leg("right", -1.0, mass_scale, len_scale),
        *_leg("left", +1.0, mass_scale, len_scale),
        *_arm("right", -1.0, mass_scale, len_scale),
        *_arm("left", +1.0, mass_scale, len_scale),
    ]
    contacts = [
        # 3 spheres per foot (heel + two toe corners): a support triangle,
        # so single-foot stance resists roll like a real foot sole
        dict(body="right_foot", offset=(-0.07 * s, 0, -0.035 * s), radius=0.028, foot=0),
        dict(body="right_foot", offset=(0.13 * s, 0.04 * s, -0.035 * s), radius=0.028, foot=0),
        dict(body="right_foot", offset=(0.13 * s, -0.04 * s, -0.035 * s), radius=0.028, foot=0),
        dict(body="left_foot", offset=(-0.07 * s, 0, -0.035 * s), radius=0.028, foot=1),
        dict(body="left_foot", offset=(0.13 * s, 0.04 * s, -0.035 * s), radius=0.028, foot=1),
        dict(body="left_foot", offset=(0.13 * s, -0.04 * s, -0.035 * s), radius=0.028, foot=1),
        # body spheres: keep fallen characters from sinking through terrain
        dict(body="pelvis", offset=(0, 0, 0), radius=0.12),
        dict(body="torso", offset=(0, 0, 0.09 * s), radius=0.14),
        dict(body="right_shin", offset=(0, 0, -0.19 * s), radius=0.05),
        dict(body="left_shin", offset=(0, 0, -0.19 * s), radius=0.05),
        dict(body="right_forearm", offset=(0, 0, -0.24 * s), radius=0.04),
        dict(body="left_forearm", offset=(0, 0, -0.24 * s), radius=0.04),
    ]
    return build_model(name, bodies, contacts)


# mocca "running_start" pose: right hip_y / knee at -pi/8, arms relaxed
RUNNING_START = {
    "right_hip_y": -np.pi / 8,
    "right_knee": -np.pi / 8,
    "right_shoulder_x": -np.pi / 10,
    "left_shoulder_x": np.pi / 10,
}


@lru_cache(maxsize=None)
def walker3d() -> RobotModel:
    m = _humanoid("walker3d", mass_scale=1.0, len_scale=1.0)
    _check(m)
    return m


@lru_cache(maxsize=None)
def mike() -> RobotModel:
    """Mike: Walker3D's skeleton, 1.45x the mass and 1.04x the length.
    Torque caps scale with the mass (Walker3D's strength-to-weight), and
    the link inertias by 1.45 * 1.04^2, which `_humanoid` leaves at
    Walker3D's constants."""
    m = _humanoid("mike", mass_scale=1.45, len_scale=1.04)
    m = dataclasses.replace(m, torque_limit=m.torque_limit * 1.45,
                            inertia=m.inertia * (1.45 * 1.04 ** 2))
    _check(m)
    return m


def _check(m: RobotModel):
    assert m.njoints == 21 and m.action_dim == 21, (m.njoints, m.action_dim)
    expected = [
        "abdomen_z", "abdomen_y", "abdomen_x",
        "right_hip_x", "right_hip_z", "right_hip_y", "right_knee", "right_ankle",
        "left_hip_x", "left_hip_z", "left_hip_y", "left_knee", "left_ankle",
        "right_shoulder_x", "right_shoulder_z", "right_shoulder_y", "right_elbow",
        "left_shoulder_x", "left_shoulder_z", "left_shoulder_y", "left_elbow",
    ]
    assert list(m.joint_names) == expected, m.joint_names
    assert np.all(m.actuated)
