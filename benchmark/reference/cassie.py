"""Cassie biped morphology (own copy of
steppingstone_tpu/physics/robots/cassie.py).

10 actuated DoF (hip roll/yaw/pitch, knee, toe per leg) + 4 passive
spring joints (shin, tarsus per leg), matching the reference checkpoint's
51-obs / 10-act contract (SURVEY.md §2.8), PD-controlled (kp/kd per
actuated joint; the stepper runs stable PD inside each substep).

Action order: [r_hip_roll, r_hip_yaw, r_hip_pitch, r_knee, r_toe,
               l_hip_roll, l_hip_yaw, l_hip_pitch, l_knee, l_toe]
(= ascending order of actuated joint indices).

The real Cassie leg is a closed-loop four-bar linkage; this model uses the
standard serial-chain approximation (thigh -> knee/shin w/ spring ->
tarsus w/ spring -> toe).
"""

from __future__ import annotations

from functools import lru_cache

from .model import RobotModel, build_model

# joint-index-space mirror metadata (x/z-axis joints negate under y-mirror)
MIRROR = {
    "neg_joints": [0, 1, 7, 8],        # hip_roll (x), hip_yaw (z), both legs
    "right_joints": [0, 1, 2, 3, 4, 5, 6],
    "left_joints": [7, 8, 9, 10, 11, 12, 13],
}

# action-index-space mirror (negate roll/yaw, swap leg blocks)
MIRROR_ACTION = {
    "neg_actions": [0, 1, 5, 6],
    "right_actions": [0, 1, 2, 3, 4],
    "left_actions": [5, 6, 7, 8, 9],
}


def _leg(side: str, sign: float):
    return [
        dict(name=f"{side}_hip_roll", parent="pelvis",
             anchor=(0.021, sign * 0.135, -0.01),
             axis=(1, 0, 0), mass=1.8, inertia=(0.005, 0.005, 0.005),
             limits=(-0.26, 0.39) if sign < 0 else (-0.39, 0.26),
             torque_limit=112.0, damping=1.0, kp=100.0, kd=10.0),
        dict(name=f"{side}_hip_yaw", parent=f"{side}_hip_roll", anchor=(0, 0, -0.07),
             axis=(0, 0, 1), mass=1.2, inertia=(0.004, 0.004, 0.004),
             limits=(-0.38, 0.38), torque_limit=112.0, damping=1.0,
             kp=100.0, kd=10.0),
        dict(name=f"{side}_thigh", parent=f"{side}_hip_yaw", anchor=(0, 0, -0.09),
             joint_name=f"{side}_hip_pitch", axis=(0, 1, 0),
             mass=5.5, com=(0.06, 0, -0.12), inertia=(0.03, 0.03, 0.02),
             limits=(-0.87, 1.4), torque_limit=195.0, damping=1.0,
             kp=88.0, kd=8.0, init_angle=0.8),
        dict(name=f"{side}_shin", parent=f"{side}_thigh", anchor=(0.06, 0, -0.25),
             joint_name=f"{side}_knee", axis=(0, 1, 0),
             mass=0.9, com=(0.1, 0, -0.15), inertia=(0.01, 0.01, 0.005),
             limits=(-2.86, -0.64), torque_limit=195.0, damping=1.0,
             kp=96.0, kd=9.6, init_angle=-0.9),
        # spring joints: damping near critical for the effective inertia
        # of the downstream subtree (~0.14 kg m^2 at this lever),
        # c_crit = 2 sqrt(k I_eff) ~ 29; lighter damping rings the robot
        # off its feet within ~10 control steps
        dict(name=f"{side}_knee_spring", parent=f"{side}_shin", anchor=(0.08, 0, -0.15),
             joint_name=f"{side}_shin_spring", axis=(0, 1, 0),
             mass=0.6, com=(0.1, 0, -0.1), inertia=(0.005, 0.005, 0.002),
             limits=(-0.3, 0.3), actuated=False, damping=25.0,
             stiffness=1500.0, spring_ref=0.0),
        dict(name=f"{side}_tarsus", parent=f"{side}_knee_spring", anchor=(0.1, 0, -0.12),
             joint_name=f"{side}_tarsus", axis=(0, 1, 0),
             mass=0.8, com=(0.08, 0, -0.12), inertia=(0.008, 0.008, 0.003),
             limits=(0.5, 1.6), actuated=False, damping=25.0,
             stiffness=1200.0, spring_ref=0.85, init_angle=0.85),
        dict(name=f"{side}_toe", parent=f"{side}_tarsus", anchor=(0.11, 0, -0.28),
             joint_name=f"{side}_toe", axis=(0, 1, 0),
             mass=0.15, com=(0.04, 0, -0.01), inertia=(0.0005, 0.0008, 0.0008),
             limits=(-2.4, -0.6), torque_limit=45.0, damping=0.5,
             kp=50.0, kd=5.0, init_angle=-0.75),
    ]


@lru_cache(maxsize=None)
def cassie() -> RobotModel:
    bodies = [
        dict(name="pelvis", mass=10.3, com=(0.02, 0, 0.02),
             inertia=(0.08, 0.08, 0.09), root_height=0.96),
        *_leg("right", -1.0),
        *_leg("left", +1.0),
    ]
    contacts = [
        dict(body="right_toe", offset=(-0.03, 0, -0.02), radius=0.03, foot=0),
        dict(body="right_toe", offset=(0.09, 0, -0.02), radius=0.03, foot=0),
        dict(body="left_toe", offset=(-0.03, 0, -0.02), radius=0.03, foot=1),
        dict(body="left_toe", offset=(0.09, 0, -0.02), radius=0.03, foot=1),
        # pelvis sphere keeps a fallen robot from sinking through terrain
        dict(body="pelvis", offset=(0, 0, 0), radius=0.13),
    ]
    m = build_model("cassie", bodies, contacts)
    if m.njoints != 14 or m.action_dim != 10:
        raise ValueError(f"cassie: {m.njoints} joints / {m.action_dim} actions, expected 14 / 10")
    return m
