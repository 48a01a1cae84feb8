"""Port parity, the K4 path: rotated joint frames and URDF robots.

steppingstone_tpu_torch's rotated-frame kinematics and control step
against the JAX package's jnp path (Walker3D and Cassie with fixed joint
rotations drawn from a seed, in the four actuation and support
combinations) and against the Pallas kernel in interpret mode on the
rotated pendulum of tests/test_pallas_step.py; its own `parse_urdf` /
`load_urdf` copy against the JAX one (every RobotModel field exactly
equal, the same warnings), a URDF robot stepped 60 times against the JAX
scan, and `to_mjcf` strings against the JAX exporter's.

Tolerances: kinematics agree to fp32 rounding (1e-5); control steps use
the kernel parity bars of tests/test_pallas_step.py (q 2e-4, qd 2e-3/2e-2,
diagnostics agreement). The rotated Walker3D and Cassie steps compare one
substep: the rotations enter every substep's forward kinematics alike, and
XLA's CPU compile of a rotated model's step grows by ~25 s a substep; one
case, Cassie PD on planks at 2 envs, runs the default 4 substeps, so that
joint limits and contacts interact across substeps in rotated frames. The
60-step URDF run is not teacher forced through the landing on its contact
spheres, so it is held to 1e-3."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_physics import _check_step, _inputs, _pd_draws, _pendulum, _t
from test_urdf import URDF as TESTBOT
from torch_jax_draws import jax_step_per_env

from steppingstone_tpu.physics import contact as jct
from steppingstone_tpu.physics import dynamics as jdyn
from steppingstone_tpu.physics import engine as jeng
from steppingstone_tpu.physics import kinematics as jkin
from steppingstone_tpu.physics import mjcf_export as jmjcf
from steppingstone_tpu.physics import pallas_step
from steppingstone_tpu.physics import urdf as jurdf
from steppingstone_tpu.physics.model import build_model as jbuild
from steppingstone_tpu.physics.robots.cassie import cassie as jcassie
from steppingstone_tpu.physics.robots.walker3d import walker3d as jwalker3d
from steppingstone_tpu_torch.physics import engine as teng
from steppingstone_tpu_torch.physics import kinematics as tkin
from steppingstone_tpu_torch.physics import mjcf_export as tmjcf
from steppingstone_tpu_torch.physics import urdf as turdf
from steppingstone_tpu_torch.physics.model import build_model as tbuild
from steppingstone_tpu_torch.physics.model import with_rotated_frames
from steppingstone_tpu_torch.physics.robots.cassie import cassie as tcassie
from steppingstone_tpu_torch.physics.robots.walker3d import walker3d as twalker3d

# rpy on several joints, a chain of fixed joints with rotated offsets, a
# continuous joint, a link with inertia products, feet on both sides
ROTBOT = """<?xml version="1.0"?>
<robot name="rotbot">
  <link name="pelvis">
    <inertial><mass value="4.0"/><origin xyz="0 0 0.05"/>
      <inertia ixx="0.04" iyy="0.05" izz="0.03" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 0"/><geometry><sphere radius="0.08"/></geometry></collision>
  </link>
  <link name="torso">
    <inertial><mass value="3.0"/><origin xyz="0 0 0.2"/>
      <inertia ixx="0.04" iyy="0.05" izz="0.03" ixy="0.002" ixz="0" iyz="0.001"/></inertial>
  </link>
  <joint name="waist" type="revolute">
    <parent link="pelvis"/><child link="torso"/>
    <origin xyz="0 0 0.15" rpy="0 0.1 0.2"/><axis xyz="0 0 1"/>
    <limit lower="-1.0" upper="1.0" effort="50"/><dynamics damping="0.3"/>
  </joint>
  <link name="mount">
    <inertial><mass value="0.2"/><origin xyz="0.01 0 0"/>
      <inertia ixx="0.001" iyy="0.001" izz="0.001" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <joint name="mount_fix" type="fixed">
    <parent link="torso"/><child link="mount"/><origin xyz="0 0.05 0.3" rpy="0.3 0 0"/>
  </joint>
  <link name="sensor">
    <inertial><mass value="0.1"/><origin xyz="0 0 0.01"/>
      <inertia ixx="0.0005" iyy="0.0005" izz="0.0005" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 0.02"/><geometry><sphere radius="0.03"/></geometry></collision>
  </link>
  <joint name="sensor_fix" type="fixed">
    <parent link="mount"/><child link="sensor"/><origin xyz="0.02 0 0.04" rpy="0 0.4 0.1"/>
  </joint>
  <link name="left_thigh">
    <inertial><mass value="1.5"/><origin xyz="0 0 -0.2"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.005" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <joint name="left_hip" type="revolute">
    <parent link="pelvis"/><child link="left_thigh"/>
    <origin xyz="0 0.1 -0.05" rpy="0.15 0 0"/><axis xyz="1 0 0"/>
    <limit lower="-1.2" upper="1.2" effort="90"/><dynamics damping="0.5"/>
  </joint>
  <link name="left_foot">
    <inertial><mass value="0.8"/><origin xyz="0 0 -0.15"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.002" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 -0.35"/><geometry><sphere radius="0.04"/></geometry></collision>
  </link>
  <joint name="left_knee" type="continuous">
    <parent link="left_thigh"/><child link="left_foot"/>
    <origin xyz="0 0 -0.4" rpy="0 -0.2 0.05"/><axis xyz="0 1 0"/>
    <limit lower="-2.0" upper="0.2" effort="60"/>
  </joint>
  <link name="right_thigh">
    <inertial><mass value="1.5"/><origin xyz="0 0 -0.2"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.005" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <joint name="right_hip" type="revolute">
    <parent link="pelvis"/><child link="right_thigh"/>
    <origin xyz="0 -0.1 -0.05" rpy="-0.15 0 0"/><axis xyz="1 0 0"/>
    <limit lower="-1.2" upper="1.2" effort="90"/>
  </joint>
  <link name="right_toe">
    <inertial><mass value="0.3"/><origin xyz="0.05 0 0"/>
      <inertia ixx="0.001" iyy="0.001" izz="0.001" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0.08 0 0"/><geometry><sphere radius="0.03"/></geometry></collision>
  </link>
  <joint name="right_ankle" type="revolute">
    <parent link="right_thigh"/><child link="right_toe"/>
    <origin xyz="0 0 -0.75" rpy="0 0.3 0"/><axis xyz="0 1 0"/>
    <limit lower="-0.8" upper="0.8" effort="40"/>
  </joint>
</robot>
"""
XMLS = {"testbot": TESTBOT, "rotbot": ROTBOT}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rotated(jmodel, tmodel, seed=3):
    t = with_rotated_frames(tmodel, seed)
    return dataclasses.replace(jmodel, joint_rot=t.joint_rot), t


@pytest.mark.parametrize("robot", ["walker3d", "cassie"])
def test_rotated_kinematics_match_jax(robot):
    """Forward kinematics of a robot with rotated joint frames against the
    JAX package's: every field of Kin (the rotations enter nowhere else;
    body velocities and contact points are functions of Kin, held to JAX
    on the unrotated robots in tests/test_torch_physics.py)."""
    mj, mt = _rotated(*((jwalker3d(), twalker3d()) if robot == "walker3d"
                        else (jcassie(), tcassie())))
    q, *_ = _inputs(np.random.default_rng(1), mj, b=6)
    kj = jax.jit(jax.vmap(lambda x: jkin.forward_kinematics(mj, x)))(q)
    kt = tkin.forward_kinematics(mt, torch.as_tensor(q))
    for f in kj._fields:
        np.testing.assert_allclose(getattr(kt, f).numpy(), np.asarray(getattr(kj, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    # the rotations matter: the unrotated model puts the bodies elsewhere
    plain = tkin.forward_kinematics(twalker3d() if robot == "walker3d" else tcassie(),
                                    torch.as_tensor(q))
    assert (plain.pos - kt.pos).abs().max() > 1e-2


@pytest.mark.parametrize("case", ["walker_plank", "cassie_pd_disc", "cassie_pd_plank",
                                  "cassie_pd_plank_4_substeps"])
def test_rotated_engine_step_matches_jax_step_scan(case):
    """engine.step (the plain version on the CPU) in the rotated-frame
    variants K2+K4 (Walker3D torques on planks of half-width 1.5), K3+K4
    (Cassie PD on discs) and K2+K3+K4 (Cassie PD on planks; one substep at
    4 envs, and the default 4 substeps at 2 envs) against the JAX jnp path;
    K4 itself (Walker3D torques on discs) is tests/test_torch_physics.py's
    test_engine_step_refuses_unported_kernels."""
    hy = None if case == "cassie_pd_disc" else 1.5
    pd = case.startswith("cassie")
    substeps, b = (4, 2) if case.endswith("4_substeps") else (1, 4)
    mj, mt = _rotated(*((jcassie(), tcassie()) if pd else (jwalker3d(), twalker3d())))
    rng = np.random.default_rng(12)
    q, qd, tau, stones, sr, ug = _inputs(rng, mj, b=b)
    q[::2, 7] = mj.joint_upper[0] + 0.05  # half the envs start past a joint limit
    kw = dict(support_hy=hy, substeps=substeps)
    if pd:
        action, power = _pd_draws(rng, mj, b)
        target = np.array(jax.vmap(lambda a: jeng.pd_target_from_action(mj, a))(action))
        tau = np.zeros_like(tau)
        ref = jax_step_per_env(mj, q, qd, tau, stones, sr, ug, pd=(target, power), **kw)
        kw.update(pd_target=torch.as_tensor(target), pd_power=torch.as_tensor(power))
    else:
        ref = jax_step_per_env(mj, q, qd, tau, stones, sr, ug, **kw)
    st, info = teng.step(mt, teng.PhysicsState(*_t(q, qd)), *_t(tau, stones, sr, ug), **kw)
    _check_step((st.q, st.qd, info), ref)
    assert info.foot_contact.any() and info.joint_at_limit.any()


def test_rotated_engine_step_matches_pallas_kernel_interpret():
    """The port's control step on tests/test_pallas_step.py's
    rotated_small_model (the pendulum with a 0.4 rad x-rotated joint frame)
    against the TPU kernel's rotated-frame specialization itself, run in
    interpret mode at one 1024-env tile: the JAX package's own fast guard
    for K4."""
    rot = np.array([[1, 0, 0, 0], [np.cos(0.2), np.sin(0.2), 0, 0]], np.float32)
    mj = dataclasses.replace(_pendulum(jbuild), joint_rot=rot)
    mt = dataclasses.replace(_pendulum(tbuild), joint_rot=rot)
    n = pallas_step.TILE
    q, qd, tau, stones, sr, ug = _inputs(np.random.default_rng(13), mj, b=n, n_stones=6,
                                         drop=0.5, stone_drop=0.0)
    fn = pallas_step.build_batched_step(
        mj, jct.ContactParams(), 4, 6, jeng.SIM_DT, jeng.LIMIT_K, jeng.LIMIT_C,
        jeng.MAX_QD, jdyn.GRAVITY, interpret=True)
    qn, qdn, d = fn(*(jnp.asarray(x) for x in (q, qd, tau, stones, sr, ug)))
    st, info = teng.step(mt, teng.PhysicsState(*_t(q, qd)), *_t(tau, stones, sr, ug))
    _check_step((st.q, st.qd, info), (qn, qdn, jeng.StepInfo(**d)))
    assert (info.contact_force_sum > 0).float().mean() > 0.3  # contacts engage


@pytest.mark.parametrize("name", ["testbot", "rotbot"])
def test_parse_urdf_matches_jax(name):
    ours, ref = turdf.parse_urdf(XMLS[name]), jurdf.parse_urdf(XMLS[name])
    assert ours == ref
    assert ours["name"] == name and len(ours["joints"]) >= 3


@pytest.mark.parametrize("name, kw", [
    ("testbot", {}),
    ("rotbot", {}),
    ("testbot", dict(root_height=1.2, torque_limit_scale=0.5, kp=60.0, kd=6.0)),
])
def test_load_urdf_matches_jax(name, kw):
    """Every RobotModel field of the port's load_urdf equals the JAX
    loader's exactly (values and dtypes), and the same warnings fire."""
    with warnings.catch_warnings(record=True) as w_ours:
        warnings.simplefilter("always")
        ours = turdf.load_urdf(XMLS[name], **kw)
    with warnings.catch_warnings(record=True) as w_ref:
        warnings.simplefilter("always")
        ref = jurdf.load_urdf(XMLS[name], **kw)
    assert [str(w.message) for w in w_ours] == [str(w.message) for w in w_ref]
    assert bool(w_ours) == (name == "rotbot")  # rotbot's torso has inertia products
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    rows = np.any(ours.joint_rot != np.array([1, 0, 0, 0], np.float32), axis=1)
    assert rows.sum() == (1 if name == "testbot" else 5)
    if name == "rotbot":
        # fixed chains merged, feet named by the reference's rule
        assert ours.body_names == ("pelvis", "torso", "left_thigh", "left_foot",
                                   "right_thigh", "right_toe")
        assert list(ours.foot_of_contact) == [-1, -1, 1, 0]


def test_parse_error_reported():
    with pytest.raises(ValueError, match="URDF parse error"):
        turdf.parse_urdf("<robot><link name='x'></robot>")


def test_urdf_model_steps_match_jax():
    """tests/test_urdf.py's 60-step fall of the URDF robot onto the ground:
    the port's load_urdf and engine.step against the JAX loader and its
    engine.step scan; the robot lands on its spheres above -0.1 m."""
    mt, mj = turdf.load_urdf(TESTBOT, root_height=1.2), jurdf.load_urdf(TESTBOT, root_height=1.2)

    @jax.jit
    def run(state):
        def body(st, _):
            st, _ = jeng.step(mj, st, jnp.zeros(mj.njoints), jnp.zeros((1, 6)), 0.3,
                              jnp.asarray(True))
            return st, None
        return jax.lax.scan(body, state, None, length=60)[0]

    ref = run(jeng.default_state(mj))
    st = teng.default_state(mt, 1)
    for _ in range(60):
        st, _ = teng.step(mt, st, torch.zeros(mt.njoints), torch.zeros(1, 6), 0.3, True)
    np.testing.assert_allclose(st.q[0].numpy(), np.asarray(ref.q), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(st.qd[0].numpy(), np.asarray(ref.qd), rtol=1e-3, atol=1e-2)
    assert torch.isfinite(st.q).all() and float(st.q[0, 2]) > -0.1


@pytest.mark.parametrize("robot", ["walker3d", "cassie", "testbot"])
def test_to_mjcf_matches_jax(robot):
    """The MJCF documents are identical strings; the URDF robot's compiles
    in MuJoCo where it is installed."""
    if robot == "testbot":
        mt, mj = turdf.load_urdf(TESTBOT), jurdf.load_urdf(TESTBOT)
    else:
        mt, mj = (twalker3d(), jwalker3d()) if robot == "walker3d" else (tcassie(), jcassie())
    assert tmjcf.to_mjcf(mt) == jmjcf.to_mjcf(mj)
    assert tmjcf.to_mjcf(mt, with_floor=False, friction=0.7) == jmjcf.to_mjcf(
        mj, with_floor=False, friction=0.7)
    if robot == "testbot":
        pytest.importorskip("mujoco")
        mm = tmjcf.make_mj_model(mt)
        assert (mm.nq, mm.nv, mm.nu) == (mt.nq, mt.ndof, mt.action_dim)
