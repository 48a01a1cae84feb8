"""Port parity, physics: steppingstone_tpu_torch's kinematics, contact,
dynamics and engine against the JAX package on Walker3D (B = 8), the
engine's stable-PD and plank variants on Cassie and Walker3D against JAX's
scan, and the port's control step against the Pallas kernel itself
(interpret mode) on the pendulum models at one 1024-env tile, as
tests/test_pallas_step.py runs it (torque/disc, and stable PD with disc and
plank support).

Tolerances: single-evaluation quantities (kinematics, contact, mass
matrix, bias) agree to fp32 rounding of sums taken in another order:
1e-5 relative, with absolute floors scaled to each quantity's magnitude.
Control steps use the kernel parity tolerances of tests/test_pallas_step.py
(q 2e-4, qd 2e-3/2e-2, contact and stone agreement fractions), because
four substeps of stiff penalty contact amplify those rounding
differences."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_draws import jax_step_per_env

from steppingstone_tpu.physics import contact as jct
from steppingstone_tpu.physics import dynamics as jdyn
from steppingstone_tpu.physics import engine as jeng
from steppingstone_tpu.physics import kinematics as jkin
from steppingstone_tpu.physics import pallas_step
from steppingstone_tpu.physics.robots.cassie import cassie as jcassie
from steppingstone_tpu.physics.robots.walker3d import walker3d as jwalker3d
from steppingstone_tpu_torch.physics import contact as tct
from steppingstone_tpu_torch.physics import dynamics as tdyn
from steppingstone_tpu_torch.physics import engine as teng
from steppingstone_tpu_torch.physics import kinematics as tkin
from steppingstone_tpu_torch.physics.model import build_model as tbuild
from steppingstone_tpu_torch.physics.model import with_rotated_frames
from steppingstone_tpu_torch.physics.robots.cassie import cassie as tcassie
from steppingstone_tpu_torch.physics.robots.walker3d import walker3d as twalker3d

B = 8
N_STONES = 20


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(rng, model, b=B, n_stones=N_STONES, drop=0.2, stone_drop=0.2):
    """Perturbed standing states lowered by `drop` over a field of tilted
    stones lowered by `stone_drop`, so contacts (stones and ground) and
    joint limits engage, as in tests/test_pallas_step.py."""
    q0 = np.asarray(jeng.default_state(model).q)
    q = np.tile(q0, (b, 1))
    q[:, 2] += 0.05 * rng.standard_normal(b) - drop
    q[:, 7:] += 0.1 * rng.standard_normal((b, model.njoints))
    q[:, 3:7] += 0.05 * rng.standard_normal((b, 4))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    qd = 0.3 * rng.standard_normal((b, model.ndof))
    tau = 20.0 * rng.standard_normal((b, model.njoints))
    stones = np.zeros((b, n_stones, 6))
    stones[:, :, 0] = rng.uniform(-0.5, 0.5, (b, n_stones))
    stones[:, :, 1] = rng.uniform(-0.4, 0.4, (b, n_stones))
    stones[:, :, 2] = rng.uniform(-0.1 - stone_drop, 0.02 - stone_drop, (b, n_stones))
    stones[:, :, 3] = rng.uniform(-0.5, 0.5, (b, n_stones))
    stones[:, :, 4:6] = 0.1 * rng.standard_normal((b, n_stones, 2))
    sr = np.full(b, 0.25)
    ug = rng.random(b) < 0.5
    f32 = lambda x: np.ascontiguousarray(x, dtype=np.float32)
    return f32(q), f32(qd), f32(tau), f32(stones), f32(sr), ug


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.fixture(scope="module")
def walker():
    return jwalker3d(), twalker3d()


@pytest.fixture(scope="module")
def kin_pair(walker):
    mj, mt = walker
    q, qd, *_ = _inputs(np.random.default_rng(0), mj)
    kj = jax.vmap(lambda x: jkin.forward_kinematics(mj, x))(jnp.asarray(q))
    kt = tkin.forward_kinematics(mt, torch.as_tensor(q))
    vj = jax.vmap(lambda k, v: jkin.body_velocities(mj, k, v))(kj, jnp.asarray(qd))
    vt = tkin.body_velocities(mt, kt, torch.as_tensor(qd))
    return kj, kt, vj, vt


def test_kinematics_matches_jax(walker, kin_pair):
    mj, mt = walker
    kj, kt, vj, vt = kin_pair
    for f in kj._fields:
        np.testing.assert_allclose(getattr(kt, f).numpy(), np.asarray(getattr(kj, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-5)
    pj = jax.vmap(lambda k: jkin.contact_points(mj, k))(kj)
    pt = tkin.contact_points(mt, kt)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5, atol=1e-5)
    pvj = jax.vmap(lambda k, v, p: jkin.contact_point_velocities(mj, k, v, p))(kj, vj, pj)
    pvt = tkin.contact_point_velocities(mt, kt, vt, pt)
    np.testing.assert_allclose(pvt.numpy(), np.asarray(pvj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("support_hy", [None, 0.6])
def test_contacts_match_jax(support_hy):
    """compute_contacts, disc and plank branches, on spheres scattered
    around stones and the ground so every branch of the support choice runs."""
    rng = np.random.default_rng(2)
    nc, s = 24, 6
    stones = np.zeros((B, s, 6), np.float32)
    stones[..., :2] = rng.uniform(-0.6, 0.6, (B, s, 2))
    stones[..., 2] = rng.uniform(-0.05, 0.05, (B, s))
    stones[..., 3:] = 0.2 * rng.standard_normal((B, s, 3))
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (B, nc, 2)),
                          rng.uniform(-0.06, 0.08, (B, nc, 1))], axis=-1).astype(np.float32)
    vel = rng.standard_normal((B, nc, 3)).astype(np.float32)
    radius = rng.uniform(0.02, 0.06, nc).astype(np.float32)
    sr = np.full(B, 0.25, np.float32)
    ug = np.arange(B) % 2 == 0
    cj = jax.vmap(lambda p, v, st, r, g: jct.compute_contacts(
        p, v, jnp.asarray(radius), st, r, g, support_hy=support_hy))(
        jnp.asarray(pts), jnp.asarray(vel), jnp.asarray(stones), jnp.asarray(sr), jnp.asarray(ug))
    ct_ = tct.compute_contacts(*_t(pts, vel, radius, stones, sr, ug), support_hy=support_hy)
    np.testing.assert_array_equal(ct_.in_contact.numpy(), np.asarray(cj.in_contact))
    np.testing.assert_array_equal(ct_.stone_index.numpy(), np.asarray(cj.stone_index))
    assert 0 < ct_.in_contact.float().mean() < 1
    assert (ct_.stone_index >= 0).any() and ((ct_.stone_index < 0) & ct_.in_contact).any()
    np.testing.assert_allclose(ct_.normal_force.numpy(), np.asarray(cj.normal_force),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(ct_.force.numpy(), np.asarray(cj.force), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tct.stone_normals(torch.as_tensor(stones)).numpy(),
                               np.asarray(jct.stone_normals(jnp.asarray(stones))), atol=1e-6)
    for a, b in zip(tct.support_axes(torch.as_tensor(stones)),
                    jct.support_axes(jnp.asarray(stones))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    cb = np.arange(nc) % 5
    fj = jax.vmap(lambda p, r, f: jct.contact_forces_to_bodies(5, jnp.asarray(cb), p, r, f))(
        jnp.asarray(pts), jnp.asarray(pts[:, 0]), cj.force)
    ft = tct.contact_forces_to_bodies(5, torch.as_tensor(cb), *_t(pts, pts[:, 0]), ct_.force)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5, atol=1e-3)


def test_dynamics_match_jax(walker, kin_pair):
    mj, mt = walker
    kj, kt, vj, vt = kin_pair
    np.testing.assert_array_equal(tdyn._ancestor_mask(mt), jdyn._ancestor_mask(mj))
    rng = np.random.default_rng(3)
    f_ext = (50 * rng.standard_normal((B, mj.nbodies, 6))).astype(np.float32)
    tau = (20 * rng.standard_normal((B, mj.ndof))).astype(np.float32)
    damp = rng.uniform(0, 20, (B, mj.ndof)).astype(np.float32)
    stiff = rng.uniform(0, 600, (B, mj.ndof)).astype(np.float32)

    def jax_side(k, v, fe, t, d, s):
        phi = jdyn.dof_axes(mj, k)
        return (phi, jdyn.mass_matrix(mj, k, phi), jdyn.bias_forces(mj, k, v, phi, fe),
                jdyn.forward_dynamics(mj, k, v, t, fe, damping_diag=d, stiffness_diag=s,
                                      dt=1 / 240))

    outs_j = jax.vmap(jax_side)(kj, vj, *(jnp.asarray(x) for x in (f_ext, tau, damp, stiff)))
    phi = tdyn.dof_axes(mt, kt)
    fe, t, d, s = _t(f_ext, tau, damp, stiff)
    outs_t = (phi, tdyn.mass_matrix(mt, kt, phi), tdyn.bias_forces(mt, kt, vt, phi, fe),
              tdyn.forward_dynamics(mt, kt, vt, t, fe, damping_diag=d, stiffness_diag=s,
                                    dt=1 / 240))
    for name, a, b in zip(("phi", "M", "C", "qdd"), outs_t, outs_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)


def test_joint_torques_match_jax(walker):
    mj, mt = walker
    rng = np.random.default_rng(4)
    qj = rng.uniform(-2.5, 2.5, (B, mj.njoints)).astype(np.float32)
    qdj = rng.standard_normal((B, mj.njoints)).astype(np.float32)
    act = rng.uniform(-1.5, 1.5, (B, mj.action_dim)).astype(np.float32)
    lim_j = jax.vmap(lambda a, b: jeng.joint_limit_torque(mj, a, b))(qj, qdj)
    lim_t = teng.joint_limit_torque(mt, *_t(qj, qdj))
    np.testing.assert_allclose(lim_t[0].numpy(), np.asarray(lim_j[0]), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(lim_t[1].numpy(), np.asarray(lim_j[1]))
    np.testing.assert_allclose(
        teng.passive_torque(mt, *_t(qj, qdj)).numpy(),
        np.asarray(jax.vmap(lambda a, b: jeng.passive_torque(mj, a, b))(qj, qdj)), atol=1e-6)
    np.testing.assert_allclose(
        teng.torque_actuation(mt, torch.as_tensor(act)).numpy(),
        np.asarray(jax.vmap(lambda a, b, c: jeng.torque_actuation(mj, a, b, c))(act, qj, qdj)),
        atol=1e-6)


def _check_step(out, ref):
    """(q, qd, info) against a JAX (q, qd, info) with the Pallas test's bars."""
    q, qd, info = out
    q_r, qd_r, info_r = (jax.tree.map(np.asarray, x) for x in ref)
    np.testing.assert_allclose(q.numpy(), q_r, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(qd.numpy(), qd_r, rtol=2e-3, atol=2e-2)
    assert np.mean(info.foot_contact.numpy() == info_r.foot_contact) > 0.999
    assert np.mean(info.foot_stone.numpy() == info_r.foot_stone) > 0.995
    assert np.mean(info.joint_at_limit.numpy() == info_r.joint_at_limit) > 0.999
    np.testing.assert_allclose(info.foot_normal_force.numpy(), info_r.foot_normal_force,
                               rtol=1e-2, atol=1.0)
    np.testing.assert_allclose(info.contact_force_sum.numpy(), info_r.contact_force_sum,
                               rtol=1e-2, atol=4.0)


def test_engine_step_matches_jax_step_scan(walker):
    """The port's engine.step (plain version on the CPU) against
    jax.vmap(engine._step_scan) on Walker3D, four substeps."""
    mj, mt = walker
    q, qd, tau, stones, sr, ug = _inputs(np.random.default_rng(5), mj)
    ref = jax.jit(jax.vmap(lambda *a: (lambda st, i: (st.q, st.qd, i))(
        *jeng._step_scan(mj, jeng.PhysicsState(a[0], a[1]), *a[2:]))))(
        q, qd, tau, stones, sr, ug)
    st, info = teng.step(mt, teng.PhysicsState(*_t(q, qd)), *_t(tau, stones, sr, ug))
    _check_step((st.q, st.qd, info), ref)
    assert info.foot_contact.any() and (info.foot_stone >= 0).any()
    assert info.joint_at_limit.any()


def _pendulum(build):
    """tests/test_pallas_step.py's 2-body pendulum with a foot-like sphere."""
    bodies = [
        dict(name="base", mass=5.0, inertia=(0.5, 0.5, 0.5), root_height=1.0),
        dict(name="arm", parent="base", anchor=(0, 0, 0), axis=(0, 1, 0),
             mass=1.0, com=(0, 0, -0.5), inertia=(0.05, 0.05, 0.05),
             damping=0.1, limits=(-2.0, 2.0)),
    ]
    contacts = [dict(body="arm", offset=(0, 0, -0.5), radius=0.05),
                dict(body="base", offset=(0, 0, -0.1), radius=0.05)]
    return build("pendulum", bodies, contacts)


def test_engine_step_matches_pallas_kernel_interpret():
    """The port's control step against the TPU kernel itself, run in
    interpret mode at one 1024-env tile on the pendulum, as
    tests/test_pallas_step.py runs it."""
    from steppingstone_tpu.physics.model import build_model as jbuild

    mj, mt = _pendulum(jbuild), _pendulum(tbuild)
    n = pallas_step.TILE
    q, qd, tau, stones, sr, ug = _inputs(np.random.default_rng(6), mj, b=n, n_stones=6,
                                         drop=0.47, stone_drop=0.0)
    fn = pallas_step.build_batched_step(
        mj, jct.ContactParams(), 4, 6, jeng.SIM_DT, jeng.LIMIT_K, jeng.LIMIT_C,
        jeng.MAX_QD, jdyn.GRAVITY, interpret=True)
    qn, qdn, d = fn(*(jnp.asarray(x) for x in (q, qd, tau, stones, sr, ug)))
    ref = (qn, qdn, jeng.StepInfo(**d))
    st, info = teng.step(mt, teng.PhysicsState(*_t(q, qd)), *_t(tau, stones, sr, ug))
    _check_step((st.q, st.qd, info), ref)
    assert (info.contact_force_sum > 0).float().mean() > 0.3  # contacts engage


def _pd_pendulum(build):
    """tests/test_pallas_step.py's PD pendulum (kp/kd at Cassie's scale)."""
    bodies = [
        dict(name="base", mass=5.0, inertia=(0.5, 0.5, 0.5), root_height=1.0),
        dict(name="arm", parent="base", anchor=(0, 0, 0), axis=(0, 1, 0),
             mass=1.0, com=(0, 0, -0.5), inertia=(0.05, 0.05, 0.05),
             damping=0.1, limits=(-2.0, 2.0), kp=60.0, kd=6.0, torque_limit=45.0),
    ]
    contacts = [dict(body="arm", offset=(0, 0, -0.5), radius=0.05),
                dict(body="base", offset=(0, 0, -0.1), radius=0.05)]
    return build("pd_pendulum", bodies, contacts)


def _pd_draws(rng, model, b):
    """Random actions (some beyond [-1, 1]) and a per-env power in [0.5, 1]."""
    action = rng.uniform(-1.2, 1.2, (b, model.action_dim)).astype(np.float32)
    return action, rng.uniform(0.5, 1.0, b).astype(np.float32)


def test_pd_target_from_action_matches_jax():
    mj, mt = jcassie(), tcassie()
    action, _ = _pd_draws(np.random.default_rng(8), mj, B)
    ref = jax.vmap(lambda a: jeng.pd_target_from_action(mj, a))(action)
    out = teng.pd_target_from_action(mt, torch.as_tensor(action))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    kp, kd, lim = teng.pd_gains(mt, "cpu")
    assert torch.equal(kp == 0, torch.as_tensor(~mj.actuated))
    assert torch.all(kd[kp == 0] == 0) and torch.all(lim[kp == 0] == 0)


@pytest.mark.parametrize("case", ["cassie_pd_disc", "cassie_pd_plank", "walker_plank"])
def test_engine_step_variants_match_jax_step_scan(case, walker):
    """engine.step (plain version on the CPU) in its stable-PD (K3), plank
    (K2) and PD-on-plank (K2+K3) variants against jax.vmap(_step_scan):
    Cassie driven by PD targets from random actions with a per-env power
    (tau zeros, unbatched, as the stepper passes it), Walker3D by torques
    on planks of half-width 1.5 (LargePlank)."""
    hy = None if case == "cassie_pd_disc" else 1.5
    mj, mt = (jcassie(), tcassie()) if case.startswith("cassie") else walker
    rng = np.random.default_rng(9)
    q, qd, tau, stones, sr, ug = _inputs(rng, mj)
    q[::2, 7] = mj.joint_upper[0] + 0.05  # half the envs start past a joint limit
    state = teng.PhysicsState(*_t(q, qd))
    if case.startswith("cassie"):
        action, power = _pd_draws(rng, mj, B)
        target = np.array(jax.vmap(lambda a: jeng.pd_target_from_action(mj, a))(action))
        zeros = np.zeros(mj.njoints, np.float32)
        ref = jax.jit(jax.vmap(lambda q_, qd_, tg, pw, st_, r, g: (lambda s, i: (s.q, s.qd, i))(
            *jeng._step_scan(mj, jeng.PhysicsState(q_, qd_), zeros, st_, r, g,
                             pd=(tg, pw), support_hy=hy))))(q, qd, target, power, stones, sr, ug)
        st, info = teng.step(mt, state, torch.zeros(mt.njoints), *_t(stones, sr, ug),
                             pd_target=torch.as_tensor(target), pd_power=torch.as_tensor(power),
                             support_hy=hy)
    else:
        ref = jax.jit(jax.vmap(lambda q_, qd_, t, st_, r, g: (lambda s, i: (s.q, s.qd, i))(
            *jeng._step_scan(mj, jeng.PhysicsState(q_, qd_), t, st_, r, g, support_hy=hy))))(
            q, qd, tau, stones, sr, ug)
        st, info = teng.step(mt, state, *_t(tau, stones, sr, ug), support_hy=hy)
    _check_step((st.q, st.qd, info), ref)
    assert info.foot_contact.any() and (info.foot_stone >= 0).any()
    assert info.joint_at_limit.any()


@pytest.mark.parametrize("support_hy", [None, 0.6])
def test_engine_step_pd_matches_pallas_kernel_interpret(support_hy):
    """The port's stable-PD control step (disc, and planks of half-width
    0.6) against the TPU kernel's `pd=True` variant itself, run in
    interpret mode at one 1024-env tile on the PD pendulum, as
    tests/test_pallas_step.py runs it."""
    from steppingstone_tpu.physics.model import build_model as jbuild

    mj, mt = _pd_pendulum(jbuild), _pd_pendulum(tbuild)
    n = pallas_step.TILE
    rng = np.random.default_rng(10)
    q, qd, _, stones, sr, ug = _inputs(rng, mj, b=n, n_stones=6, drop=0.47, stone_drop=0.0)
    q[::3, 7] = 2.05  # a third of the arms start past the joint limit
    action, power = _pd_draws(rng, mj, n)
    target = np.array(jax.vmap(lambda a: jeng.pd_target_from_action(mj, a))(action))
    tau = np.zeros((n, mj.njoints), np.float32)
    fn = pallas_step.build_batched_step(
        mj, jct.ContactParams(), 4, 6, jeng.SIM_DT, jeng.LIMIT_K, jeng.LIMIT_C,
        jeng.MAX_QD, jdyn.GRAVITY, interpret=True, pd=True, support_hy=support_hy)
    qn, qdn, d = fn(*(jnp.asarray(x) for x in (q, qd, tau, target, power, stones, sr, ug)))
    ref = (qn, qdn, jeng.StepInfo(**d))
    st, info = teng.step(mt, teng.PhysicsState(*_t(q, qd)), *_t(tau, stones, sr, ug),
                         pd_target=torch.as_tensor(target), pd_power=torch.as_tensor(power),
                         support_hy=support_hy)
    _check_step((st.q, st.qd, info), ref)
    assert (info.contact_force_sum > 0).float().mean() > 0.3  # contacts engage
    assert info.joint_at_limit.any()


def test_engine_step_rotated_walker_matches_jax(walker):
    """Nothing is refused any more: rotated joint frames (K4) run and match
    the JAX package's jnp path on Walker3D with rotations drawn from a seed
    (torques, discs, the Pallas test's bars), and stable PD and planks
    return finite states on the CPU. One substep: the rotations enter the
    forward kinematics of every substep alike, and XLA's CPU compile of the
    rotated Walker3D step grows by ~25 s a substep."""
    mj, mt = walker
    rng = np.random.default_rng(7)
    q, qd, tau, stones, sr, ug = _inputs(rng, mj, b=4)
    mt_rot = with_rotated_frames(mt, seed=7)
    mj_rot = dataclasses.replace(mj, joint_rot=mt_rot.joint_rot)
    ref = jax_step_per_env(mj_rot, q, qd, tau, stones, sr, ug, substeps=1)
    st, info = teng.step(mt_rot, teng.PhysicsState(*_t(q, qd)), *_t(tau, stones, sr, ug),
                         substeps=1)
    _check_step((st.q, st.qd, info), ref)
    assert info.foot_contact.any() and (info.contact_force_sum > 0).any()
    state = teng.PhysicsState(*_t(q[:2], qd[:2]))
    target = teng.pd_target_from_action(mt, torch.zeros(2, mt.action_dim))
    for kw in (dict(pd_target=target), dict(support_hy=0.6),
               dict(pd_target=target, pd_power=0.5, support_hy=1.5)):
        st, info = teng.step(mt, state, *_t(tau[:2], stones[:2], sr[:2], ug[:2]), **kw)
        assert torch.isfinite(st.q).all() and torch.isfinite(st.qd).all(), kw
        assert st.q.shape == (2, mt.nq) and info.foot_stone.shape == (2, 2)


def test_default_state_matches_jax(walker):
    mj, mt = walker
    st = teng.default_state(mt, 3)
    ref = jeng.default_state(mj)
    np.testing.assert_array_equal(st.q.numpy(), np.tile(np.asarray(ref.q), (3, 1)))
    np.testing.assert_array_equal(st.qd.numpy(), np.tile(np.asarray(ref.qd), (3, 1)))
