"""Port parity, core math and model data: steppingstone_tpu_torch's
quaternion, spatial, model, walker3d, cassie and linalg modules against the
JAX package's, on the same seeded numpy inputs.

Tolerances: elementwise fp32 formulas evaluated by two libraries differ in
the last bits (sin/cos/atan2 implementations, fused multiply-adds), so
1e-6 absolute on O(1) values; spatial products of O(10) masses and
inertias get 1e-5 relative; the 27-dof solve gets 1e-4 relative on a
matrix conditioned ~1e4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steppingstone_tpu.core import quaternion as jq
from steppingstone_tpu.core import spatial as jsp
from steppingstone_tpu.ops import linalg as jla
from steppingstone_tpu.physics.robots import cassie as jcassie
from steppingstone_tpu.physics.robots import walker3d as jwalker
from steppingstone_tpu_torch.core import quaternion as tq
from steppingstone_tpu_torch.core import spatial as tsp
from steppingstone_tpu_torch.ops import linalg as tla
from steppingstone_tpu_torch.physics.robots import REGISTRY as TREGISTRY
from steppingstone_tpu_torch.physics.robots import cassie as tcassie
from steppingstone_tpu_torch.physics.robots import walker3d as twalker

B = 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _unit_quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _pair(fn_j, fn_t, *args):
    """Run the JAX and the port function on the same numpy args."""
    out_j = fn_j(*(jnp.asarray(a) for a in args))
    out_t = fn_t(*(torch.as_tensor(a) for a in args))
    if isinstance(out_j, tuple):
        return [np.asarray(x) for x in out_j], [x.numpy() for x in out_t]
    return [np.asarray(out_j)], [out_t.numpy()]


QUAT_CASES = {
    "mul": lambda r: (jq.mul, tq.mul, _unit_quats(r, B), _unit_quats(r, B)),
    "rotate": lambda r: (jq.rotate, tq.rotate, _unit_quats(r, B),
                         r.standard_normal((B, 3)).astype(np.float32)),
    "rotate_inv": lambda r: (jq.rotate_inv, tq.rotate_inv, _unit_quats(r, B),
                             r.standard_normal((B, 3)).astype(np.float32)),
    "from_axis_angle": lambda r: (
        jq.from_axis_angle, tq.from_axis_angle,
        (lambda a: a / np.linalg.norm(a, axis=1, keepdims=True))(
            r.standard_normal((B, 3)).astype(np.float32)),
        r.uniform(-3, 3, B).astype(np.float32)),
    "to_matrix": lambda r: (jq.to_matrix, tq.to_matrix, _unit_quats(r, B)),
    "to_euler_zyx": lambda r: (jq.to_euler_zyx, tq.to_euler_zyx, _unit_quats(r, B)),
    "normalize": lambda r: (jq.normalize, tq.normalize,
                            r.standard_normal((B, 4)).astype(np.float32)),
    "integrate": lambda r: (lambda q, w: jq.integrate(q, w, 1.0 / 240.0),
                            lambda q, w: tq.integrate(q, w, 1.0 / 240.0),
                            _unit_quats(r, B), 5 * r.standard_normal((B, 3)).astype(np.float32)),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quaternion_matches_jax(name):
    fn_j, fn_t, *args = QUAT_CASES[name](np.random.default_rng(0))
    for a, b in zip(*_pair(fn_j, fn_t, *args)):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_quaternion_identity():
    np.testing.assert_array_equal(tq.identity().numpy(), np.asarray(jq.identity()))


def _spatial_args(r):
    mass = r.uniform(0.5, 20, B).astype(np.float32)
    com = r.standard_normal((B, 3)).astype(np.float32)
    a = r.standard_normal((B, 3, 3)).astype(np.float32)
    inertia = (a @ a.transpose(0, 2, 1) * 0.1).astype(np.float32)
    v = r.standard_normal((B, 6)).astype(np.float32)
    f = r.standard_normal((B, 6)).astype(np.float32)
    return mass, com, inertia, v, f


SPATIAL_CASES = {
    "cross_motion": lambda m, c, I, v, f: (jsp.cross_motion, tsp.cross_motion, v, f),
    "cross_force": lambda m, c, I, v, f: (jsp.cross_force, tsp.cross_force, v, f),
    "inertia_matrix": lambda m, c, I, v, f: (jsp.inertia_matrix, tsp.inertia_matrix, m, c, I),
    "inertia_mul": lambda m, c, I, v, f: (jsp.inertia_mul, tsp.inertia_mul, m, c, I, v),
    "force_at_point": lambda m, c, I, v, f: (jsp.force_at_point, tsp.force_at_point, f[:, 3:], c),
}


@pytest.mark.parametrize("name", sorted(SPATIAL_CASES))
def test_spatial_matches_jax(name):
    fn_j, fn_t, *args = SPATIAL_CASES[name](*_spatial_args(np.random.default_rng(1)))
    for a, b in zip(*_pair(fn_j, fn_t, *args)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def _assert_models_equal(mj, mt):
    """Every field of the port's own copy of a model equals the JAX
    package's (exact: both are the same numpy construction)."""
    import dataclasses

    for f in dataclasses.fields(mj):
        a, b = getattr(mj, f.name), getattr(mt, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, f.name
    assert [mt.ancestors(i) for i in range(mt.nbodies)] == [
        mj.ancestors(i) for i in range(mj.nbodies)]


def test_walker3d_model_fields_equal():
    mj, mt = jwalker.walker3d(), twalker.walker3d()
    _assert_models_equal(mj, mt)
    assert (mt.nbodies, mt.njoints, mt.ndof, mt.nq, mt.ncontacts) == (22, 21, 27, 28, 12)
    assert twalker.RUNNING_START == jwalker.RUNNING_START
    assert twalker.MIRROR == jwalker.MIRROR


def test_cassie_model_fields_equal():
    mj, mt = jcassie.cassie(), tcassie.cassie()
    _assert_models_equal(mj, mt)
    assert (mt.nbodies, mt.njoints, mt.ndof, mt.nq, mt.ncontacts) == (15, 14, 20, 21, 5)
    assert mt.action_dim == 10 and int((mt.kp > 0).sum()) == 10
    assert tcassie.MIRROR == jcassie.MIRROR
    assert tcassie.MIRROR_ACTION == jcassie.MIRROR_ACTION
    assert TREGISTRY["cassie"] is tcassie.cassie


@pytest.mark.parametrize("n", [6, 27])
def test_cholesky_solve_matches_jax(n):
    r = np.random.default_rng(n)
    a = r.standard_normal((8, n, n)).astype(np.float32)
    A = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(n, dtype=np.float32)).astype(np.float32)
    b = r.standard_normal((8, n)).astype(np.float32)
    x_j = np.asarray(jla.cholesky_solve(jnp.asarray(A), jnp.asarray(b)))
    x_t = tla.cholesky_solve(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=1e-4, atol=1e-4 * np.abs(x_j).max())
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A, x_t), b, atol=1e-3)
