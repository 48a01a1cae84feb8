"""The host side of `control_step_warp<PD, PLANK, ROT>` (all eight
variants of kernels K1..K4, a warp per env), checked on the CPU: the model's
tables (bodies by tree level, each body's children, the mass matrix's
ancestor pattern), the per-env layout of the scratch in shared memory
against the kernel's source, the launch entries' dispatch of (pd, plank,
rot) to the template instantiations in the source, a walk of the tables in
PyTorch (with fixed joint rotations on the rotated robots) against the
port's kinematics and mass matrix (1e-6), and the lanes' search for each
sphere's first maximum against the serial loop (exact). The kernel itself
runs only on the card (tests/test_torch_structure.py, `chip_smoke.py`) and
under a warp emulation (tests/test_torch_warp_emulation.py)."""

import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from steppingstone_tpu_torch.core import quaternion as qt
from steppingstone_tpu_torch.core import spatial as sp
from steppingstone_tpu_torch.physics import dynamics, engine, kinematics, step_kernel
from steppingstone_tpu_torch.physics.dynamics import _ancestor_mask
from steppingstone_tpu_torch.physics.model import with_rotated_frames
from steppingstone_tpu_torch.physics.robots.cassie import cassie
from steppingstone_tpu_torch.physics.robots.walker3d import walker3d

MODELS = {"walker3d": walker3d, "cassie": cassie}
SK = step_kernel
SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block can use on an H100


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _sections(model):
    tab, nlev, npairs = SK.kernel_tables(model)
    nb = model.nbodies
    return dict(tab=tab, nlev=nlev, npairs=npairs,
                level=tab[SK.T_LEVEL:SK.T_LEVEL + nlev + 1],
                order=tab[SK.T_ORDER:SK.T_ORDER + nb],
                child=tab[SK.T_CHILD:SK.T_CHILD + nb + 1],
                children=tab[SK.T_CHILDREN:SK.T_CHILDREN + nb - 1],
                pairs=tab[SK.T_PAIRS:SK.T_PAIRS + npairs])


@pytest.mark.parametrize("name", list(MODELS))
def test_level_tables_list_each_body_once(name):
    model = MODELS[name]()
    t = _sections(model)
    tab, nlev, level, order = t["tab"], t["nlev"], t["level"], t["order"]
    assert tab.dtype == np.int32 and tab.shape == (SK.T_SIZE,)
    assert sorted(order.tolist()) == list(range(model.nbodies))
    assert level[0] == 0 and level[1] == 1 and order[0] == 0 and level[nlev] == model.nbodies
    assert np.all(np.diff(level) > 0)
    level_of = {int(i): d for d in range(nlev) for i in order[level[d]:level[d + 1]]}
    for i in range(1, model.nbodies):
        assert level_of[i] == level_of[int(model.parent[i])] + 1
    # each body's children, in decreasing index (the serial loop's order of
    # adding them into their parent)
    child, children = t["child"], t["children"]
    for i in range(model.nbodies):
        mine = children[child[i]:child[i + 1]].tolist()
        assert mine == sorted((c for c in range(1, model.nbodies) if model.parent[c] == i),
                              reverse=True)
    assert child[model.nbodies] == model.nbodies - 1
    # Walker3D: torso -> waist -> waist2 -> pelvis -> hip_x -> hip_z ->
    # thigh -> shin -> foot; Cassie's legs hang 7 levels below the pelvis
    assert nlev == {"walker3d": 9, "cassie": 8}[name]


@pytest.mark.parametrize("name", list(MODELS))
def test_pair_list_is_the_ancestor_pattern(name):
    model = MODELS[name]()
    t = _sections(model)
    pairs = [(int(p) >> 16, int(p) & 0xFFFF) for p in t["pairs"]]
    mask = _ancestor_mask(model)
    expect = [(k, l) for k in range(model.ndof) for l in range(k + 1) if mask[k, l]]
    assert len(pairs) == len(set(pairs)) == t["npairs"]
    assert sorted(pairs) == expect
    assert not t["tab"][SK.T_PAIRS + t["npairs"]:].any()
    assert t["npairs"] == {"walker3d": 233, "cassie": 161}[name]


def _c_to_python(expr: str) -> str:
    expr = re.sub(r"(\w+) \? (.+) : (.+)", r"(\2 if \1 else \3)", expr.strip())
    return expr.replace("/", "//")


def _kernel_source_layout(nb, nc, n_stones, plank):
    """`warp_layout` of csrc/control_step.cu, evaluated from its source."""
    src = SK.SOURCE.read_text()
    body = src[src.index("static WarpLayout warp_layout("):]
    body = body[:body.index("return L;")]
    fields = re.findall(r"L\.(\w+) = o;\s+o \+= ([^;]+);", body)
    env = dict(nb=nb, nc=nc, S=n_stones, plank=plank, nd=nb + 5)
    out, o = {}, 0
    for name, expr in fields:
        n = eval(_c_to_python(expr), {}, env)
        out[name] = (o, n)
        o += n
    return out


@pytest.mark.parametrize("plank", [False, True])
@pytest.mark.parametrize("name", list(MODELS) + ["maxima"])
def test_warp_layout_matches_the_kernel(name, plank):
    if name == "maxima":
        nb, nc, n_stones = SK.MAXB, SK.MAXC, SK.MAXS
    else:
        model = MODELS[name]()
        nb, nc, n_stones = model.nbodies, model.ncontacts, 20
    layout = SK.warp_layout(nb, nc, n_stones, plank)
    assert layout == _kernel_source_layout(nb, nc, n_stones, plank)
    # contiguous, in order, sized by what each section holds
    offsets = [o for o, _ in layout.values()]
    assert offsets == sorted(offsets) and offsets[0] == 0
    for (o, n), (o2, _) in zip(layout.values(), list(layout.values())[1:]):
        assert o + n == o2
    nd = nb + 5
    assert layout["A"][1] == nd * (nd + 1) // 2 and layout["phi"][1] == 6 * nd
    assert layout["su"][1] == (3 * n_stones if plank else 0)
    floats = SK.warp_floats(nb, nc, n_stones, plank)
    assert floats == sum(n for _, n in layout.values())
    # a block's scratch fits the shared memory a block can use
    assert SK.WARP_ENVS * 4 * floats <= SMEM_PER_BLOCK
    if name == "walker3d":
        assert 4 * floats == (7848 if plank else 7368)
    if name == "cassie":  # stable PD adds no shared memory
        assert 4 * floats == (5384 if plank else 4904)


def test_table_and_block_constants_match_the_kernel():
    src = SK.SOURCE.read_text()
    defines = dict(re.findall(r"^#define (\w+) (.+?)(?:\s+//.*)?$", src, re.M))
    assert int(defines["WARP_ENVS"]) == SK.WARP_ENVS
    env = {"MAXB": SK.MAXB, "MAXD": SK.MAXD}
    for name in ("T_LEVEL", "T_ORDER", "T_CHILD", "T_CHILDREN", "T_PAIRS", "T_SIZE"):
        env[name] = eval(_c_to_python(defines[name]), {}, env)
        assert env[name] == getattr(SK, name), name


def _dispatch(body):
    """switch case -> (the instantiated function, its bool template
    arguments) in a body that switches on (rot ? 4 : 0) | (pd ? 2 : 0) |
    (plank ? 1 : 0); a case that instantiates nothing is left out."""
    assert "switch ((rot ? 4 : 0) | (pd ? 2 : 0) | (plank ? 1 : 0))" in body
    cases = re.findall(r"(case \d+|default): (?:err = )?(\w+)<(\w+), (\w+), (\w+)>", body)
    return {7 if key == "default" else int(key.split()[1]):
            (fn, tuple(f == "true" for f in flags)) for key, fn, *flags in cases}


# every (pd, plank, rot): the variants that run control_step_warp
ON_WARP = {(pd, plank, rot) for pd in (False, True) for plank in (False, True)
           for rot in (False, True)}

LAUNCH = ("int control_step_launch(", "#undef WARP_ARGS")
# each launch entry's body in csrc/control_step.cu (from, to), the variants
# (pd, plank, rot) checked there, and what it instantiates for each: the
# launch without ROT and with it (both control_step_warp) and the
# occupancy query (every warp instantiation)
DISPATCH = {
    "warp launch": (LAUNCH, lambda f: not f[2], lambda f: ("launch_warp", f)),
    "K4 launch": (LAUNCH, lambda f: f[2], lambda f: ("launch_warp", f)),
    "occupancy": (("int control_step_warp_envs_per_sm(", "int control_step_launch("),
                  lambda f: True, lambda f: ("warp_blocks_per_sm", f)),
}


@pytest.mark.parametrize("entry", list(DISPATCH))
def test_launch_entries_dispatch_each_variant(entry):
    """Each (pd, plank, rot) reaches its own instantiation: all eight
    launch control_step_warp<PD, PLANK, ROT> (K2+K4 and K2+K3+K4 too), and
    the occupancy query knows all eight warp instantiations."""
    src = SK.SOURCE.read_text()
    assert ("template <bool PD, bool PLANK, bool ROT>\n"
            "__global__ void __launch_bounds__(WARP_ENVS") in src
    for rot in ("false", "true"):  # the plank+rot instantiations exist
        for fn in ("launch_warp", "warp_blocks_per_sm"):
            assert re.search(rf"{fn}<(true|false), true, {rot}>", src), (fn, rot)
    (start, end), checked, expect = DISPATCH[entry]
    body = src[src.index(start):]
    body = body[:body.index(end, 1)]
    flags = {4 * rot + 2 * pd + plank: (pd, plank, rot)
             for pd in (False, True) for plank in (False, True) for rot in (False, True)}
    cases = _dispatch(body)
    assert {k: c for k, c in cases.items() if checked(flags[k])} == {
        k: expect(f) for k, f in flags.items() if checked(f)}
    assert set(SK.VARIANTS.values()) == ON_WARP


@pytest.mark.parametrize("name", [*MODELS, "walker3d_rotated", "cassie_rotated"])
def test_tables_walk_matches_kinematics_and_mass_matrix(name):
    """Forward kinematics one tree level at a time and the mass matrix from
    the pair list, as control_step_warp computes them, in PyTorch at B = 4,
    against the port's kinematics and dynamics (1e-6); on the rotated
    robots (fixed joint rotations drawn from a seed) each flagged body's
    hinge frame is (quat[p] * jrot[i]) * axis_angle, as K4's lanes form it."""
    model = MODELS[name.removesuffix("_rotated")]()
    if name.endswith("_rotated"):
        model = with_rotated_frames(model, seed=2)
    jrot, rot_rows = SK._joint_rotations(model, "cpu") if model.joint_rot is not None else (None, 0)
    t = _sections(model)
    level, order, child, children = t["level"], t["order"], t["child"], t["children"]
    rng = np.random.default_rng(3)
    q = engine.default_state(model, 4).q.clone()
    q[:, 7:] += torch.as_tensor(0.3 * rng.standard_normal((4, model.njoints)), dtype=torch.float32)
    quat0 = torch.as_tensor(rng.standard_normal((4, 4)), dtype=torch.float32)
    q[:, 3:7] = quat0 / quat0.norm(dim=1, keepdim=True)
    anchor = torch.as_tensor(model.joint_anchor, dtype=torch.float32)
    axis = torch.as_tensor(model.joint_axis, dtype=torch.float32)
    parent = [int(p) for p in model.parent]
    nb = model.nbodies
    pos, quat = [None] * nb, [None] * nb
    pos[0], quat[0] = q[:, :3], q[:, 3:7]
    for d in range(1, t["nlev"]):
        for i in order[level[d]:level[d + 1]]:
            p = parent[i]
            assert pos[p] is not None and pos[i] is None  # parent done, each body once
            pos[i] = pos[p] + qt.rotate(quat[p], anchor[i])
            frame = qt.mul(quat[p], jrot[i]) if (rot_rows >> int(i)) & 1 else quat[p]
            quat[i] = qt.mul(frame, qt.from_axis_angle(axis[i], q[:, 6 + i]))
    kin = kinematics.forward_kinematics(model, q)
    torch.testing.assert_close(torch.stack(pos, 1), kin.pos, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.stack(quat, 1), kin.quat, rtol=1e-6, atol=1e-6)
    if jrot is not None:  # three of four rows are rotated, and it matters
        assert bin(rot_rows).count("1") == nb - len(range(0, nb, 4))
        plain = kinematics.forward_kinematics(dataclasses.replace(model, joint_rot=None), q)
        assert (plain.pos - kin.pos).abs().max() > 1e-2

    # composite inertias leaves to root, each parent pulling its children
    # in the tables' order; then F_k = Ic phi_k and M[k, l] = F_k . phi_l
    # on the pair list
    mass = torch.as_tensor(model.mass, dtype=torch.float32)
    ic = list(sp.inertia_matrix(mass.expand(4, -1), kin.com - kin.pos[:, 0:1],
                                kin.inertia_w).unbind(1))
    for d in range(t["nlev"] - 2, -1, -1):
        for i in order[level[d]:level[d + 1]]:
            for c in children[child[i]:child[i + 1]]:
                ic[i] = ic[i] + ic[c]
    phi = dynamics.dof_axes(model, kin)
    M = torch.zeros(4, model.ndof, model.ndof)
    for kl in t["pairs"]:
        k, l = int(kl) >> 16, int(kl) & 0xFFFF
        F = (ic[0 if k < 6 else k - 5] * phi[:, k, None, :]).sum(-1)
        M[:, k, l] = M[:, l, k] = (F * phi[:, l]).sum(-1)
    torch.testing.assert_close(M, dynamics.mass_matrix(model, kin, phi), rtol=1e-6, atol=1e-6)


def _first_max_by_lanes(pen, ok, nc, n_stones):
    """The kernel's search: nch lanes (a power of two) per sphere, each over
    a run of stones in order keeping the first maximum, then a butterfly
    over the sphere's lanes where the larger wins and a tie goes to the
    lower stone."""
    nch = 1
    while nch < 32 and 2 * nch * nc <= 32:
        nch *= 2
    run = -(-n_stones // nch)
    best, bi = [-math.inf] * 32, [0] * 32
    for lane in range(32):
        c, first = lane // nch, (lane % nch) * run
        bi[lane] = first
        if c < nc:
            for st in range(first, min(n_stones, first + run)):
                if ok[c, st] and pen[c, st] > best[lane]:
                    best[lane], bi[lane] = pen[c, st], st
    off = nch // 2
    while off:
        other = [(best[lane ^ off], bi[lane ^ off]) for lane in range(32)]
        for lane, (ob, oi) in enumerate(other):
            if ob > best[lane] or (ob == best[lane] and oi < bi[lane]):
                best[lane], bi[lane] = ob, oi
        off //= 2
    return [(best[c * nch], bi[c * nch]) for c in range(nc)]


@pytest.mark.parametrize("nc,n_stones", [(12, 20), (5, 20), (16, 32), (12, 7), (2, 6), (1, 1)])
def test_lanes_find_the_first_maximum(nc, n_stones):
    rng = np.random.default_rng(nc * 100 + n_stones)
    for _ in range(20):
        # few distinct depths, so that ties are common; a third invalid
        pen = rng.integers(1, 4, size=(nc, n_stones)).astype(np.float32)
        ok = rng.random((nc, n_stones)) < 0.67
        serial = []
        for c in range(nc):
            best, bi = -math.inf, 0
            for st in range(n_stones):
                if ok[c, st] and pen[c, st] > best:
                    best, bi = pen[c, st], st
            serial.append((best, bi))
        assert _first_max_by_lanes(pen, ok, nc, n_stones) == serial
