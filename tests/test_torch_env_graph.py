"""The env step's CUDA graph (steppingstone_tpu_torch/envs/vector.py) and the
constants it needs on the device.

On the CPU, at fleets of 4 envs: `VecEnv.step` steps eagerly and never
captures; the graph's key changes with each thing a capture depends on;
the graph's data path (the state, actions and draws copied into aligned
slots, the step on the slots, the outputs copied out) gives the direct
step's answers bit for bit and returns tensors that share no storage with
the slots; a step, after its first, makes no tensor from host data (the
plain physics, which stands in for the kernel on the CPU, aside); the
constants are made once.

Card-marked (skipped without a card; on the card:
`python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_env_graph.py -m card`):
over 160 steps with resets, the graphed trajectory equals `StepperEnv.step`
called eagerly bit for bit (Walker3D K2 at 1,024 and 16 envs, Cassie
K2+K3 at 1,024), the tensors a step returns are not written by the next
one and the caller's inputs not at all; one capture, then a replay a
step; `CONTROL_STEP.launches` rises by one a control step, the capture's
included; no host sync in a replayed step; a new batch size or config
captures again.
"""

import pytest
import torch

from steppingstone_tpu_torch.core import quaternion as qt
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.envs import terrain as terr
from steppingstone_tpu_torch.envs import vector
from steppingstone_tpu_torch.envs.stepper import _foot_bodies
from steppingstone_tpu_torch.envs.vector import VecEnv
from steppingstone_tpu_torch.physics import engine
from steppingstone_tpu_torch.physics.step_kernel import CONTROL_STEP
from steppingstone_tpu_torch.tracing import RECORDER

ENVS = {"walker3d": ("Walker3DStepperEnv-v0", "K2"), "cassie": ("CassieStepper-v1", "K2+K3")}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def card():
    """Skips the test on a host without a CUDA card: decided when the test
    runs, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fleet(name: str, envs: int, device, seed: int = 0):
    """(venv, state, obs, generator) of `name` on LargePlank, reset from the
    fleet's generator; the generator draws actions."""
    env = make_env(ENVS[name][0], device=device, plank_class="LargePlank")
    venv = VecEnv(env, envs, device=device, seed=seed)
    state, obs = venv.reset()
    return venv, state, obs, torch.Generator(device=device).manual_seed(seed + 1)


def _actions(venv, g):
    """Actions well past the policy's range: envs fall, and reset, often."""
    return 2.0 * torch.randn((venv.num_envs, venv.action_dim), generator=g,
                             device=venv.device)


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(vector._leaves(a), vector._leaves(b)))


# ----------------------------------------------------------------------
# on the CPU
# ----------------------------------------------------------------------

def test_eager_path_never_captures_on_the_cpu(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("captured on the CPU")
    for name in ("CUDAGraph", "graph", "Stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    venv, state, obs, g = _fleet("walker3d", 4, "cpu")
    RECORDER.start()
    try:
        for _ in range(3):
            state, out = venv.step(state, _actions(venv, g))
    finally:
        spans, counters = RECORDER.stop()
    assert venv._graph is None
    assert not any(k.startswith("env.graph") for k in counters)
    names = [s.name for s in spans]
    assert names.count("env.step") == names.count("physics.entry") == names.count("env.reset") == 3
    assert "env.graph.capture" not in names


def test_graph_key_follows_what_a_capture_depends_on():
    venv, state, obs, g = _fleet("walker3d", 4, "cpu")
    actions = _actions(venv, g)
    draws = venv.env.draw_step(state.cur, venv.generator)

    def key(env=venv.env, state=state, actions=actions, draws=draws):
        return vector._graph_key(env, vector._leaves((state, actions, draws)))

    base = key()
    assert key(state=state._replace(elapsed=state.elapsed.clone()),
               actions=actions + 1.0, draws=venv.env.draw_step(state.cur, venv.generator)) == base
    other = make_env(ENVS["walker3d"][0], device="cpu", plank_class="LargePlank")
    assert key(env=other) != base  # an equal config, but another object
    small, _ = venv.reset(terr.default_curriculum(batch=2))
    assert key(state=small, actions=actions[:2],
               draws=venv.env.draw_step(small.cur, venv.generator)) != base
    assert key(actions=actions.double()) != base
    assert key(draws=draws._replace(reset=draws.reset._replace(
        noise=draws.reset.noise[:, :-1]))) != base
    assert key(state=state._replace(elapsed=state.elapsed.int())) != base


@pytest.mark.parametrize("name", sorted(ENVS))
def test_graph_data_path_equals_the_step(name):
    """The state, actions and draws copied into aligned slots, the step run
    on the slots and its outputs copied out into fresh slots: the direct
    step's answers bit for bit, in tensors that share no storage with the
    input slots."""
    venv, state, obs, g = _fleet(name, 4, "cpu")
    for _ in range(3):
        actions = _actions(venv, g)
        draws = venv.env.draw_step(state.cur, venv.generator)
        args = (state, actions, draws)
        ins = vector._Slots(vector._leaves(args))
        views = ins.views(ins.buffers("cpu"))
        for (dt, start, _, _), v in zip(ins.place, views):
            assert start * v.element_size() % vector.ALIGN_BYTES == 0
        vector._copy(views, vector._leaves(args))
        s, a, d = vector._rebuild(args, iter(views))
        result = venv.env.step(s, a, draws=d)
        outs = vector._Slots(vector._leaves(result))
        copied = outs.views(outs.buffers("cpu"))
        vector._copy(copied, vector._leaves(result))
        copied = vector._rebuild(result, iter(copied))
        direct = venv.env.step(state, actions, draws=draws)
        assert _same(copied, direct)
        slots = {v.untyped_storage().data_ptr() for v in views}
        assert not slots & {x.untyped_storage().data_ptr() for x in vector._leaves(copied)}
        state = copied[0]


@pytest.mark.parametrize("name", sorted(ENVS))
def test_a_step_makes_no_tensor_from_host_data(name, monkeypatch):
    """After a fleet's first step, a step and the value grid's candidate
    observations make no tensor from host data (on the card each such call
    copies from the host and syncs). The plain physics stands in for the
    kernel on the CPU and is left out."""
    venv, state, obs, g = _fleet(name, 4, "cpu")
    state, _ = venv.step(state, _actions(venv, g))
    venv.create_temp_states(state)
    calls, plain = [], [False]

    def counted(fn, label):
        def wrapper(*a, **k):
            if not plain[0]:
                calls.append(label)
            return fn(*a, **k)
        return wrapper

    scan = engine._step_scan

    def plain_scan(*a, **k):
        plain[0] = True
        try:
            return scan(*a, **k)
        finally:
            plain[0] = False

    monkeypatch.setattr(engine, "_step_scan", plain_scan)
    for mod, attr in ((torch, "tensor"), (torch, "as_tensor"), (torch, "from_numpy"),
                      (torch.Tensor, "new_tensor")):
        monkeypatch.setattr(mod, attr, counted(getattr(mod, attr), attr))
    for _ in range(2):
        state, _ = venv.step(state, _actions(venv, g))
    venv.create_temp_states(state)
    monkeypatch.undo()
    assert calls == []


def test_constants_are_made_once():
    dev = torch.device("cpu")
    assert terr._constant("yaw", dev) is terr._constant("yaw", dev)
    assert torch.equal(terr._constant("pitch", dev), torch.as_tensor(terr.PITCH_SAMPLES))
    assert terr._constant(terr.R_MIN, dev) is terr._constant(terr.R_MIN, dev)
    u = torch.rand(5, 3)
    hi = terr.R_MIN + (terr.R_MAX - terr.R_MIN) * torch.rand(5, 1)
    lo_t = torch.as_tensor(terr.R_MIN, dtype=torch.float32)
    assert torch.equal(terr._uniform(u, terr.R_MIN, hi),
                       torch.maximum(lo_t, u * (hi - lo_t) + lo_t))
    q = qt.normalize(torch.randn(7, 4))
    qt.inv(q)
    sign = qt._CONJUGATE[(q.dtype, q.device)]
    assert torch.equal(qt.inv(q), q * q.new_tensor([1.0, -1.0, -1.0, -1.0]))
    assert qt._CONJUGATE[(q.dtype, q.device)] is sign
    env = make_env(ENVS["walker3d"][0], device="cpu")
    assert env._feet.tolist() == list(_foot_bodies(env.cfg.model))


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

STEPS = 160


@pytest.mark.card
@pytest.mark.parametrize("name, envs", [("walker3d", 1024), ("walker3d", 16), ("cassie", 1024)])
def test_graphed_trajectory_equals_eager_on_the_card(card, name, envs):
    """160 control steps with resets: every output of every step of the
    graphed fleet equals `StepperEnv.step` called eagerly on the same
    state, actions and draws, bit for bit; the tensors a step returned and
    the ones it was given are unchanged after the next step."""
    venv, state, obs, g = _fleet(name, envs, torch.device("cuda"), seed=3)
    eager_state, graphed, eager, kept = state, [], [], []
    for t in range(STEPS):
        actions = _actions(venv, g)
        draws = venv.env.draw_step(state.cur, venv.generator)
        given = [x.clone() for x in vector._leaves((state, actions, draws))]
        result = venv.step(state, actions, draws)
        graphed.append(result)
        kept.append([x.clone() for x in vector._leaves(result)])
        eager_state, e_out = venv.env.step(eager_state, actions, draws=draws)
        eager.append((eager_state, e_out))
        assert all(torch.equal(x, y) for x, y in
                   zip(vector._leaves((state, actions, draws)), given)), t
        state = result[0]
    torch.cuda.synchronize()
    assert venv._graph.graph is not None
    for t, (a, b, k) in enumerate(zip(graphed, eager, kept)):
        assert _same(a, b), t
        assert all(torch.equal(x, y) for x, y in zip(vector._leaves(a), k)), t
    done = torch.stack([out.done for _, out in graphed])
    hits = torch.stack([out.hit for _, out in graphed])
    assert int(done.sum()) > 0 and int(hits.sum()) > 0


@pytest.mark.card
def test_one_capture_and_a_launch_a_step_on_the_card(card):
    venv, state, obs, g = _fleet("cassie", 256, torch.device("cuda"))
    before = dict(CONTROL_STEP.launches)
    RECORDER.start()
    try:
        for _ in range(12):
            state, out = venv.step(state, _actions(venv, g))
        torch.cuda.synchronize()
    finally:
        spans, counters = RECORDER.stop()
    after = CONTROL_STEP.launches
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert launched == {ENVS["cassie"][1]: 12}
    assert counters["env.graph.captures"] == 1
    assert counters["env.graph.replays"] == 12 - vector.GRAPH_WARMUP_STEPS
    names = [s.name for s in spans]
    assert names.count("env.step") == 12 and names.count("env.graph.capture") == 1
    # the spans inside the step: the warm-up steps' and the capture's
    assert names.count("physics.entry") == names.count("env.reset") == (
        vector.GRAPH_WARMUP_STEPS + 1)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(ENVS))
def test_replayed_step_makes_no_host_sync_on_the_card(card, name):
    venv, state, obs, g = _fleet(name, 1024, torch.device("cuda"))
    for _ in range(vector.GRAPH_WARMUP_STEPS + 2):
        state, out = venv.step(state, _actions(venv, g))
    actions = [_actions(venv, g) for _ in range(5)]
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for a in actions:
            state, out = venv.step(state, a)
            venv.create_temp_states(state)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert bool(torch.isfinite(out.obs).all())


@pytest.mark.card
def test_new_batch_size_or_config_captures_again_on_the_card(card):
    venv, state, obs, g = _fleet("walker3d", 16, torch.device("cuda"))
    RECORDER.start()
    try:
        for _ in range(vector.GRAPH_WARMUP_STEPS + 2):
            state, _ = venv.step(state, _actions(venv, g))
        first = venv._graph
        small, _ = venv.reset(terr.default_curriculum(batch=8, device=venv.device))
        a = _actions(venv, g)[:8]
        d = venv.env.draw_step(small.cur, venv.generator)
        for _ in range(vector.GRAPH_WARMUP_STEPS + 2):
            small, out = venv.step(small, a, d)
        second = venv._graph
        venv.env = make_env(ENVS["walker3d"][0], device=venv.device, plank_class="LargePlank")
        for _ in range(vector.GRAPH_WARMUP_STEPS + 2):
            state, _ = venv.step(state, _actions(venv, g))
        torch.cuda.synchronize()
    finally:
        _, counters = RECORDER.stop()
    assert counters["env.graph.captures"] == 3
    assert first is not second and venv._graph is not second
    assert first.args[0].phys.q.shape[0] == 16 and second.args[0].phys.q.shape[0] == 8
    assert venv._graph.key[0] is venv.env.cfg
