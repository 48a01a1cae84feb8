"""The PPO update's static-buffer step and its CUDA graph
(steppingstone_tpu_torch/agents/ppo.py).

On the CPU, at Walker3D's and Cassie's widths (one critic and two, mirror
on, the KL guard firing on the first minibatch, full and value-only): the
step over buffers, run eagerly through a whole `ppo_update` (the mirror
image made once an update beside the batch), gives bit for bit the
parameters, Adam state and metrics of the loop it replaced (kept below as
`previous_update`: each minibatch mirrored, the optimizer in tensor ops);
so does the step on rows given to it (the sharded path's); the returned
AdamState shares no storage with the step's buffers; the CPU and the
sharded paths never capture; the graph's key changes with each thing a
capture depends on; the mirror's constants are made once.

Card-marked (skipped without a card; on the card:
`python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_ppo_graph.py -m card`):
over two updates of 1,024 envs x 100 steps with mirror, the graph path's
parameters, Adam state and metrics equal the eager path's, and the
previous loop's (the plain optimizer's), bit for bit, for Walker3D and
Cassie; one capture and a replay for every minibatch step after the
warm-up, one `adam_step` launch a step and one in the graph; no host sync
in a second update; new parameter storage captures again.
"""

import copy

import numpy as np
import pytest
import torch

from steppingstone_tpu_torch import span_probe
from steppingstone_tpu_torch.agents import distributions as dist
from steppingstone_tpu_torch.agents import mirror as tmirror
from steppingstone_tpu_torch.agents import ppo
from steppingstone_tpu_torch.agents.mirror import MirrorSpec
from steppingstone_tpu_torch.agents.networks import ActorCritic, clamped_logstd, project_logstd
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.parallel.mesh import SINGLE, Mesh
from steppingstone_tpu_torch.physics import step_kernel
from steppingstone_tpu_torch.tracing import RECORDER

MODELS = {"walker3d": ("Walker3DStepperEnv-v0", 1), "cassie": ("CassieStepper-v1", 2)}
LR = 3e-4


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


# ----------------------------------------------------------------------
# the loop `ppo_update` ran before its step read static buffers, as it was
# ----------------------------------------------------------------------

def _previous_mirror_array(x, neg, right, left):
    sign = np.ones(x.shape[-1], dtype=np.float32)
    sign[neg] = -1.0
    perm = np.arange(x.shape[-1])
    perm[np.concatenate([right, left])] = perm[np.concatenate([left, right])]
    return x[..., torch.as_tensor(perm, device=x.device)] * torch.as_tensor(sign, device=x.device)


def _previous_mirror_minibatch(spec, mb):
    out = {}
    for k, v in mb.items():
        if k == "obs":
            out[k] = torch.cat([v, _previous_mirror_array(v, spec.neg_obs, spec.right_obs,
                                                          spec.left_obs)], dim=0)
        elif k == "actions":
            out[k] = torch.cat([v, _previous_mirror_array(v, spec.neg_act, spec.right_act,
                                                          spec.left_act)], dim=0)
        else:
            out[k] = torch.cat([v, v], dim=0)
    return out


def _previous_minibatch_step(policy, params, opt, cfg, mb, lr, value_only, m_global):
    if cfg.mirror is not None:
        mb = _previous_mirror_minibatch(cfg.mirror, mb)
    action_loss, value_loss, entropy, clip_frac, approx_kl = ppo._losses(policy, cfg, mb,
                                                                         m_global)
    total = value_loss * cfg.value_loss_coef
    if not value_only:
        total = total + action_loss
        total = total - entropy * cfg.entropy_coef
    grads = torch.autograd.grad(total, params, allow_unused=True)
    g = torch.cat([(torch.zeros_like(p) if gr is None else gr).reshape(-1)
                   for p, gr in zip(params, grads)])
    value_loss, action_loss, clip_frac, approx_kl = (
        value_loss.detach(), action_loss.detach(), clip_frac, approx_kl.detach())
    gnorm = torch.sqrt(torch.sum(g * g))
    g = torch.where(gnorm < cfg.max_grad_norm, g, (g / gnorm) * cfg.max_grad_norm)
    mu = (1 - ppo.ADAM_B1) * g + ppo.ADAM_B1 * opt.mu
    nu = (1 - ppo.ADAM_B2) * (g * g) + ppo.ADAM_B2 * opt.nu
    count = opt.count + 1
    c = count.to(torch.float32)
    update = (mu / (1 - ppo.ADAM_B1 ** c)) / (torch.sqrt(nu / (1 - ppo.ADAM_B2 ** c)) + cfg.eps)
    step_lr = lr
    if cfg.kl_cutoff > 0.0 and not value_only:
        step_lr = torch.where(approx_kl > cfg.kl_cutoff, torch.zeros_like(lr), lr)
    with torch.no_grad():
        flat = torch.cat([p.reshape(-1) for p in params]) - step_lr * update
        for p, x in zip(params, flat.split([p.numel() for p in params])):
            p.copy_(x.view_as(p))
    project_logstd(policy)
    metrics = ppo.PPOMetrics(value_loss, action_loss, entropy.detach(), gnorm, clip_frac,
                             approx_kl)
    return ppo.AdamState(count, mu, nu), metrics


def previous_update(policy, opt_state, cfg, batch, lr, value_only, perms):
    """One process's `ppo_update` before the static-buffer step."""
    mbs = batch["obs"].shape[0] // cfg.num_mini_batch
    lr = torch.as_tensor(lr, dtype=torch.float32, device=batch["obs"].device)
    params = list(policy.parameters())
    history = []
    for epoch in range(cfg.ppo_epoch):
        for rows in perms[epoch].view(cfg.num_mini_batch, mbs):
            mb = {k: v[rows] for k, v in batch.items()}
            opt_state, m = _previous_minibatch_step(policy, params, opt_state, cfg, mb, lr,
                                                    value_only, mbs)
            history.append(m)
    return opt_state, ppo.PPOMetrics(*(torch.stack(x).mean() for x in zip(*history)))


# ----------------------------------------------------------------------

def _case(model: str, device, rows: int = 64, epochs: int = 2, minibatches: int = 4,
          seed: int = 0):
    """(policy, cfg, batch, perms) at `model`'s widths on `device`: actions
    near the policy's mean, log-probs its own with a little noise, and the
    first minibatch's log-probs 0.5 nats off, so that the KL guard fires
    there and not on every minibatch."""
    env_name, critics = MODELS[model]
    env = make_env(env_name, device=device)
    cfg = ppo.PPOConfig(ppo_epoch=epochs, num_mini_batch=minibatches, kl_cutoff=0.12,
                        mirror=MirrorSpec.from_env(env))
    policy = ActorCritic(env.observation_dim, env.action_dim, critics, device=device,
                         generator=torch.Generator().manual_seed(seed))
    g = torch.Generator(device=device).manual_seed(seed + 1)
    randn = lambda *shape: torch.randn(shape, generator=g, device=device)
    obs = randn(rows, env.observation_dim)
    with torch.no_grad():
        mean = policy.action_mean(obs)
        actions = mean + 0.2 * randn(rows, env.action_dim)
        log_probs = dist.log_prob(mean, clamped_logstd(policy), actions)
    batch = dict(obs=obs, actions=actions, log_probs=log_probs + 0.02 * randn(rows, 1),
                 values=randn(rows, 1), returns=randn(rows, 1), adv=randn(rows, 1))
    used = rows // minibatches * minibatches
    perms = torch.stack([torch.randperm(rows, generator=g, device=device)[:used]
                         for _ in range(epochs)])
    batch["log_probs"][perms[0, :rows // minibatches]] += 0.5
    return policy, cfg, batch, perms


def _second_update_start(model, device, **sizes):
    """A case whose Adam moments and count are nonzero: one update already
    applied (the previous loop's)."""
    policy, cfg, batch, perms = _case(model, device, **sizes)
    opt, _ = previous_update(policy, ppo.init_optimizer(policy), cfg, batch, LR, False,
                             perms.flip(1))
    return policy, opt, cfg, batch, perms


def _assert_same(a, b):
    """Two (policy, AdamState, PPOMetrics) bit for bit."""
    for (name, p), q in zip(a[0].named_parameters(), b[0].parameters()):
        assert torch.equal(p, q), name
    for f, x, y in zip(ppo.AdamState._fields, a[1], b[1]):
        assert x.dtype == y.dtype and torch.equal(x, y), f
    for f, x, y in zip(ppo.PPOMetrics._fields, a[2], b[2]):
        assert x.shape == y.shape and torch.equal(x, y), f


@pytest.mark.parametrize("value_only", [False, True], ids=["full", "value_only"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_static_step_equals_the_previous_loop(model, value_only, monkeypatch):
    """The update over the folded batch (the mirror image made once an
    update, each step gathering its rows of both) equals the loop that
    mirrored every minibatch, bit for bit."""
    policy, opt, cfg, batch, perms = _second_update_start(model, "cpu")
    other = copy.deepcopy(policy)
    before = [p.detach().clone() for p in policy.parameters()]
    o_prev, m_prev = previous_update(policy, opt, cfg, batch, LR, value_only, perms)
    mirrored = []
    monkeypatch.setattr(ppo, "mirror_minibatch", lambda spec, b: mirrored.append(
        b["obs"].shape) or tmirror.mirror_minibatch(spec, b))
    o_new, m_new = ppo.ppo_update(other, opt, cfg, batch, LR, value_only=value_only,
                                  perms=perms)
    assert mirrored == [batch["obs"].shape]  # the whole batch, once an update
    _assert_same((policy, o_prev, m_prev), (other, o_new, m_new))
    assert int(o_new.count) == 2 * cfg.ppo_epoch * cfg.num_mini_batch
    assert all(not torch.equal(a, b) for a, b in zip(before, other.parameters()))
    if not value_only:
        # the first minibatch's drift lifts the mean past cutoff / steps
        steps = cfg.ppo_epoch * cfg.num_mini_batch
        assert float(m_new.approx_kl) > cfg.kl_cutoff / steps


@pytest.mark.parametrize("model", sorted(MODELS))
def test_given_rows_fold_the_mirror_as_the_row_order(model):
    """The step on rows given to it (the sharded path's: each rank's local
    rows of a minibatch) gathers those rows and the same rows of the batch's
    mirror image: bit for bit the step that reads the row order."""
    policy, opt, cfg, batch, perms = _second_update_start(model, "cpu")
    other = copy.deepcopy(policy)
    steps, mbs = cfg.ppo_epoch * cfg.num_mini_batch, batch["obs"].shape[0] // cfg.num_mini_batch
    ordered = ppo._StepBuffers(policy, cfg, batch, False, steps, mbs, SINGLE)
    given = ppo._StepBuffers(other, cfg, batch, False, steps, mbs, SINGLE)
    ordered.load(batch, perms, opt, LR)
    given.load(batch, None, opt, LR)
    assert given.batch["obs"].shape[0] == 2 * batch["obs"].shape[0]
    for rows in perms.reshape(steps, mbs):
        ordered.step(policy)
        given.step(other, rows)
    _assert_same((policy, *ordered.result()), (other, *given.result()))


def test_returned_adam_state_shares_no_storage():
    """The AdamState returned is a copy: the buffers' next writes leave it,
    and the state passed in, as they were."""
    policy, opt, cfg, batch, perms = _second_update_start("cassie", "cpu")
    given = tuple(x.clone() for x in opt)
    buffers = ppo._StepBuffers(policy, cfg, batch, False, cfg.ppo_epoch * cfg.num_mini_batch,
                               batch["obs"].shape[0] // cfg.num_mini_batch, SINGLE)
    buffers.load(batch, perms, opt, LR)
    buffers.step(policy)
    state, metrics = buffers.result()
    mine = {buffers.count.data_ptr(), buffers.mu.data_ptr(), buffers.nu.data_ptr(),
            buffers.history.data_ptr()}
    assert not mine & {x.untyped_storage().data_ptr() for x in (*state, *metrics)}
    kept = tuple(x.clone() for x in state)
    buffers.step(policy)
    assert all(torch.equal(a, b) for a, b in zip(state, kept))
    assert all(torch.equal(a, b) for a, b in zip(opt, given))
    assert int(buffers.count) == int(state.count) + 1 == int(given[0]) + 2
    # through ppo_update as well: the state handed back is not the one given
    # and the one given is unchanged
    out, _ = ppo.ppo_update(policy, opt, cfg, batch, LR, perms=perms)
    assert all(torch.equal(a, b) for a, b in zip(opt, given))
    assert not {x.data_ptr() for x in out} & {x.data_ptr() for x in opt}


@pytest.mark.parametrize("world", [1, 2], ids=["cpu", "ranks"])
def test_eager_paths_never_capture(world, monkeypatch):
    """On the CPU, in one process or as one rank of two (collectives the
    identity without a process group), no graph is made or counted."""
    def refuse(*a, **k):
        raise AssertionError("captured on an eager path")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    policy, cfg, batch, perms = _case("walker3d", "cpu", rows=64)
    mesh = Mesh(rank=0, world=world)
    local = {k: v[:v.shape[0] // world] for k, v in batch.items()}
    g = torch.Generator().manual_seed(2)
    perms = torch.stack([torch.randperm(64, generator=g) for _ in range(cfg.ppo_epoch)])
    RECORDER.start()
    try:
        ppo.ppo_update(policy, ppo.init_optimizer(policy), cfg, local, LR, perms=perms,
                       mesh=mesh, num_envs=64 // world // 8)
    finally:
        spans, counters = RECORDER.stop()
    assert not any(k.startswith("ppo.graph") for k in counters)
    assert policy not in ppo._GRAPHS
    names = [s.name for s in spans]
    steps = cfg.ppo_epoch * cfg.num_mini_batch
    assert names.count("ppo.minibatch") == names.count("ppo.forward") == steps
    assert "ppo.graph.capture" not in names


@pytest.mark.parametrize("device, mesh, captures", [
    ("cuda", SINGLE, True), ("cpu", SINGLE, False), ("cuda", Mesh(rank=1, world=2), False),
    ("cuda", Mesh(rank=0, world=2, distributed=True), False),
    ("cuda", Mesh(rank=0, world=1, distributed=True), False)])
def test_capture_only_on_a_card_in_one_process(device, mesh, captures):
    assert ppo._captures(torch.device(device), mesh) is captures


def test_graph_key_follows_what_a_capture_depends_on():
    policy, cfg, batch, _ = _case("walker3d", "cpu", rows=16)
    key = ppo._graph_key(policy, cfg, batch, False)
    assert ppo._graph_key(policy, cfg, {k: v.clone() for k, v in batch.items()}, False) == key
    assert ppo._graph_key(policy, cfg, batch, True) != key
    assert ppo._graph_key(policy, ppo.PPOConfig(**{f: getattr(cfg, f) for f in (
        "ppo_epoch", "num_mini_batch", "kl_cutoff", "mirror")}), batch, False) != key
    assert ppo._graph_key(policy, cfg, dict(batch, obs=batch["obs"][:8]), False) != key
    assert ppo._graph_key(policy, cfg, dict(batch, adv=batch["adv"].double()), False) != key
    with torch.no_grad():
        policy.logstd.add_(1.0)  # in place: the same storage, the same graph
    assert ppo._graph_key(policy, cfg, batch, False) == key
    policy.logstd.data = policy.logstd.data.clone()
    assert ppo._graph_key(policy, cfg, batch, False) != key


def test_mirror_constants_made_once():
    spec = MirrorSpec.from_env(make_env("CassieStepper-v1", device="cpu"))
    x = torch.randn(5, 51)
    a = tmirror._constants(spec.neg_obs, spec.right_obs, spec.left_obs, 51, x.device)
    tmirror.mirror_obs(spec, x)
    b = tmirror._constants(spec.neg_obs, spec.right_obs, spec.left_obs, 51, x.device)
    assert a[0] is b[0] and a[1] is b[1]
    assert torch.equal(tmirror.mirror_obs(spec, x),
                       _previous_mirror_array(x, spec.neg_obs, spec.right_obs, spec.left_obs))
    u = torch.randn(5, 10)
    assert torch.equal(tmirror.mirror_act(spec, u),
                       _previous_mirror_array(u, spec.neg_act, spec.right_act, spec.left_act))


def test_span_probe_reads_no_replay_on_the_cpu():
    r = span_probe.train_probe("walker3d", torch.device("cpu"), num_processes=4,
                               episode_steps=8, mini_batch_size=4, num_frames=8, ppo_epoch=1)
    assert r["metrics"]["graph_replays_per_ppo_step"] == 0


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

def _eager(policy, opt, cfg, batch, perms, value_only=False):
    """The eager path on the card: the same step over the same buffers,
    never captured."""
    steps = cfg.ppo_epoch * cfg.num_mini_batch
    buffers = ppo._StepBuffers(policy, cfg, batch, value_only, steps,
                               batch["obs"].shape[0] // cfg.num_mini_batch, SINGLE)
    buffers.load(batch, perms, opt, LR)
    for _ in range(steps):
        buffers.step(policy)
    return buffers.result()


@pytest.mark.card
@pytest.mark.parametrize("model", sorted(MODELS))
def test_graph_update_equals_eager_on_the_card(card, model):
    """Two updates of 1,024 envs x 100 steps in 1,024-row minibatches, 10
    epochs, mirror on: the replayed graph's parameters, Adam state and
    metrics equal the eager step's bit for bit after each."""
    dev = torch.device("cuda")
    policy, cfg, batch, perms = _case(model, dev, rows=102_400, epochs=10, minibatches=100)
    graphed, opt_g = copy.deepcopy(policy), ppo.init_optimizer(policy)
    opt_e = ppo.init_optimizer(policy)
    for i in range(2):
        p = perms.roll(i, dims=1)
        opt_e, m_e = _eager(policy, opt_e, cfg, batch, p)
        opt_g, m_g = ppo.ppo_update(graphed, opt_g, cfg, batch, LR, perms=p)
        torch.cuda.synchronize()
        _assert_same((policy, opt_e, m_e), (graphed, opt_g, m_g))
    assert ppo._GRAPHS[graphed][False].graph is not None


@pytest.mark.card
@pytest.mark.parametrize("model", sorted(MODELS))
def test_kernel_update_equals_the_plain_optimizer_on_the_card(card, model):
    """Two updates of 1,024 envs x 100 steps in 1,024-row minibatches, 10
    epochs, mirror on, the KL guard firing: the captured step with the
    folded mirror and `adam_step` gives bit for bit the parameters, Adam
    state and metrics of the previous loop on the card (each minibatch
    mirrored, the optimizer in tensor ops)."""
    dev = torch.device("cuda")
    policy, cfg, batch, perms = _case(model, dev, rows=102_400, epochs=10, minibatches=100)
    graphed, opt_g = copy.deepcopy(policy), ppo.init_optimizer(policy)
    opt_p = ppo.init_optimizer(policy)
    for i in range(2):
        p = perms.roll(i, dims=1)
        opt_p, m_p = previous_update(policy, opt_p, cfg, batch, LR, False, p)
        opt_g, m_g = ppo.ppo_update(graphed, opt_g, cfg, batch, LR, perms=p)
        torch.cuda.synchronize()
        _assert_same((policy, opt_p, m_p), (graphed, opt_g, m_g))
    assert ppo._GRAPHS[graphed][False].adam_launched == 1


@pytest.mark.card
def test_one_capture_and_a_replay_a_step_on_the_card(card):
    dev = torch.device("cuda")
    policy, cfg, batch, perms = _case("walker3d", dev, rows=8192, epochs=2, minibatches=8)
    steps = cfg.ppo_epoch * cfg.num_mini_batch
    opt = ppo.init_optimizer(policy)
    adam_before = step_kernel.ADAM_STEP.launches
    RECORDER.start()
    try:
        for _ in range(2):
            opt, _ = ppo.ppo_update(policy, opt, cfg, batch, LR, perms=perms)
        torch.cuda.synchronize()
    finally:
        spans, counters = RECORDER.stop()
    assert counters["ppo.graph.captures"] == 1
    assert counters["ppo.graph.replays"] == 2 * steps - ppo.GRAPH_WARMUP_STEPS
    # adam_step: one launch a step, warm-up and replays alike; the graph holds one
    assert step_kernel.ADAM_STEP.launches - adam_before == 2 * steps
    assert ppo._GRAPHS[policy][False].adam_launched == 1
    names = [s.name for s in spans]
    assert names.count("ppo.minibatch") == 2 * steps
    assert names.count("ppo.graph.capture") == 1
    # forward, backward and optimizer spans: the warm-up steps and the capture
    assert names.count("ppo.forward") == ppo.GRAPH_WARMUP_STEPS + 1
    second = [s for s in spans if s.name == "trainer.update"][1]
    assert sum(s.syncs for s in spans if s.call == second.call) == 0


@pytest.mark.card
def test_second_update_makes_no_host_sync_on_the_card(card):
    dev = torch.device("cuda")
    policy, cfg, batch, perms = _case("cassie", dev, rows=8192, epochs=2, minibatches=8)
    opt, _ = ppo.ppo_update(policy, ppo.init_optimizer(policy), cfg, batch, LR, perms=perms)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt, metrics = ppo.ppo_update(policy, opt, cfg, batch, 0.5 * LR, perms=perms.flip(1))
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert all(torch.isfinite(x).all() for x in metrics)


@pytest.mark.card
def test_new_parameter_storage_captures_again_on_the_card(card):
    dev = torch.device("cuda")
    policy, cfg, batch, perms = _case("walker3d", dev, rows=8192, epochs=2, minibatches=8)
    eager = copy.deepcopy(policy)
    opt_g = opt_e = ppo.init_optimizer(policy)
    RECORDER.start()
    try:
        opt_g, _ = ppo.ppo_update(policy, opt_g, cfg, batch, LR, perms=perms)
        first = ppo._GRAPHS[policy][False]
        for p in policy.parameters():
            p.data = p.data.clone()
        opt_g, m_g = ppo.ppo_update(policy, opt_g, cfg, batch, LR, perms=perms)
        torch.cuda.synchronize()
    finally:
        _, counters = RECORDER.stop()
    assert counters["ppo.graph.captures"] == 2
    assert ppo._GRAPHS[policy][False] is not first
    opt_e, _ = _eager(eager, opt_e, cfg, batch, perms)
    opt_e, m_e = _eager(eager, opt_e, cfg, batch, perms)
    _assert_same((eager, opt_e, m_e), (policy, opt_g, m_g))
