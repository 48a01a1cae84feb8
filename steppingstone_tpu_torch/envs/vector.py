"""Batched env API (port of steppingstone_tpu/envs/vector.py).

The whole fleet is one `EnvState` with a leading env axis on one device;
stepping N envs is one batched call into the env, whose physics is one
launch of kernel K1 on the card. The fleet's randomness comes from a
`torch.Generator` that the VecEnv owns, seeded at construction.

With a `mesh` of several ranks (parallel/mesh.py) a VecEnv holds this
rank's `num_envs // world` envs, the counterpart of the JAX VecEnv's
shard_map over the mesh: each rank steps its own shard, one kernel launch
at the local batch. Its reset and step draws are made at the global batch
from a generator seeded alike on every rank, and cut to the local rows.

On a CUDA device the whole `StepperEnv.step` (the mirror, the physics
entry and kernel, hit detection and resampling, the reward, termination
and the auto-reset computed for every env) is captured once as a CUDA
graph (`_GraphedStep`, after a few eager steps on a side stream) and
replayed for every later control step: the draws are made eagerly, as on
the CPU, and the state, actions and draws are copied into the graph's
static inputs; the outputs are copied out into fresh tensors, so that
nothing a call returns is written by a later one and nothing a caller
passes is written at all. The graph is kept per VecEnv and captured anew
when its key (`_graph_key`) changes; actions that require grad step
eagerly. On the CPU the same step runs eagerly. The arithmetic is the same
on every path.
"""

from __future__ import annotations

import torch

from steppingstone_tpu_torch import tracing
from steppingstone_tpu_torch.device import resolve_device
from steppingstone_tpu_torch.envs import terrain as terr
from steppingstone_tpu_torch.envs.stepper import (EnvState, EnvStepDraws, ResetDraws, StepperEnv,
                                                  create_temp_states)
from steppingstone_tpu_torch.parallel.mesh import SINGLE, Mesh
from steppingstone_tpu_torch.physics.step_kernel import CONTROL_STEP
from steppingstone_tpu_torch.tracing import span

GRAPH_WARMUP_STEPS = 3  # eager steps on a side stream before a capture (torch.cuda.graphs)
ALIGN_BYTES = 512       # a slot starts where the caching allocator starts a block


def _leaves(tree) -> list:
    """The tensors of a (nested) tuple of tensors, depth first."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(tree, leaves):
    """`tree`'s structure (tuples and NamedTuples) over the next tensors of
    the iterator `leaves`."""
    if isinstance(tree, tuple):
        parts = [_rebuild(t, leaves) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return next(leaves)


def _copy(dst: list, src: list) -> None:
    """dst[i] <- src[i], one foreach copy per dtype."""
    groups: dict = {}
    for d, s in zip(dst, src):
        pair = groups.setdefault(d.dtype, ([], []))
        pair[0].append(d)
        pair[1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


class _Slots:
    """Tensors of given shapes and dtypes laid out in one flat buffer per
    dtype, each at an offset of ALIGN_BYTES as a tensor of its own would
    be, so that a kernel takes on a slot the path it takes on a fresh
    tensor (vectorized loads depend on alignment, and with them the order
    of a reduction's sums)."""

    def __init__(self, like: list):
        self.place, self.size = [], {}
        for t in like:
            align = ALIGN_BYTES // t.element_size()
            start = -(-self.size.get(t.dtype, 0) // align) * align
            self.place.append((t.dtype, start, t.numel(), t.shape))
            self.size[t.dtype] = start + t.numel()

    def buffers(self, device) -> dict:
        return {dt: torch.empty(n, dtype=dt, device=device) for dt, n in self.size.items()}

    def views(self, buffers: dict) -> list:
        return [buffers[dt][start:start + n].view(shape) for dt, start, n, shape in self.place]


class _GraphedStep:
    """`StepperEnv.step` captured as one CUDA graph over static inputs: the
    first GRAPH_WARMUP_STEPS calls run the step eagerly on a side stream,
    the next captures it and replays it, every later call replays it. Each
    call is one real step: its inputs are copied into the static inputs
    and its outputs out of the graph into fresh tensors.

    `CONTROL_STEP.launches` counts what ran: an eager step its launch, a
    capture none, a replay the launches its graph holds. The spans inside
    the step (`env.reset`, `physics.entry`, `physics.launch`) are recorded
    in the warm-up and at the capture, not at a replay."""

    def __init__(self, key: tuple, env: StepperEnv, args: tuple):
        self.key, self.env, self.graph, self.warm = key, env, None, 0
        ins = _Slots(_leaves(args))
        self.in_leaves = ins.views(ins.buffers(env.device))
        self.args = _rebuild(args, iter(self.in_leaves))
        self.outs = self.tree = self.out_buffers = None
        self.launched: dict = {}
        self.side = torch.cuda.Stream(env.device)

    def _step(self) -> list:
        """The step on the static inputs: its outputs' tensors, depth first."""
        state, actions, draws = self.args
        result = self.env.step(state, actions, draws=draws)
        leaves = _leaves(result)
        if self.tree is None:
            self.outs = _Slots(leaves)
            self.tree = _rebuild(result, iter([None] * len(leaves)))
        return leaves

    def _fresh(self, buffers: dict):
        """The outputs in new tensors, from (a copy of) `buffers`."""
        return _rebuild(self.tree, iter(self.outs.views(buffers)))

    def __call__(self, leaves: list):
        """One step on `leaves`, the tensors of (state, actions, draws)."""
        _copy(self.in_leaves, leaves)
        if self.graph is None and self.warm < GRAPH_WARMUP_STEPS:
            main = torch.cuda.current_stream(self.env.device)
            self.side.wait_stream(main)
            with torch.cuda.stream(self.side):
                out = self._step()
            main.wait_stream(self.side)
            self.warm += 1
            buffers = self.outs.buffers(self.env.device)
            _copy(self.outs.views(buffers), out)
            return self._fresh(buffers)
        if self.graph is None:
            self.out_buffers = self.outs.buffers(self.env.device)
            before = dict(CONTROL_STEP.launches)
            graph = torch.cuda.CUDAGraph()
            # thread_local: a sync on this thread still fails the capture,
            # another thread's (a process group's watchdog) does not
            with span("env.graph.capture"), torch.cuda.graph(graph,
                                                             capture_error_mode="thread_local"):
                _copy(self.outs.views(self.out_buffers), self._step())
            self.launched = {k: n - before[k] for k, n in CONTROL_STEP.launches.items()
                             if n != before[k]}
            CONTROL_STEP.launches.update(before)  # the capture ran nothing
            self.graph = graph
            tracing.count("env.graph.captures")
        self.graph.replay()
        for k, n in self.launched.items():
            CONTROL_STEP.launches[k] += n
        tracing.count("env.graph.replays")
        return self._fresh({dt: b.clone() for dt, b in self.out_buffers.items()})


def _graph_key(env: StepperEnv, leaves: list) -> tuple:
    """What a captured step depends on and the code can observe: the env's
    config (by identity), its device, and the shape (the batch size among
    them) and dtype of every state, action and draw field (`leaves`)."""
    return (env.cfg, env.device, tuple((t.shape, t.dtype) for t in leaves))


class VecEnv:
    def __init__(self, env: StepperEnv, num_envs: int, device=None, seed: int = 0,
                 mesh: Mesh = SINGLE):
        """`num_envs` envs in all, `num_envs // mesh.world` of them here."""
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"env lives on {env.device}, VecEnv asked for {self.device}")
        if num_envs % mesh.world:
            raise ValueError(f"num_envs={num_envs} must divide over {mesh.world} ranks")
        self.env = env
        self.mesh = mesh
        self.num_envs = num_envs // mesh.world  # this rank's envs
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._graph: _GraphedStep | None = None

    @property
    def observation_dim(self):
        return self.env.observation_dim

    @property
    def action_dim(self):
        return self.env.action_dim

    def reset(self, cur: terr.CurriculumState | None = None, draws: ResetDraws | None = None):
        if cur is None:
            cur = terr.default_curriculum(batch=self.num_envs, device=self.device)
        if draws is None:
            draws = self.env.draw_reset(cur, self.generator, self.mesh)
        return self.env.reset(cur, draws=draws)

    def step(self, state: EnvState, actions: torch.Tensor, draws: EnvStepDraws | None = None):
        """One control step of the fleet: (new state, StepOut). On a CUDA
        device a replay of the fleet's captured step (see the module)."""
        with span("env.step"):
            if draws is None:
                draws = self.env.draw_step(state.cur, self.generator, self.mesh)
            if self.device.type != "cuda" or actions.requires_grad:
                return self.env.step(state, actions, draws=draws)
            args = (state, actions, draws)
            leaves = _leaves(args)
            key = _graph_key(self.env, leaves)
            if self._graph is None or self._graph.key != key:
                self._graph = None  # the old graph and its pool go before the new ones come
                self._graph = _GraphedStep(key, self.env, args)
            return self._graph(leaves)

    def create_temp_states(self, state: EnvState) -> torch.Tensor:
        """(num_envs, GRID * GRID, obs_dim) candidate observations."""
        return create_temp_states(self.env.cfg, state)

    def set_mirror(self, state: EnvState, enabled: bool) -> EnvState:
        return self.env.set_mirror(state, enabled)

    def set_env_params(self, state: EnvState, params: dict) -> EnvState:
        return self.env.set_env_params(state, params)

    def set_robot_params(self, state: EnvState, params: dict) -> EnvState:
        return self.env.set_robot_params(state, params)

    def update_curriculum(self, state: EnvState, level, assist=None) -> EnvState:
        return self.env.update_curriculum(state, level, assist)

    def update_assist(self, state: EnvState, assist) -> EnvState:
        return self.env.update_assist(state, assist)

    def update_specialist(self, state: EnvState, k) -> EnvState:
        return self.env.update_specialist(state, k)

    def update_sample_prob(self, state: EnvState, prob) -> EnvState:
        """prob: one (GRID, GRID) grid, normalized and broadcast to every env."""
        return self.env.update_sample_prob(state, prob)
