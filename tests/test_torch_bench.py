"""The port's measurement entry points on the CPU: steppingstone_tpu_torch/
bench.py against bench.py's shape, and steppingstone_tpu_torch/
update_probe.py against scripts/update_probe.py's grid, both read from
the JAX scripts with `ast` (neither is imported or run); then each run at
a tiny size on the CPU (the plain control step, no launch), its JSON
lines checked field by field."""

import ast
import json
from pathlib import Path

import pytest
import torch

from steppingstone_tpu_torch import bench, update_probe
from steppingstone_tpu_torch.runtime.train import Trainer

ROOT = Path(__file__).resolve().parent.parent
CONSTANTS = ("NUM_ENVS", "ROLLOUT_CHUNK", "ROLLOUT_REPEATS", "TRAIN_STEPS", "TRAIN_REPEATS")
FIELDS = ("metric", "value", "unit", "rollout_only_steps_per_s", "seconds_per_iteration",
          "phase_breakdown_s", "update_matmul_flops_per_frame_assumed",
          "update_achieved_flops_per_s_est", "vs_h100_fp32_peak_67tf", "card", "launches",
          "matmul_precision", "train_timed_s")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tree(path: str) -> ast.Module:
    return ast.parse((ROOT / path).read_text(), filename=path)


def _constants(tree: ast.Module) -> dict:
    """Module-level names bound to literals, tuple targets unpacked."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
            try:
                value = ast.literal_eval(value)
            except ValueError:
                continue
            if isinstance(target, ast.Name):
                out[target.id] = value
            elif isinstance(target, ast.Tuple):
                out.update(zip((t.id for t in target.elts), value))
    return out


def _function(tree: ast.Module, name: str) -> ast.FunctionDef:
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _eval(node: ast.expr, names: dict):
    return eval(compile(ast.Expression(node), "<bench.py>", "eval"), {"max": max}, names)


def test_bench_constants_match_bench_py():
    jax_bench = _constants(_tree("bench.py"))
    assert {k: getattr(bench, k) for k in CONSTANTS} == {k: jax_bench[k] for k in CONSTANTS}
    assert (bench.NUM_ENVS, bench.TRAIN_STEPS) == (4096, 100)


def test_bench_config_matches_bench_py():
    """bench.py's `mini` rule and its TrainConfig keywords, evaluated as
    bench.py evaluates them on a GPU backend (no mesh), equal the port's
    config at bench.py's shape and at other sizes."""
    main = _function(_tree("bench.py"), "main")
    mini_rule = next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
                     and isinstance(n.targets[0], ast.Name) and n.targets[0].id == "mini")
    call = next(n for n in ast.walk(main) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "TrainConfig")
    for n_envs, steps in ((4096, 100), (256, 8), (8, 4), (1024, 400)):
        frames = n_envs * steps
        mini = _eval(mini_rule, {"frames": frames})
        assert bench.minibatch_rows(frames) == mini
        names = dict(n_envs=n_envs, steps=steps, frames=frames, mini=mini, backend="gpu")
        want = {kw.arg: _eval(kw.value, names) for kw in call.keywords}
        cfg = bench.bench_config(n_envs, steps)
        assert {k: getattr(cfg, k) for k in want} == want
        assert want["use_mirror"] is True and want["num_tests"] == 0
        assert want["mesh_devices"] == 0
    cfg = bench.bench_config(bench.NUM_ENVS, bench.TRAIN_STEPS)
    assert (cfg.num_steps, cfg.mini_batch_size, cfg.num_mini_batch, cfg.num_updates) == (
        100, 4096, 100, 1)


@pytest.mark.parametrize("kwargs", [{}, dict(obs_dim=51, act_dim=10, ensembles=2),
                                    dict(mirror=1, epochs=4, hidden=128)],
                         ids=["walker3d", "cassie-2-critics", "no-mirror"])
def test_flops_per_frame_matches_bench_py(kwargs):
    namespace = {}
    exec(compile(ast.Module([_function(_tree("bench.py"), "_flops_per_frame")], []),
                 "bench.py", "exec"), namespace)
    assert bench._flops_per_frame(**kwargs) == namespace["_flops_per_frame"](**kwargs)


def test_update_probe_grid_matches_jax_script():
    tree = _tree("scripts/update_probe.py")
    consts = _constants(tree)
    assert (update_probe.B, update_probe.OBS, update_probe.ACT) == (
        consts["B"], consts["OBS"], consts["ACT"])
    product = next(n for n in ast.walk(_function(tree, "main")) if isinstance(n, ast.Call)
                   and getattr(n.func, "attr", None) == "product")
    grid, mirrors = (ast.literal_eval(a) for a in product.args)
    assert (update_probe.GRID, update_probe.MIRRORS) == (grid, mirrors)


def test_bench_runs_on_the_cpu(capsys, monkeypatch):
    """8 envs x 4 steps, chunks of 2: one JSON line, the plain control step
    (no launch), `value` the frames over the timed seconds, each iteration
    Trainer.rollout then Trainer.update, timed in those halves."""
    calls = []
    for half in ("rollout", "update"):
        def spy(self, *args, _half=half, _fn=getattr(Trainer, half), **kw):
            calls.append(_half)
            return _fn(self, *args, **kw)
        monkeypatch.setattr(Trainer, half, spy)
    got = bench.run(8, 4, rollout_chunk=2, rollout_repeats=1, train_repeats=2, device="cpu")
    assert calls == ["rollout", "update"] * (bench.WARMUPS + 2)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == got
    assert all(k in got for k in FIELDS)
    assert got["value"] == 8 * 4 * 2 / got["train_timed_s"]
    assert got["rollout_only_steps_per_s"] == 8 * 2 * 1 / got["rollout_timed_s"]
    assert got["seconds_per_iteration"] == got["train_timed_s"] / 2
    assert got["unit"] == "env-steps/s" and "cpu" in got["metric"]
    assert got["launches"] == dict.fromkeys(got["launches"], 0) and "K1" in got["launches"]
    assert got["control_steps"] == (1 + 1) * 2 + (1 + 2) * 4
    assert got["card"] is None and got["vs_h100_fp32_peak_67tf"] is None
    assert got["minibatch_rows"] == 256 and got["num_mini_batch"] == 1
    # the halves, measured inside the timed window: each positive, their
    # sum an iteration's seconds less the loop's own
    split = got["phase_breakdown_s"]
    assert set(split) == {"rollout_incl_gae", "update"} and min(split.values()) > 0
    assert 0.9 * got["seconds_per_iteration"] <= sum(split.values()) <= got["seconds_per_iteration"]
    assert got["update_matmul_flops_per_frame_assumed"] == bench._flops_per_frame()
    assert set(got["matmul_precision"]) == {"cuda_matmul_allow_tf32", "cudnn_allow_tf32",
                                           "float32_matmul_precision"}


def test_update_probe_runs_on_the_cpu(capsys):
    got = update_probe.run(512, grid=(128, 256), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(x) for x in lines] == got
    assert [(g["mini"], g["mirror"]) for g in got] == [(128, True), (128, False), (256, True),
                                                      (256, False)]
    for g in got:
        assert g["num_mini_batch"] == 512 // g["mini"] and g["rows"] == 512
        assert g["minibatch_steps"] == 10 * g["num_mini_batch"]
        assert g["frames_per_s"] == 512 / g["seconds"]
        assert g["seconds_per_minibatch_step"] == g["seconds"] / g["minibatch_steps"]
        assert g["device"] == "cpu" and g["card"] is None


def test_synthetic_batch_is_seeded():
    a, b = (update_probe.synthetic_batch(64, "cpu") for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    g = torch.Generator().manual_seed(update_probe.SEED)
    obs, actions, adv = (torch.randn(shape, generator=g) for shape in ((64, 60), (64, 21),
                                                                       (64, 1)))
    assert torch.equal(a["obs"], obs) and torch.equal(a["actions"], actions * 0.1)
    assert torch.equal(a["adv"], adv)
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "obs": (64, 60), "actions": (64, 21), "log_probs": (64, 1), "values": (64, 1),
        "returns": (64, 1), "adv": (64, 1)}


def test_bench_and_probe_run_on_the_card_by_default():
    """No device means the card; without one both raise before any work."""
    if torch.cuda.is_available():
        return
    for fn in (bench.run, update_probe.run):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
