"""What the benchmark may load, and that it refuses to run without a
card."""

import json
import subprocess
import sys

import torch

from benchmark.harness import guard
from benchmark.harness.manifest import ROOT


def test_guard_compares_whole_top_level_names():
    found = guard.forbidden(["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "optax",
                             "steppingstone_tpu", "steppingstone_tpu.envs",
                             "steppingstone_tpu_torch", "steppingstone_tpu_torch.envs", "jaxtyping",
                             "torch"])
    assert found == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla", "optax",
                     "steppingstone_tpu", "steppingstone_tpu.envs"]


def _modules_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, check=True, cwd=ROOT)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_port_or_jax():
    mods = _modules_after("import sys; sys.path.insert(0, '.')\n"
                          "import benchmark.reference.drivers, benchmark.reference.stepper")
    assert not [m for m in mods if m.split(".")[0] in
                ("steppingstone_tpu_torch", "steppingstone_tpu", "jax", "jaxlib", "flax", "optax")]


def test_reference_sources_import_nothing_of_the_port(tmp_path, monkeypatch):
    assert guard.reference_imports() == []
    (tmp_path / "bad.py").write_text("import steppingstone_tpu_torch.envs\nfrom jax import numpy\n")
    monkeypatch.setattr(guard, "REFERENCE", tmp_path)
    assert guard.reference_imports() == [("bad.py", "steppingstone_tpu_torch.envs"),
                                         ("bad.py", "jax")]


def test_harness_and_port_load_no_jax():
    mods = _modules_after("import sys; sys.path.insert(0, '.')\n"
                          "import benchmark.run, benchmark.control\n"
                          "from benchmark.harness import system; system.PortTrain, system.PortEval\n"
                          "import steppingstone_tpu_torch.runtime.train, "
                          "steppingstone_tpu_torch.runtime.behavior_eval")
    assert guard.forbidden(mods) == []


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "walker3d_plank.eval",
                          "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_fails_with_jax_loaded(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys)
    try:
        guard.check()
    except SystemExit as e:
        assert e.code != 0
    else:
        raise AssertionError("the guard let jax through")
