"""BENCHMARK.json against the contract's shape: names, units, cells,
metrics and the files each name leads to."""

import json
import re

from benchmark.harness.manifest import BENCH, ROOT, Cell, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_units_and_keys():
    spec = manifest()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/configs/") and (ROOT / c["file"]).exists()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    assert len(json.dumps(spec)) < 64 * 1024


def test_every_metric_reads_in_cells_that_report_what_it_moves():
    spec = manifest()
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    for name in cells:
        cell = Cell(name)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert set(cell.limits["limits"])
        assert (BENCH / "kinds" / f"{cell.traffic['kind']}.py").exists()


def test_each_kind_is_found_by_name_and_each_config_names_its_reference_env():
    from benchmark.harness.cell import driver
    from benchmark.reference import stepper
    spec = manifest()
    for w in spec["workloads"]:
        assert callable(driver(Cell(w["name"]).traffic["kind"]))
    for c in spec["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert callable(getattr(stepper, config["reference_env"]))
