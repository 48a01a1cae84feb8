"""BENCHMARK.json with the withheld four-card cell's entries added
(benchmark/withheld/) against the contract's shape: every cell asks for 1
or 4 cards, at most a quarter of the cells (at least one) for 4, a cell
on four cards measures what exists only across them (its kind runs
ranks), and every other contract check of test_bench_manifest.py's first
test, which asks every cell for one card; every metric reads in cells
that report what it moves."""

import json
import re

from benchmark.harness.manifest import BENCH, ROOT, Cell
from test_bench_ranks import with_withheld

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_units_and_keys_with_the_four_card_cell():
    spec = with_withheld()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/configs/") and (ROOT / c["file"]).exists()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    four = [w for w in spec["workloads"] if w["chips"] == 4]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    assert len(four) <= max(1, len(spec["workloads"]) // 4)
    for w in four:
        cell = Cell(w["name"], spec)
        assert cell.traffic["kind"] == "train_ranks" and cell.traffic["ranks"] == 4
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    assert len(json.dumps(spec)) < 64 * 1024

    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
