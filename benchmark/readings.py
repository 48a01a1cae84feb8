"""Readings of the check on the chip for the threshold and train_ranks
kinds, at a cell's own size, judged by the same check as a run (the
counterpart of control.py for those kinds): "port" is the sound program,
"tf32" the control (the plain reference in the program's place, computed
in TF32, the precision below the float32 the configurations state), the
others the faults of harness/grid_faults.py (threshold) and
harness/ranks.py (train_ranks) planted in the port.

    python3 benchmark/readings.py --workload walker3d_thr150.threshold --seeds 1 2 3 \\
        --systems port tf32 event_mask_dropped [--seconds S]

Prints one JSON line per (system, seed) with the numbers compared. The
readings need no window (the default)."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import run as bench  # noqa: E402
from benchmark.harness import curriculum, grid_faults, ranks  # noqa: E402
from benchmark.harness.manifest import Cell  # noqa: E402

CONTROL, PORT = "tf32", "port"
SYSTEMS = {"threshold": (CONTROL, PORT, *grid_faults.FAULTS),
           "train_ranks": (CONTROL, PORT, *ranks.FAULTS)}


def plan(cell: Cell, name: str):
    """(the system a reading drives (None: the port), the fault planted in
    this process around the run)."""
    kind = cell.traffic["kind"]
    if name not in SYSTEMS[kind]:
        raise SystemExit(f"{name!r} is not a system of the {kind} kind: {SYSTEMS[kind]}")
    if name == PORT:
        return None, contextlib.nullcontext()
    if kind == "threshold":
        if name == CONTROL:
            return curriculum.RefThreshold, contextlib.nullcontext()
        return None, grid_faults.FAULTS[name]()
    if name == CONTROL:
        return ranks.RefTrainRanks, contextlib.nullcontext()
    # the ranks build their system in processes of their own: the fault goes with it
    return functools.partial(ranks.planted, name), contextlib.nullcontext()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--systems", nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=-1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    if args.device == "cuda":
        bench.require_cards(cell.chips)
    for name in args.systems:
        for seed in args.seeds:
            t = time.perf_counter()
            make_system, fault = plan(cell, name)
            with fault:
                res = bench.run(cell, seed, args.seconds, False, args.device, t,
                                make_system=make_system)
            print(json.dumps({"workload": cell.name, "system": name, "seed": seed,
                              "correct": res["correct"], "seconds": time.perf_counter() - t,
                              "checks": {k: v["value"] for k, v in res["checks"].items()},
                              "detail": res["detail"]}, default=str), flush=True)


if __name__ == "__main__":
    main()
