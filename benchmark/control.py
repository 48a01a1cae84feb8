"""Readings of the check on the chip, at a cell's own size, judged by the
same check as a run: "port" is the sound program, "tf32" the control
(the plain reference put in the program's place and computed in TF32,
the precision below the float32 the configurations state), the others
the faults of harness/faults.py planted in the port.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 \\
        --systems port tf32 half_batch altered [--seconds S]

Prints one JSON line per (system, seed) with the numbers compared, the
seeds of one process sharing its imports and the kernels' load.
Training readings need no window (the default); an eval cell's check
runs its drawn entries after a window of `--seconds`."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import contextlib  # noqa: E402

from benchmark import run as bench  # noqa: E402
from benchmark.harness import faults, system  # noqa: E402
from benchmark.harness.manifest import Cell  # noqa: E402

CONTROL, PORT = "tf32", "port"


def factory(cell: Cell, name: str):
    """The system a reading drives (None: the port)."""
    if name != CONTROL:
        return None
    return system.RefTrain if cell.traffic["kind"] == "train" else system.RefEval


def planted(cell: Cell, name: str):
    """The fault `name` planted in the port (nothing for the port itself
    or the control)."""
    if name in (CONTROL, PORT):
        return contextlib.nullcontext()
    c = cell.config
    every = (c["episode_steps"] // c["num_processes"] if cell.traffic["kind"] == "train"
             else cell.traffic["steps"])
    return faults.FAULTS[name](every)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--systems", nargs="+", choices=sorted({CONTROL, PORT, *faults.FAULTS}),
                    required=True)
    ap.add_argument("--seconds", type=float, default=-1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    if args.device == "cuda":
        bench.require_cards(cell.chips)
    for name in args.systems:
        for seed in args.seeds:
            t = time.perf_counter()
            with planted(cell, name):
                res = bench.run(cell, seed, args.seconds, False, args.device, t,
                                make_system=factory(cell, name))
            print(json.dumps({"workload": cell.name, "system": name, "seed": seed,
                              "correct": res["correct"], "seconds": time.perf_counter() - t,
                              "checks": {k: v["value"] for k, v in res["checks"].items()},
                              "detail": res["detail"]}), flush=True)


if __name__ == "__main__":
    main()
