"""The benchmark of steppingstone_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json on the card(s) of this machine: set-up,
a timed window of `--seconds`, with `--trace 1` a profiled slice after
it, then the check against the plain reference in benchmark/reference.
Prints the numbers compared beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or
with --trace 1 its per-layer metrics), device, with --trace 1 breakdown,
and last the checks. Exits non-zero, printing no result, without enough
CUDA cards or if JAX or the JAX package is loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# the program's build and kernel caches stay inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "benchmark" / ".cache" / sub)
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host launches every kernel, so spare
# worker threads only contend with it
os.environ.setdefault("OMP_NUM_THREADS", "1")

import torch  # noqa: E402

from benchmark.harness import guard  # noqa: E402
from benchmark.harness.cell import Context, driver  # noqa: E402
from benchmark.harness.manifest import Cell  # noqa: E402
from benchmark.harness.trace import breakdown  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def require_cards(n: int) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {n} CUDA card(s), found {have}", file=sys.stderr, flush=True)
        raise SystemExit(2)


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, device="cuda", t0=T0,
        make_system=None) -> dict:
    """One run of `cell`; returns the result line's object."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(cell, seed, seconds, trace_on, device, t0, make_system)
    out = driver(cell.traffic["kind"])(ctx)
    limits = cell.limits["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in out.numbers.items()}
    correct = out.failed == 0 and all(v <= limits[k] for k, v in out.numbers.items())
    if trace_on:
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(out.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out.end_to_end, setup_s=out.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = torch.device(device)
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}}
    rec = out.record
    if trace_on and rec.slice is not None:
        result["device"]["busy_s"] = rec.slice.busy_s
        result["device"]["window_s"] = rec.slice.wall_s
        result["breakdown"] = breakdown(rec.slice)
    result["detail"] = out.detail
    result["checks"] = checks
    return result


def main(argv=None) -> None:
    args = parse(argv)
    guard.check()
    cell = Cell(args.workload)
    require_cards(cell.chips)
    result = run(cell, args.seed, args.seconds, bool(args.trace))
    guard.check()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
