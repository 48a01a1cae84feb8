#!/usr/bin/env python3
"""What the CUDA compiler made of each section of control_step_warp<PD,
PLANK, ROT>, instantiation by instantiation, on a machine with nvcc.

    python3 scripts/sass_sections.py [--source PATH] [--variants K2,K2+K4]
        [--dump DIR]

Compiles the kernel source (default: steppingstone_tpu_torch/csrc/
control_step.cu) to a cubin with the package's nvcc flags plus -lineinfo
(source lines only: the optimised code is the same), prints ptxas's
registers, stack frame and spills, disassembles it with nvdisasm's line
information, and attributes every SASS instruction of each warp
instantiation to the section of control_step_warp it comes from (the
`// ---- <section>` comments of its substep loop, the set-up before the
loop and the stores after it; an inlined helper counts at its call site).
Prints one JSON line per variant: per section the static count of
instructions, of local-memory loads and stores (LDL / STL: the stack
frame, where spills live), of shared-memory loads and stores (LDS / STS)
and of global loads (LDG), and `lds_to_use`, the mean number of
instructions from a shared-memory load to the first instruction that reads
its result (within straight-line code: the fewer, the more of the load's
latency the warp waits out). Static counts, not cycles: a section's cycles
come from scripts/kernel_sections.py. `--dump DIR` also writes each
variant's SASS, every instruction behind its section's number, to
DIR/<variant>.sass.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

HEAD = "control_step_warp(const __grid_constant__"
LOOP = "  for (int sub = 0; sub < m.substeps; ++sub) {"
STORES = "  for (int k = lane; k < NQ; k += 32) q_out"
KINDS = ("LDL", "STL", "LDS", "STS", "LDG")
# instructions that end straight-line code
CONTROL = ("BRA", "BSYNC", "BSSY", "EXIT", "RET", "CALL", "WARPSYNC", "BAR")


def load_to_use(code):
    """Per section, the mean distance in instructions from each LDS to the
    first later instruction of the same straight-line code that reads its
    destination register; `code` is [(section, opcode, operands)]."""
    dist: dict = {}
    for i, (section, opcode, ops) in enumerate(code):
        if opcode != "LDS" or not ops:
            continue
        reg = ops[0]
        for j in range(i + 1, len(code)):
            _, op2, ops2 = code[j]
            if op2 in CONTROL:
                break
            if any(re.search(rf"(?<![\w.]){reg}(?![\w])", o) for o in ops2[1:]):
                dist.setdefault(section, []).append(j - i)
                break
            if ops2 and ops2[0] == reg:
                break
    return {sec: sum(d) / len(d) for sec, d in dist.items()}


def sections(src: str):
    """(first line, name) of each section of control_step_warp, in order,
    and the kernel's last line (1-based line numbers)."""
    lines = src.splitlines()
    first = next(i for i, l in enumerate(lines) if HEAD in l)
    loop = next(i for i in range(first, len(lines)) if lines[i].startswith(LOOP))
    stores = next(i for i in range(loop, len(lines)) if lines[i].startswith(STORES))
    last = next(i for i in range(stores, len(lines)) if lines[i] == "}")
    out = [(first + 1, "set-up (loads, stone normals and axes)")]
    for i in range(loop, stores):
        m = re.match(r"    // ---- (.*?)[-\s]*$", lines[i])
        if m:
            out.append((i + 1, m.group(1)))
    out.append((stores + 1, "stores"))
    return out, last + 1


def tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(path).exists():
        raise RuntimeError(f"{name} not found: the CUDA toolkit is needed")
    return path


def main(argv=None) -> int:
    import chip_smoke as cs
    from steppingstone_tpu_torch.physics import step_kernel

    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=str(step_kernel.SOURCE))
    ap.add_argument("--variants", default=",".join(step_kernel.VARIANTS))
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    source = Path(args.source).resolve()
    src = source.read_text()
    secs, last = sections(src)
    flags = [f for f in step_kernel.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "control_step.cubin"
        done = subprocess.run([tool("nvcc"), *flags, "-lineinfo", "-cubin", "-o", str(cubin),
                               str(source)], check=True, capture_output=True, text=True)
        cs.print_ptxas(done.stderr)
        sass = subprocess.run([tool("nvdisasm"), "-gi", "-c", str(cubin)], check=True,
                              capture_output=True, text=True).stdout
    names = {m: v for m, v in cs.mangled_names().items() if m.startswith("control_step_warp")}
    wanted = set(args.variants.split(","))
    counts: dict = {}
    dumps: dict = {}
    code: dict = {}
    variant, section = None, None
    for line in sass.splitlines():
        fn = re.search(r"\.text\.(_Z\w+)", line)
        if fn:
            variant = next((v for m, v in names.items() if m in fn.group(1)), None)
            section = None
            continue
        if variant not in wanted:
            continue
        if "//##" in line:
            # the outermost call site inside control_step_warp
            nums = [int(n) for n in re.findall(r"line (\d+)", line)]
            inside = [n for n in nums if secs[0][0] <= n <= last]
            section = None
            if inside:
                section = [name for start, name in secs if start <= inside[-1]][-1]
            continue
        op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)\S*", line)
        if op:
            name = section or "other"
            operands = [o.strip() for o in line[op.end():].split(";")[0].split(",")]
            code.setdefault(variant, []).append((name, op.group(1), operands))
            number = next((k for k, (_, n) in enumerate(secs) if n == name), -1)
            dumps.setdefault(variant, []).append(f"{number:3d} {line.strip()}")
            c = counts.setdefault(variant, {}).setdefault(name, Counter())
            c["instructions"] += 1
            if op.group(1) in KINDS:
                c[op.group(1)] += 1
    for v in [v for v in step_kernel.VARIANTS if v in counts]:
        total = sum((c for c in counts[v].values()), Counter())
        for sec, d in load_to_use(code[v]).items():
            counts[v][sec]["lds_to_use"] = round(d, 2)
        print(json.dumps(dict(variant=v, total=dict(total),
                              sections={s: dict(c) for s, c in counts[v].items()})), flush=True)
    if args.dump:
        Path(args.dump).mkdir(parents=True, exist_ok=True)
        for v, lines in dumps.items():
            (Path(args.dump) / f"{v}.sass").write_text("\n".join(lines) + "\n")
    missing = wanted - set(counts)
    if missing:
        print(f"sass_sections: no SASS found for {sorted(missing)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
