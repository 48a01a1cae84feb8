#!/usr/bin/env python3
"""Where control_step_warp<PD, PLANK, ROT> (all eight variants of kernels
K1..K4) spends its cycles, on one NVIDIA GPU.

    python3 scripts/kernel_sections.py [--batches 64,4096] [--source PATH]
        [--variants K1,K2,K3,K2+K3,K4,K2+K4,K3+K4,K2+K3+K4]

Builds, for this measurement only, a copy of the kernel source (default:
steppingstone_tpu_torch/csrc/control_step.cu) with clock64() stamps at
each `// ---- <section>` comment of control_step_warp's substep loop, at
the loop's start and end and at the kernel's end; each stamp first waits
for the warp (__syncwarp), and lane 0 adds the cycles since the last stamp
to its section's counter. Runs K1 (Walker3D torques over discs), K2
(Walker3D torques over LargePlank planks), K3 (Cassie stable PD over
discs), K2+K3 (Cassie stable PD over LargePlank planks), K4 (Walker3D
torques over discs with fixed joint rotations drawn from a seed), K2+K4
(the same over LargePlank planks), K3+K4 (Cassie stable PD over discs,
rotated alike) and K2+K3+K4 (the same over LargePlank planks) on the
inputs chip_smoke.py checks them on, at each batch size. Prints ptxas's
registers, stack frame and spills of the source as it is, then one JSON
line per kernel and batch: the mean cycles per warp and launch of each
section (the loop's sections summed over the substeps), their sum and
shares, the kernel's time per launch built from the source as it is and
stamped, and its resident envs per SM (the occupancy calculator). `--source` measures
another version of the kernel, such as one with other launch bounds.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LOOP = "  for (int sub = 0; sub < m.substeps; ++sub) {\n"
LOOP_END = "    __syncwarp();\n  }\n\n  for (int k = lane; k < NQ; k += 32) q_out"
READ = """
__device__ unsigned long long section_cycles[32];

extern "C" int section_cycles_read(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, section_cycles, sizeof(section_cycles));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zeros[32] = {0};
    err = cudaMemcpyToSymbol(section_cycles, zeros, sizeof(section_cycles));
  }
  return (int)err;
}
"""


def stamp(k: int) -> str:
    return ("    __syncwarp();\n    { const long long now_ = clock64();\n"
            f"      if (lane == 0) atomicAdd(section_cycles + {k}, "
            "(unsigned long long)(now_ - t_));\n      t_ = now_; }\n")


def stamped_source(src: str):
    """The source with control_step_warp's sections stamped, and the
    sections' names in counter order."""
    # from control_step_warp's template line to the first host function's
    start = src.rindex("template <", 0, src.index("control_step_warp(const __grid_constant__"))
    end = src.rindex("template <", 0, src.index("static cudaError_t warp_prepare("))
    body = src[start:end]
    names = ["set-up (loads, stone normals and axes)"]
    body = body.replace("  if (e >= B) return;  // the whole warp: no other warp waits on it\n",
                        "  if (e >= B) return;\n  long long t_ = clock64();\n", 1)
    loop_at = body.index(LOOP)
    head, loop = body[:loop_at], body[loop_at + len(LOOP):]
    head += stamp(0) + LOOP
    out, k = [], 0
    for line in loop.splitlines(keepends=True):
        m = re.match(r"    // ---- (.*?)[-\s]*$", line)
        if m and line.startswith("    // ---- "):
            if k:  # the previous section ends here
                out.append(stamp(k))
            k += 1
            names.append(m.group(1))
        out.append(line)
    loop = "".join(out)
    end_at = loop.index(LOOP_END)
    loop = loop[:end_at] + stamp(k) + loop[end_at:]
    tail_at = loop.rindex("\n}\n")
    loop = loop[:tail_at] + "\n" + stamp(k + 1) + loop[tail_at:].lstrip("\n")
    names.append("stores")
    return src[:start] + READ + head + loop + src[end:], names


def main(argv=None) -> int:
    import ctypes

    import torch

    import chip_smoke as cs
    from steppingstone_tpu_torch.physics import engine, step_kernel

    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="64,4096")
    ap.add_argument("--source", default=str(step_kernel.SOURCE))
    ap.add_argument("--variants", default="K1,K2,K3,K2+K3,K4,K2+K4,K3+K4,K2+K3+K4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_sections: no CUDA device is available", file=sys.stderr)
        return 2
    print("card:", cs.card_line(), flush=True)
    src = Path(args.source).read_text()
    text, names = stamped_source(src)
    with tempfile.TemporaryDirectory() as tmp:
        plain_src, stamped_src = Path(tmp) / "plain.cu", Path(tmp) / "stamped.cu"
        plain_src.write_text(src)
        stamped_src.write_text(text)
        plain = step_kernel.ControlStepKernel(source=plain_src)
        stamped = step_kernel.ControlStepKernel(source=stamped_src)
        for kern in (plain, stamped):
            kern.build()
    cs.print_ptxas(plain.build_log)
    read = stamped._lib.section_cycles_read
    read.restype, read.argtypes = ctypes.c_int, [ctypes.c_void_p, ctypes.c_int]
    counts = (ctypes.c_ulonglong * 32)()
    for variant in args.variants.split(","):
        env = cs.variant_env(variant)
        model, (pd, plank, rot) = env.cfg.model, step_kernel.VARIANTS[variant]
        envs_per_sm = plain.warp_envs_per_sm(model, env.cfg.n_stones, pd, plank, rot)
        for batch in (int(b) for b in args.batches.split(",")):
            inputs, kw = cs.kernel_inputs(env, batch, seed=batch)
            soa = step_kernel.to_kernel_layout(*inputs)
            pd_kw = dict(target_t=kw["target"].t().contiguous(), power=kw["power"]) if pd else {}
            run = lambda kern: kern.launch(model, *soa, env.cfg.contact, engine.SUBSTEPS,
                                           support_hy=kw.get("support_hy"), **pd_kw)
            ms = cs.cuda_ms(lambda: run(plain), cs.TIMED_LAUNCHES)
            stamped_ms = cs.cuda_ms(lambda: run(stamped), cs.TIMED_LAUNCHES)
            if read(counts, 1):
                raise RuntimeError("reading the section counters failed")
            run(stamped)
            torch.cuda.synchronize()
            if read(counts, 1):
                raise RuntimeError("reading the section counters failed")
            # cycles per warp and launch (one warp per env; lane 0 counts)
            sections = {name: counts[k] / batch for k, name in enumerate(names)}
            total = sum(sections.values())
            print(json.dumps(dict(variant=variant, batch=batch, ms=ms, stamped_ms=stamped_ms,
                                  envs_per_sm=envs_per_sm, cycles_per_warp=total,
                                  sections=sections,
                                  share={n: c / total for n, c in sections.items()})),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
