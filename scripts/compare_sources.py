#!/usr/bin/env python3
"""Two builds of the control-step kernels against each other on one NVIDIA
GPU: the same inputs through each, outputs compared bit for bit, and each
build's time per launch taken in turns (baseline, source, source,
baseline).

    python3 scripts/compare_sources.py --baseline PATH [--source PATH]
        [--variants K1,K2] [--batches 4096,1000]

`--source` defaults to the package's csrc/control_step.cu; `--baseline` is
another version of it, such as the parent commit's (unpacked with `git
archive`) or one with other launch bounds. Both must take the arguments of
`control_step_launch` that physics/step_kernel.py passes. `--variants`
takes any of the eight (K1, K2, K3, K2+K3, K4, K2+K4, K3+K4, K2+K3+K4);
each runs on the inputs chip_smoke.py checks it on. Prints ptxas's
registers, stack frame and spills of both builds, then one JSON line per
variant and batch; exits non-zero if any output differs in any bit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from steppingstone_tpu_torch.physics import engine, step_kernel

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--source", default=str(step_kernel.SOURCE))
    ap.add_argument("--variants", default="K1,K2")
    ap.add_argument("--batches", default="4096,1000")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_sources: no CUDA device is available", file=sys.stderr)
        return 2
    print("card:", cs.card_line(), flush=True)
    builds = {"baseline": step_kernel.ControlStepKernel(source=Path(args.baseline)),
              "source": step_kernel.ControlStepKernel(source=Path(args.source))}
    for name, kern in builds.items():
        print(f"build {name} ({kern.source}): {kern.build():.2f} s", flush=True)
        cs.print_ptxas(kern.build_log)
    same = True
    for variant in args.variants.split(","):
        env = cs.variant_env(variant)
        model, pd = env.cfg.model, step_kernel.VARIANTS[variant][0]
        for batch in (int(b) for b in args.batches.split(",")):
            inputs, kw = cs.kernel_inputs(env, batch, seed=batch)
            soa = step_kernel.to_kernel_layout(*inputs)
            pd_kw = dict(target_t=kw["target"].t().contiguous(), power=kw["power"]) if pd else {}
            run = lambda kern: kern.launch(model, *soa, env.cfg.contact, engine.SUBSTEPS,
                                           support_hy=kw.get("support_hy"), **pd_kw)
            outs = {name: run(kern) for name, kern in builds.items()}
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(outs["baseline"], outs["source"]))
            max_diff = max(float((a - b).abs().max())
                           for a, b in zip(outs["baseline"], outs["source"]))
            turns = [cs.cuda_ms(lambda: run(builds[name]), cs.TIMED_LAUNCHES)
                     for name in ("baseline", "source", "source", "baseline")]
            print(json.dumps(dict(variant=variant, batch=batch, bit_equal=equal,
                                  max_abs_diff=max_diff,
                                  baseline_ms=(turns[0] + turns[3]) / 2,
                                  source_ms=(turns[1] + turns[2]) / 2, turns_ms=turns)),
                  flush=True)
            same &= equal
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
