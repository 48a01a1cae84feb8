"""Learning-curve plotting from progress.csv files (port of
steppingstone_tpu/viz/plot_from_csv.py).

Fixes and re-designs the reference `playground/plot_from_csv.py` (whose
`common.plots` import is broken in the reference checkout, SURVEY.md §2):
same CLI shape — multiple load paths, column selection, regex grouping with
min/mean/max bands, smoothing.

Usage:
  python -m steppingstone_tpu_torch.viz.plot_from_csv --load_paths runs/a runs/b \
      --columns mean_rew test_mean_rew --smooth 2 \
      [--name_regex ".*__(.*)_run.*" --group 1] [--out curves.png]
"""

from __future__ import annotations

import argparse
import os
import re
from collections import defaultdict

import numpy as np


def smooth_series(y: np.ndarray, k: int) -> np.ndarray:
    if k <= 1 or y.size < 3:
        return y
    w = 2 * k + 1
    pad = np.pad(y, (k, k), mode="edge")
    kernel = np.ones(w) / w
    return np.convolve(pad, kernel, mode="valid")


def load_runs(paths):
    import pandas as pd

    runs = {}
    for p in paths:
        csv = p if p.endswith(".csv") else os.path.join(p, "progress.csv")
        if not os.path.exists(csv):
            print(f"skip {p}: no progress.csv")
            continue
        runs[p.rstrip("/")] = pd.read_csv(csv)
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--load_paths", nargs="+", required=True)
    ap.add_argument("--columns", nargs="+", default=["mean_rew"])
    ap.add_argument("--smooth", type=int, default=1)
    ap.add_argument("--name_regex", default=None)
    ap.add_argument("--group", type=int, default=None)
    ap.add_argument("--x", default="total_num_steps")
    ap.add_argument("--out", default=None, help="write png instead of showing")
    args = ap.parse_args(argv)

    import matplotlib
    if args.out:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    runs = load_runs(args.load_paths)
    if not runs:
        raise SystemExit("no runs found")

    # group runs by regex capture (reference --name_regex/--group)
    groups = defaultdict(list)
    for name, df in runs.items():
        g = name
        if args.name_regex and args.group is not None:
            m = re.match(args.name_regex, name)
            if m:
                g = m.group(args.group)
        groups[g].append(df)

    fig, axes = plt.subplots(
        1, len(args.columns), figsize=(6 * len(args.columns), 4), squeeze=False
    )
    for ci, col in enumerate(args.columns):
        ax = axes[0][ci]
        for g, dfs in sorted(groups.items()):
            xs = [df[args.x].to_numpy() for df in dfs if col in df]
            ys = [smooth_series(df[col].to_numpy(), args.smooth)
                  for df in dfs if col in df]
            if not ys:
                continue
            n = min(len(y) for y in ys)
            x = xs[0][:n]
            Y = np.stack([y[:n] for y in ys])
            (line,) = ax.plot(x, Y.mean(0), label=g)
            if len(ys) > 1:
                ax.fill_between(x, Y.min(0), Y.max(0), alpha=0.2,
                                color=line.get_color())
        ax.set_xlabel(args.x)
        ax.set_ylabel(col)
        ax.legend(fontsize=8)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    if args.out:
        fig.savefig(args.out, dpi=120)
        print(f"wrote {args.out}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
