"""Curriculum sampling-probability inspector (port of
steppingstone_tpu/viz/sampling_prob.py).

Loads the pickled list of 11 x 11 sampling-probability grids that
threshold and adaptive sampling runs write (`save_sampling_prob=True`)
and plots their evolution; `render_grid` draws one grid, as the training
loop does under `plot_prob=True`. numpy and matplotlib only.

Usage:
  python -m steppingstone_tpu_torch.viz.sampling_prob runs/exp/<env>_sampling_prob.pkl \
      [--out probs.png] [--cells 5,5 0,0]
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def render_grid(prob: np.ndarray, out_path: str):
    """One 11 x 11 grid -> heatmap PNG (headless analog of the reference's
    live window)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4.5, 4))
    im = ax.pcolormesh(np.asarray(prob), shading="auto")
    ax.set_xlabel("pitch index")
    ax.set_ylabel("yaw index")
    ax.set_title("stone sampling probability")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("pkl")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cells", nargs="*", default=["5,5", "0,0", "10,10"],
                    help="grid cells to plot over time, as 'yaw_i,pitch_j'")
    args = ap.parse_args(argv)

    import matplotlib
    if args.out:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(args.pkl, "rb") as f:
        probs = np.asarray(pickle.load(f))  # (K, 11, 11)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for cell in args.cells:
        i, j = (int(v) for v in cell.split(","))
        ax1.plot(probs[:, i, j], label=f"yaw[{i}], pitch[{j}]")
    ax1.set_xlabel("evaluation round")
    ax1.set_ylabel("sampling probability")
    ax1.legend(fontsize=8)
    ax1.grid(alpha=0.3)

    im = ax2.pcolormesh(probs[-1], shading="auto")
    ax2.set_title("final grid (yaw x pitch)")
    fig.colorbar(im, ax=ax2)
    fig.tight_layout()
    if args.out:
        fig.savefig(args.out, dpi=120)
        print(f"wrote {args.out}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
