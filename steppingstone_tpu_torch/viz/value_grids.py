"""Value-grid heatmap renderer (port of
steppingstone_tpu/viz/value_grids.py).

Offline analog of the reference's in-loop value plotting
(`playground/enjoy.py:234-316`): at every stone-hit event enjoy.py scores
all 11x11 candidate placements of the upcoming stone with the critic
ensemble and (reference) displays the heatmap live; our enjoy dumps those
grids into the trajectory .npz (`runtime/enjoy.py` `write_dump`) and this module
renders them as a contact-sheet PNG (one heatmap per stone-hit event, yaw
on the vertical axis, pitch on the horizontal, shared color scale).

Usage:
  python -m steppingstone_tpu_torch.viz.value_grids traj.npz [--out grids.png]
"""

from __future__ import annotations

import argparse

import numpy as np

from steppingstone_tpu_torch.envs import terrain as terr


def render(value_grids: np.ndarray, out_path: str | None = None,
           max_panels: int = 24):
    """(K, 11, 11) grids -> contact-sheet figure. Returns the figure."""
    import matplotlib

    if out_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grids = np.asarray(value_grids)
    if grids.ndim != 3 or grids.shape[0] == 0:
        raise SystemExit("no value grids in input (was enjoy run with a critic?)")
    k = min(grids.shape[0], max_panels)
    cols = min(k, 6)
    rows = (k + cols - 1) // cols
    vmin, vmax = float(grids[:k].min()), float(grids[:k].max())

    yaw_deg = np.rad2deg(terr.YAW_SAMPLES)
    pitch_deg = np.rad2deg(terr.PITCH_SAMPLES)
    fig, axes = plt.subplots(
        rows, cols, figsize=(2.6 * cols, 2.4 * rows), squeeze=False
    )
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        if i >= k:
            ax.axis("off")
            continue
        im = ax.pcolormesh(
            pitch_deg, yaw_deg, grids[i], vmin=vmin, vmax=vmax, shading="auto"
        )
        ax.set_title(f"step event {i}", fontsize=8)
        if i // cols == rows - 1:
            ax.set_xlabel("pitch (deg)", fontsize=7)
        if i % cols == 0:
            ax.set_ylabel("yaw (deg)", fontsize=7)
        ax.tick_params(labelsize=6)
    fig.colorbar(im, ax=axes, shrink=0.8, label="ensemble value")
    fig.suptitle("critic value over candidate next-stone placements")
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        print(f"wrote {out_path}")
    return fig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("npz", help="trajectory dump from runtime/enjoy.py --dump")
    ap.add_argument("--out", default=None)
    ap.add_argument("--max-panels", type=int, default=24)
    args = ap.parse_args(argv)

    data = np.load(args.npz)
    if "value_grids" not in data:
        raise SystemExit(f"{args.npz} has no 'value_grids' array")
    fig = render(data["value_grids"], args.out, args.max_panels)
    if not args.out:
        import matplotlib.pyplot as plt

        plt.show()


if __name__ == "__main__":
    main()
