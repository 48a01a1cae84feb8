"""Offline stats HUD: value trace, per-joint action traces, foot strikes
(port of steppingstone_tpu/viz/stats_hud.py).

Re-design of the reference's live blitted-matplotlib `StatsVisualizer`
(`common/render_utils.py:8-255`: value trace on top, a grid of 21 per-joint
action axes labeled in the Walker3D joint order, foot-strike markers) as an
offline figure rendered from an `enjoy --dump` trajectory.

Usage:
  python -m steppingstone_tpu_torch.viz.stats_hud traj.npz --out hud.png
  python -m steppingstone_tpu_torch.viz.stats_hud traj.npz --out hud.png --follow 2

`--follow N` keeps the HUD live (reference `StatsVisualizer.update_plot`,
`render_utils.py:180`): it polls the npz every N seconds and re-renders
whenever the dump is rewritten (e.g. `enjoy --dump` refreshing the file).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("npz")
    ap.add_argument("--out", required=True)
    ap.add_argument("--follow", type=float, default=0.0, metavar="SECONDS",
                    help="live mode: poll the npz and re-render on change")
    args = ap.parse_args(argv)

    if args.follow > 0:
        import os
        import time

        last = None
        while True:
            try:
                mtime = os.path.getmtime(args.npz)
            except OSError:
                time.sleep(args.follow)
                continue
            if mtime != last:
                last = mtime
                try:
                    render_hud(args.npz, args.out)
                except (ValueError, KeyError, EOFError):
                    pass  # dump mid-rewrite; retry next poll
            time.sleep(args.follow)
    render_hud(args.npz, args.out)


def render_hud(npz_path, out_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.load(npz_path, allow_pickle=True)
    actions = data["actions"]            # (T, A)
    values = data["values"]              # (T,)
    rewards = data["rewards"]            # (T,)
    contacts = data["contacts"]          # (T, 2)
    joints = [str(j) for j in data["joint_names"]]
    T, A = actions.shape
    t = np.arange(T)

    cols = 3
    rows = 1 + (A + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 1.6 * rows),
                             facecolor="black")
    for ax in axes.flat:
        ax.set_facecolor("black")
        ax.tick_params(colors="#888", labelsize=6)
        for sp in ax.spines.values():
            sp.set_color("#555")

    # top row: value + reward + foot strikes (reference vf_axis)
    axv = axes[0][0]
    axv.plot(t, values, color="red", lw=1)
    axv.set_title("value", color="#ddd", fontsize=8)
    axr = axes[0][1]
    axr.plot(t, rewards, color="cyan", lw=1)
    axr.set_title("reward", color="#ddd", fontsize=8)
    axc = axes[0][2]
    for foot, (name, color) in enumerate(
        [("right", "tab:orange"), ("left", "tab:green")]
    ):
        strikes = np.where(
            contacts[1:, foot] & ~contacts[:-1, foot]
        )[0] + 1
        axc.eventplot(strikes, lineoffsets=foot, colors=color, linelengths=0.8)
    axc.set_title("foot strikes (R/L)", color="#ddd", fontsize=8)

    # per-joint action traces in model joint order (render_utils.py:47-69)
    act_dim = min(A, len(joints))
    for k in range(act_dim):
        ax = axes.flat[cols + k]
        ax.plot(t, actions[:, k], color="white", lw=0.8)
        ax.set_ylim(-1.2, 1.2)
        ax.set_title(joints[k], color="#aaa", fontsize=7)
    for k in range(cols + act_dim, rows * cols):
        axes.flat[k].axis("off")

    fig.tight_layout()
    fig.savefig(out_path, dpi=110, facecolor="black")
    plt.close(fig)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
