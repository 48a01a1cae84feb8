"""Offline trajectory renderer: .npz dumps -> animation / frames (port of
steppingstone_tpu/viz/render.py).

Replaces the reference's live PyBullet GUI + moviepy mp4 dump
(`playground/enjoy.py:348-377`, `common/render_utils.py`) with an offline
matplotlib renderer over the kinematic trajectories written by
`runtime/enjoy.py --dump` (either package's). Without ffmpeg on PATH the
output is an animated GIF (PillowWriter) or a PNG contact sheet.

Usage:
  python -m steppingstone_tpu_torch.viz.render traj.npz --out traj.gif [--fps 30]
  python -m steppingstone_tpu_torch.viz.render traj.npz --out sheet.png --sheet 12
"""

from __future__ import annotations

import argparse

import numpy as np

# skeleton edges by body name (drawn if both endpoints exist), with a
# capsule radius (m) so bodies render with their approximate geometry
# (reference shows solid capsule bodies in the PyBullet GUI)
_EDGES = [
    ("pelvis", "torso", 0.14),
    ("pelvis", "right_thigh", 0.09), ("right_thigh", "right_shin", 0.07),
    ("right_shin", "right_foot", 0.05),
    ("pelvis", "left_thigh", 0.09), ("left_thigh", "left_shin", 0.07),
    ("left_shin", "left_foot", 0.05),
    ("torso", "right_upper_arm", 0.05), ("right_upper_arm", "right_forearm", 0.04),
    ("torso", "left_upper_arm", 0.05), ("left_upper_arm", "left_forearm", 0.04),
    # cassie
    ("right_shin", "right_tarsus", 0.05), ("right_tarsus", "right_toe", 0.04),
    ("left_shin", "left_tarsus", 0.05), ("left_tarsus", "left_toe", 0.04),
]


def _edge_indices(names):
    idx = {n: i for i, n in enumerate(names)}
    out, seen = [], set()
    for a, b, r in _EDGES:
        if a in idx and b in idx and (idx[a], idx[b]) not in seen:
            seen.add((idx[a], idx[b]))
            out.append((idx[a], idx[b], r))
    return out


def make_writer(out: str, fps: int):
    """Pick a movie writer for the output extension: mp4/webm when an
    encoder is on PATH (reference dumps mp4 via moviepy,
    `playground/enjoy.py:370-377`), GIF via Pillow otherwise."""
    from matplotlib import animation

    if out.endswith((".mp4", ".webm", ".mkv")):
        if animation.FFMpegWriter.isAvailable():
            return animation.FFMpegWriter(fps=fps)
        raise SystemExit(
            f"{out!r} needs ffmpeg, which is not on PATH here — "
            "use a .gif output instead"
        )
    return animation.PillowWriter(fps=fps)


def draw_frame(ax, pos, edges, stones, stone_radius=0.25, plank_hy=None):
    ax.clear()
    if plank_hy is None:
        # stones as discs (top-down uses circles; side view uses lines)
        th = np.linspace(0, 2 * np.pi, 24)
        for s in stones:
            ax.plot(s[0] + stone_radius * np.cos(th),
                    s[1] + stone_radius * np.sin(th),
                    s[2] * np.ones_like(th), color="#888", lw=0.8)
    else:
        # planks: rectangles in the stone's heading frame
        for s in stones:
            c, sn = np.cos(s[3]), np.sin(s[3])
            corners = np.array([
                [sx * stone_radius, sy * plank_hy]
                for sx, sy in ((1, 1), (1, -1), (-1, -1), (-1, 1), (1, 1))
            ])
            xs = s[0] + c * corners[:, 0] - sn * corners[:, 1]
            ys = s[1] + sn * corners[:, 0] + c * corners[:, 1]
            ax.plot(xs, ys, s[2] * np.ones(5), color="#888", lw=0.8)
    # capsule-ish bodies: linewidth in points scaled from the capsule
    # radius (round caps close the capsule ends)
    for a, b, r in edges:
        ax.plot([pos[a, 0], pos[b, 0]], [pos[a, 1], pos[b, 1]],
                [pos[a, 2], pos[b, 2]], color="tab:blue",
                lw=max(2.0, 90.0 * r), alpha=0.85,
                solid_capstyle="round")
    ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], s=6, color="tab:red")
    c = pos[0]
    ax.set_xlim(c[0] - 2, c[0] + 2)
    ax.set_ylim(c[1] - 2, c[1] + 2)
    ax.set_zlim(c[2] - 1.5, c[2] + 1.5)
    ax.set_box_aspect((1, 1, 0.75))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("npz")
    ap.add_argument("--out", required=True)
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--stride", type=int, default=2)
    ap.add_argument("--sheet", type=int, default=0,
                    help="write a PNG contact sheet with N frames instead")
    ap.add_argument("--plank-hy", type=float, default=None,
                    help="draw stones as planks with this lateral half-extent")
    args = ap.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.load(args.npz, allow_pickle=True)
    pos = data["body_pos"]              # (T, NB, 3)
    names = [str(n) for n in data["body_names"]]
    stones = data["stones"]
    edges = _edge_indices(names)

    if args.sheet:
        n = min(args.sheet, pos.shape[0])
        steps = np.linspace(0, pos.shape[0] - 1, n).astype(int)
        cols = min(n, 4)
        rows = (n + cols - 1) // cols
        fig = plt.figure(figsize=(4 * cols, 3.2 * rows))
        for i, t in enumerate(steps):
            ax = fig.add_subplot(rows, cols, i + 1, projection="3d")
            draw_frame(ax, pos[t], edges, stones, plank_hy=args.plank_hy)
            ax.set_title(f"t={t}", fontsize=8)
        fig.tight_layout()
        fig.savefig(args.out, dpi=100)
        print(f"wrote {args.out}")
        return

    from matplotlib.animation import FuncAnimation

    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(projection="3d")
    frames = range(0, pos.shape[0], args.stride)

    def update(t):
        draw_frame(ax, pos[t], edges, stones, plank_hy=args.plank_hy)
        return []

    anim = FuncAnimation(fig, update, frames=frames, blit=False)
    anim.save(args.out, writer=make_writer(args.out, args.fps))
    print(f"wrote {args.out} ({len(list(frames))} frames)")


if __name__ == "__main__":
    main()
