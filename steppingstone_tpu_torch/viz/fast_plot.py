"""Lightweight live-plot widgets (port of steppingstone_tpu/viz/fast_plot.py,
faithful to it): the reference's vispy fast plots
(`common/plot_utils.py:60-263` — `Plot` grid, `TimeSeriesPlot.add_point`,
`ScatterPlot.update`, auto-expanding pan/zoom bounds), re-homed on
matplotlib so they work headless (Agg) on a training host as well as
interactively on a workstation.

Design notes (vs the reference):
- The vispy widgets exist for high-frequency redraws during live rollout
  visualisation; neither the reference's train.py nor enjoy.py imports
  them. Here the same API doubles as the offline artifact writer: call
  `savefig(path)` on any widget, or pass `live=True` for an interactive
  window when a display is attached.
- `add_point` is O(1) amortised (list append + periodic redraw), and
  bounds auto-expand exactly like `CustomPanZoomCamera.expand_bounds`
  (`plot_utils.py:39-57`): the view only ever grows, so a spiking series
  never makes the camera thrash.
"""

from __future__ import annotations

import math

import numpy as np

import matplotlib

if not matplotlib.get_backend().lower().startswith(("qt", "tk", "macosx")):
    matplotlib.use("Agg")
import matplotlib.pyplot as plt


class Plot:
    """A grid of subplots sharing one figure (reference `Plot`,
    `plot_utils.py:60-101`): subclass widgets claim cells with
    `_get_subplot`."""

    def __init__(self, nrows=1, ncols=1, parent=None, title=None,
                 live=False, figsize=None):
        if parent is not None:
            self.fig = parent.fig
            self._grid = parent._grid
            self._live = parent._live
        else:
            self.fig = plt.figure(
                figsize=figsize or (4.0 * ncols, 3.0 * nrows)
            )
            self._grid = self.fig.add_gridspec(nrows, ncols)
            self._live = bool(live)
            if title:
                self.fig.suptitle(title)
            if self._live:
                plt.ion()
                self.fig.show()
        self._next_cell = 0
        self.nrows, self.ncols = nrows, ncols

    def _get_subplot(self, row=None, col=None):
        if row is None or col is None:
            row, col = divmod(self._next_cell, self.ncols)
            self._next_cell += 1
        return self.fig.add_subplot(self._grid[row, col])

    def redraw(self):
        if self._live:
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()

    def savefig(self, path, dpi=110):
        self.fig.savefig(path, dpi=dpi, bbox_inches="tight")

    def close(self):
        plt.close(self.fig)


class _ExpandingBounds:
    """Monotone view bounds (reference `CustomPanZoomCamera.expand_bounds`,
    `plot_utils.py:39-57`)."""

    def __init__(self, ax):
        self.ax = ax
        self.xlim = None
        self.ylim = None

    def expand(self, x=None, y=None):
        def grow(lim, v):
            v = float(v)
            if not math.isfinite(v):
                return lim
            if lim is None:
                pad = max(abs(v) * 0.05, 1e-3)
                return [v - pad, v + pad]
            return [min(lim[0], v), max(lim[1], v)]

        if x is not None:
            self.xlim = grow(self.xlim, x)
            self.ax.set_xlim(*self.xlim)
        if y is not None:
            self.ylim = grow(self.ylim, y)
            self.ax.set_ylim(*self.ylim)


class TimeSeriesPlot(Plot):
    """Streaming line plot: `add_point(y, line_num)` appends one sample
    (reference `TimeSeriesPlot.add_point`, `plot_utils.py:104-196`)."""

    def __init__(self, num_lines=1, names=None, title=None, parent=None,
                 row=None, col=None, redraw_every=16, **kwargs):
        super().__init__(parent=parent, title=None if parent else title,
                         **kwargs)
        self.ax = self._get_subplot(row, col)
        if title and parent:
            self.ax.set_title(title)
        self._bounds = _ExpandingBounds(self.ax)
        self._ys = [[] for _ in range(num_lines)]
        names = names or [f"line {i}" for i in range(num_lines)]
        self._lines = [
            self.ax.plot([], [], lw=1.2, label=names[i])[0]
            for i in range(num_lines)
        ]
        if num_lines > 1:
            self.ax.legend(loc="upper left", fontsize=7)
        self._redraw_every = max(1, int(redraw_every))
        self._since_redraw = 0

    def add_point(self, y, line_num=0, redraw=False):
        ys = self._ys[line_num]
        ys.append(float(y))
        self._lines[line_num].set_data(np.arange(len(ys)), ys)
        self._bounds.expand(x=len(ys) - 1, y=ys[-1])
        self._since_redraw += 1
        if redraw or self._since_redraw >= self._redraw_every:
            self._since_redraw = 0
            self.redraw()


class ScatterPlot(Plot):
    """Replaceable 2D point cloud: `update(points)` swaps the full set
    (reference `ScatterPlot.update`, `plot_utils.py:198-263`)."""

    def __init__(self, title=None, parent=None, row=None, col=None,
                 size=8.0, **kwargs):
        super().__init__(parent=parent, title=None if parent else title,
                         **kwargs)
        self.ax = self._get_subplot(row, col)
        if title and parent:
            self.ax.set_title(title)
        self._bounds = _ExpandingBounds(self.ax)
        self._scat = self.ax.scatter([], [], s=size)

    def update(self, points, colors=None, redraw=True):
        pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
        self._scat.set_offsets(pts)
        if colors is not None:
            self._scat.set_color(colors)
        for x, y in pts[np.isfinite(pts).all(axis=1)]:
            self._bounds.expand(x=x, y=y)
        if redraw:
            self.redraw()
