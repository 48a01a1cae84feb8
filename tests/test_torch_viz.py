"""Port parity, viz: steppingstone_tpu_torch.viz's `render`, `stats_hud`,
`value_grids` and `plot_from_csv` against the JAX package's on the same
inputs (an `enjoy` dump of the port on Walker3D LargePlank, with a value
grid, and two runs' progress.csv made from a seed), compared as decoded
pixel arrays, exactly; `fast_plot` through the cases of tests/test_viz.py
and against the JAX copy's axes placement. matplotlib is headless (Agg)
throughout."""

import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.image as mpimg
import numpy as np
import pytest
import torch

from steppingstone_tpu.viz import fast_plot as jfast
from steppingstone_tpu.viz import plot_from_csv as jcsv
from steppingstone_tpu.viz import render as jrender
from steppingstone_tpu.viz import stats_hud as jhud
from steppingstone_tpu.viz import value_grids as jgrids
from steppingstone_tpu_torch.agents.networks import ActorCritic
from steppingstone_tpu_torch.envs import make_env
from steppingstone_tpu_torch.runtime import enjoy
from steppingstone_tpu_torch.viz import fast_plot as tfast
from steppingstone_tpu_torch.viz import plot_from_csv as tcsv
from steppingstone_tpu_torch.viz import render as trender
from steppingstone_tpu_torch.viz import stats_hud as thud
from steppingstone_tpu_torch.viz import value_grids as tgrids


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """A port `enjoy` dump of one LargePlank episode that hits a stone (its
    value grid), and one with seven grids."""
    torch.set_num_threads(1)
    env = make_env("Walker3DStepperEnv-v0", device="cpu", plank_class="LargePlank")
    policy = ActorCritic(60, 21, 2, device="cpu", generator=torch.Generator().manual_seed(0))
    result = enjoy.run_episode(env, policy, 40, True, 0,
                               generator=torch.Generator().manual_seed(1))
    assert len(result["value_grids"]) == 1
    path = tmp_path_factory.mktemp("dump") / "traj.npz"
    enjoy.write_dump(str(path), result, env.cfg.model)
    grid = result["value_grids"][0]
    many = path.parent / "grids.npz"
    np.savez(many, value_grids=np.stack([grid + 0.1 * k for k in range(7)]))
    return path, many


def _pixels(path):
    return mpimg.imread(str(path))


def _same_image(a, b):
    pa, pb = _pixels(a), _pixels(b)
    assert pa.shape == pb.shape and pa.size > 0
    np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("args", [["--sheet", "4"], ["--sheet", "3", "--plank-hy", "1.5"]],
                         ids=["discs", "planks"])
def test_render_sheet_matches_jax(tmp_path, dump, args):
    for mod, name in ((jrender, "jax.png"), (trender, "port.png")):
        mod.main([str(dump[0]), "--out", str(tmp_path / name)] + args)
    _same_image(tmp_path / "jax.png", tmp_path / "port.png")


def test_render_gif(tmp_path, dump):
    trender.main([str(dump[0]), "--out", str(tmp_path / "traj.gif"), "--stride", "8"])
    assert (tmp_path / "traj.gif").stat().st_size > 0
    assert trender._edge_indices([str(n) for n in np.load(dump[0])["body_names"]]) == (
        jrender._edge_indices([str(n) for n in np.load(dump[0])["body_names"]]))


def test_stats_hud_matches_jax(tmp_path, dump):
    jhud.render_hud(str(dump[0]), str(tmp_path / "jax.png"))
    thud.main([str(dump[0]), "--out", str(tmp_path / "port.png")])
    _same_image(tmp_path / "jax.png", tmp_path / "port.png")


@pytest.mark.parametrize("which", [0, 1], ids=["episode", "seven"])
def test_value_grids_match_jax(tmp_path, dump, which):
    jgrids.main([str(dump[which]), "--out", str(tmp_path / "jax.png")])
    tgrids.main([str(dump[which]), "--out", str(tmp_path / "port.png")])
    _same_image(tmp_path / "jax.png", tmp_path / "port.png")
    with pytest.raises(SystemExit, match="no value grids"):
        tgrids.render(np.zeros((0, 11, 11)))


def test_plot_from_csv_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    header = ("iter,total_num_steps,fps,entropy,value_loss,action_loss,mean_rew,median_rew,"
              "min_rew,max_rew,test_mean_rew,test_median_rew,test_min_rew,test_max_rew")
    paths = []
    for run in ("exp__a_run1", "exp__a_run2", "exp__b_run1"):
        os.makedirs(tmp_path / run)
        rows = [header]
        for i in range(12):
            vals = rng.normal(100.0 * i, 10.0, size=11)
            rows.append(",".join([str(i + 1), str(4096 * (i + 1)), "1000"] + [f"{v:.4f}" for v in vals]))
        (tmp_path / run / "progress.csv").write_text("\n".join(rows) + "\n")
        paths.append(str(tmp_path / run))
    args = ["--load_paths", *paths, "--columns", "mean_rew", "test_mean_rew", "--smooth", "2",
            "--name_regex", ".*__(.*)_run.*", "--group", "1"]
    jcsv.main(args + ["--out", str(tmp_path / "jax.png")])
    tcsv.main(args + ["--out", str(tmp_path / "port.png")])
    _same_image(tmp_path / "jax.png", tmp_path / "port.png")
    y = rng.normal(size=20)
    np.testing.assert_array_equal(tcsv.smooth_series(y, 3), jcsv.smooth_series(y, 3))


# ---- fast_plot: tests/test_viz.py's cases on the port --------------------

def test_time_series_add_point_and_save(tmp_path):
    ts = tfast.TimeSeriesPlot(num_lines=2, names=["rew", "len"], title="t")
    for i in range(50):
        ts.add_point(np.sin(i / 5.0), line_num=0)
        ts.add_point(i * 0.1, line_num=1, redraw=(i % 10 == 0))
    x, y = ts._lines[0].get_data()
    assert len(x) == 50 and np.isfinite(y).all()
    # bounds only ever expand (CustomPanZoomCamera.expand_bounds analog)
    lo, hi = ts.ax.get_ylim()
    assert lo <= -0.99 and hi >= 4.9
    out = tmp_path / "ts.png"
    ts.savefig(out)
    assert out.stat().st_size > 0
    ts.close()


def test_scatter_update(tmp_path):
    sc = tfast.ScatterPlot(title="pts")
    pts = np.random.RandomState(0).randn(32, 2)
    sc.update(pts)
    assert sc._scat.get_offsets().shape == (32, 2)
    sc.update(pts[:4])
    assert sc._scat.get_offsets().shape == (4, 2)
    sc.savefig(tmp_path / "sc.png")
    sc.close()


def test_shared_figure_grid():
    root = tfast.Plot(nrows=1, ncols=2, title="grid")
    a = tfast.TimeSeriesPlot(parent=root, title="a")
    b = tfast.ScatterPlot(parent=root, title="b")
    a.add_point(1.0)
    b.update([[0.0, 1.0]])
    assert a.fig is root.fig and b.fig is root.fig
    root.close()


def test_shared_figure_placement_matches_jax(tmp_path):
    """The port places sibling widgets as the JAX copy does, including its
    recorded fault (ADVICE.md: each child counts cells from 0 over one
    column, so both siblings take cell (0, 0) of a 1 x 2 grid)."""
    placed = {}
    for name, mod in (("jax", jfast), ("port", tfast)):
        root = mod.Plot(nrows=1, ncols=2, title="grid")
        a = mod.TimeSeriesPlot(parent=root, title="a")
        b = mod.ScatterPlot(parent=root, title="b")
        placed[name] = [ax.get_position().bounds for ax in (a.ax, b.ax)]
        root.savefig(tmp_path / f"{name}.png")
        root.close()
    assert placed["port"] == placed["jax"]
    assert placed["port"][0] == placed["port"][1]
    _same_image(tmp_path / "jax.png", tmp_path / "port.png")
