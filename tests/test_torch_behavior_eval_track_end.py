"""Port parity, behavior evaluation at the end of the track: the
specialist bands of tests/test_torch_behavior_eval.py on LargePlank, with
both packages' make_env giving a 3-stone track and 24-step episodes. The
untrained policies reach the last stone and fall after ~21 steps on the
full track, so here some episodes time out and some end at the track's
end inside the window, and the timeout and whole-track counts are held
to scripts/behavior_eval.py's (where the full track leaves them 0 == 0).
A file of its own, so that the test runner's per-file split spreads the
JAX script's compiles. Tolerances as in tests/test_torch_behavior_eval.py.
"""

from test_torch_behavior_eval import BANDS, compare_reports, runs  # noqa: F401 (fixture)

SHORT = {"n_stones": 3, "max_episode_steps": 24}


def test_report_matches_jax_script_at_track_end(runs, tmp_path, monkeypatch, capsys):
    compare_reports(runs, BANDS, SHORT, tmp_path, monkeypatch, capsys)
