"""Each traffic mix driven through the port at a tiny size on the CPU,
where the port runs its plain control step, against the reference: every
answer right and the training numbers at rounding."""

import pytest

from tiny import cell, run

CELLS = ("walker3d_plank.train", "cassie_plank.train", "walker3d_plank.eval")


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_at_a_tiny_size(name):
    res = run(name)
    assert res["correct"], res["checks"]
    assert res["checks"]["answers_wrong"]["value"] == 0.0
    for k, c in res["checks"].items():
        assert c["value"] <= 1e-6, (k, c)
    assert set(res["metrics"]) == {m for m in res["metrics"]}  # end-to-end names only
    assert "setup_s" in res["metrics"] and list(res)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_per_layer_metrics_it_can(name):
    res = run(name, trace=True)
    # no device on the CPU: only the window's host-clock readings appear
    expected = {"walker3d_plank.eval": {"mfu.eval"}}.get(
        name, {"rollout_s.train", "ppo_step_ms.train", "mfu.train"})
    assert set(res["metrics"]) == expected
    assert res["device"]["busy_s"] == 0.0


def test_same_seed_same_inputs_other_seed_other_inputs():
    a, b = run("walker3d_plank.train", seed=5), run("walker3d_plank.train", seed=5)
    c = run("walker3d_plank.train", seed=6)
    assert a["detail"]["losses"] == b["detail"]["losses"] != c["detail"]["losses"]


def test_eval_records_only_the_drawn_entries(monkeypatch):
    from benchmark.harness import system
    from benchmark.kinds import eval as eval_kind
    c = cell("walker3d_plank.eval")
    recorded = []
    active = system.Recorder.active

    def counting(self):
        recorded.append(1)
        return active(self)
    monkeypatch.setattr(system.Recorder, "active", counting)
    seed = 2 ** 31 + 17
    res = run("walker3d_plank.eval", seed=seed, c=c)
    drawn = eval_kind.sampled_entries(seed, c.traffic["levels"], c.traffic["check_rounds"])
    assert res["detail"]["entries"] == sorted(drawn) and len(recorded) == len(drawn)
    assert {k % 3 for k in drawn} == {0, 1, 2} and max(drawn) < 3 * c.traffic["check_rounds"]


def test_learning_rate_decays_as_the_reference_trainer_does():
    from benchmark.harness.cell import lr_at
    c = cell("cassie_plank.train").config
    assert lr_at(c, 0) == c["lr"] and lr_at(c, 2) == pytest.approx(c["lr"] * 0.99 ** 2)
    assert lr_at(c, 10 ** 4) == c["lr_final"]
