"""grid_step_host_ms.threshold: milliseconds of one control step of the
value grid on the host, from the program's `value_grid.step` spans in the
curriculum call recorded with the span recorder on (after the traced
slice); None where the program has no such span."""

STEP = "trainer.curriculum/curriculum.value_grid/value_grid.step"


def read(run):
    t = getattr(run, "spans_on", {}).get(STEP) if run.kind == "threshold" else None
    return t["ns"] / t["n"] / 1e6 if t and t["n"] else None
