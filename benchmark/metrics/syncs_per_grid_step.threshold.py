"""syncs_per_grid_step.threshold: host syncs inside one control step of
the value grid (its `value_grid.step` span and everything under it), as
the program's span recorder counts them, per step; None where the
program has no such span."""

STEP = "trainer.curriculum/curriculum.value_grid/value_grid.step"


def read(run):
    t = getattr(run, "spans_on", {}).get(STEP) if run.kind == "threshold" else None
    return t["syncs"] / t["n"] if t and t["n"] else None
