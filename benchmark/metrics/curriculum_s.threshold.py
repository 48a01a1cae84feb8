"""curriculum_s.threshold: seconds of `Trainer.curriculum` (a value grid of
the eval fleet and its install) an update, from the benchmark's span
around it ended on a sync, averaged over the window's updates (each a
value-grid round)."""


def read(run):
    spans = run.spans.get("curriculum") if run.kind == "threshold" else None
    return sum(spans) / len(spans) if spans else None
