"""mfu.eval: as mfu.train, for the behavior evaluation (the actor's mean
and the control step an env-step)."""

from benchmark.harness.readers import mfu


def read(run):
    return mfu(run, "eval")
