"""device_idle_share.threshold: the share of the profiled iteration's wall
time (the curriculum, the rollout, the update) in which no operation ran
on the device."""

from benchmark.harness.readers import idle_share


def read(run):
    return idle_share(run, "threshold")
