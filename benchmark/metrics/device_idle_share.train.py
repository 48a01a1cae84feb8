"""device_idle_share.train: the share of the profiled iteration's wall time
in which no operation ran on the device."""

from benchmark.harness.readers import idle_share


def read(run):
    return idle_share(run, "train")
