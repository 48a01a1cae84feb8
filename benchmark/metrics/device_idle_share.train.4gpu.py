"""device_idle_share.train.4gpu: the share of rank 0's profiled iteration's
wall time in which no operation ran on its card."""

from benchmark.harness.readers import idle_share


def read(run):
    return idle_share(run, "train_ranks")
