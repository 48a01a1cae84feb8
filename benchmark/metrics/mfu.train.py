"""mfu.train: the window's FLOPs (the networks' matmuls in the rollout and
the update, the control steps), counted from shapes, over the window's
time and the chip's peak at the precision the run computes in."""

from benchmark.harness.readers import mfu


def read(run):
    return mfu(run, "train")
