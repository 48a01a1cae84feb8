"""mfu.threshold: the window's FLOPs (the training frames' as in
mfu.train, plus each value-grid round's actor, control steps and critic
on every candidate observation), counted from shapes, over the window's
time and the chip's peak at the precision the run computes in."""

from benchmark.harness.readers import mfu


def read(run):
    return mfu(run, "threshold")
