"""control_step_roofline.train: the control-step kernels' share of their
roofline in the profiled iteration: the least time of a launch at the
cell's envs (the larger of its operations over the fp32 peak and its
bytes over the HBM bandwidth) over the mean device time of a launch."""

from benchmark.harness.readers import roofline


def read(run):
    return roofline(run, "train")
