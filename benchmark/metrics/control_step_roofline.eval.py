"""control_step_roofline.eval: as control_step_roofline.train, over the
profiled entry's launches at the eval fleet's envs."""

from benchmark.harness.readers import roofline


def read(run):
    return roofline(run, "eval")
