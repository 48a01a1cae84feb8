"""kernels_per_env_step.eval: device kernels launched in the profiled
entry from its first step on (the records' copy included, the reset
not), per control step."""

from benchmark.harness.readers import kernels_per_step


def read(run):
    return kernels_per_step(run, "eval", "steps", "slice_control_steps")
