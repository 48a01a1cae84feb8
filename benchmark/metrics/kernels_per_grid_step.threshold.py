"""kernels_per_grid_step.threshold: device kernels launched inside the
profiled `Trainer.curriculum` (the grid fleet's reset, its control steps,
candidates, critic and sums, and the install), per control step of the
value grid."""

from benchmark.harness.readers import kernels_per_step


def read(run):
    return kernels_per_step(run, "threshold", "curriculum", "grid_steps")
