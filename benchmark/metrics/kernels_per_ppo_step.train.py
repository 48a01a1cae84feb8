"""kernels_per_ppo_step.train: device kernels launched inside the
profiled `Trainer.update`, per minibatch step."""

from benchmark.harness.readers import kernels_per_step


def read(run):
    return kernels_per_step(run, "train", "update", "slice_minibatch_steps")
