"""kernels_per_env_step.train: device kernels launched inside the
profiled `Trainer.rollout`, per control step (bootstrap, GAE and
normalization included)."""

from benchmark.harness.readers import kernels_per_step


def read(run):
    return kernels_per_step(run, "train", "rollout", "slice_control_steps")
