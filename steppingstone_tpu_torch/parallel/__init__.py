"""Env-axis data parallelism over torch.distributed ranks (port of steppingstone_tpu/parallel)."""
