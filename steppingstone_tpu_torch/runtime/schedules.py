"""LR schedules (own copy of steppingstone_tpu/runtime/schedules.py, the
reference's `common/misc_utils.py:20-32`)."""

from __future__ import annotations


def linear_decay(epoch: int, total_num_epochs: int, initial_value: float,
                 final_value: float = 0.0) -> float:
    return initial_value - (initial_value - final_value) * epoch / float(
        total_num_epochs
    )


def exponential_decay(epoch: int, rate: float, initial_value: float,
                      final_value: float = 0.0) -> float:
    return max(initial_value * (rate ** epoch), final_value)
