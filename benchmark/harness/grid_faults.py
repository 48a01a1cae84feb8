"""Faults planted in the port's value-based curriculum underneath a run of
the threshold kind, to show that its check sees them (benchmark/tests)
and to read them at the cell's own size on the card
(benchmark/readings.py). Each is a context manager that patches the port
and restores it.

- "event_mask_dropped": the value grid sums every env's candidate values
  on every step, not only those of the envs that moved to a new stone.
- "candidate_one_short": the candidates of the next-next stone are placed
  from the stone two before it, not the one before it.
- "stale_probs": threshold sampling installs the probabilities of the
  grid before (uniform before the first) in place of the new grid's."""

from __future__ import annotations

import contextlib

import torch

from benchmark.harness.faults import _patched


class _Module:
    """A module's stand-in that passes every name through but those it
    overrides."""

    def __init__(self, module, **overrides):
        self._module, self._overrides = module, overrides

    def __getattr__(self, name):
        return self._overrides.get(name, getattr(self._module, name))


def event_mask_dropped():
    from steppingstone_tpu_torch.runtime import curriculum as curr

    def where(cond, a, b):
        return torch.where(torch.ones_like(cond), a, b)
    return _patched(curr, "torch", _Module(torch, where=where))


def candidate_one_short():
    from steppingstone_tpu_torch.envs import stepper
    terr = stepper.terr

    def candidate_stones(terrain, index):
        return terr.candidate_stones(terrain, index - 1)
    return _patched(stepper, "terr", _Module(terr, candidate_stones=candidate_stones))


@contextlib.contextmanager
def stale_probs():
    from steppingstone_tpu_torch.runtime import curriculum as curr
    original, previous = curr.ThresholdSampling.pre_update, [None]

    def pre_update(self, env_state, policy, assist=None, draws=None):
        env_state = original(self, env_state, policy, assist=assist, draws=draws)
        if self.last_probs is None:
            return env_state
        n = self.last_probs.size
        stale = torch.full(self.last_probs.shape, 1.0 / n) if previous[0] is None else previous[0]
        previous[0] = torch.as_tensor(self.last_probs)
        return self.venv.update_sample_prob(env_state, stale)
    with _patched(curr.ThresholdSampling, "pre_update", pre_update):
        yield


FAULTS = {"event_mask_dropped": event_mask_dropped, "candidate_one_short": candidate_one_short,
          "stale_probs": stale_probs}
