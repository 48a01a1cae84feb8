"""rollout_s.train: seconds of `Trainer.rollout` (control steps, bootstrap value,
GAE, normalization) an iteration, from the benchmark's span ended on a
sync, averaged over the window's iterations."""


def read(run):
    return sum(run.spans["rollout"]) / len(run.spans["rollout"]) if run.kind == "train" else None
