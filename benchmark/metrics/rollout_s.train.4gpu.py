"""rollout_s.train.4gpu: seconds of `Trainer.rollout` on rank 0 (its
quarter of the fleet's control steps, the bootstrap value, GAE and the
advantages' normalization over every rank) an iteration, from the
benchmark's span ended on a sync, averaged over the window's
iterations."""


def read(run):
    spans = run.spans.get("rollout") if run.kind == "train_ranks" else None
    return sum(spans) / len(spans) if spans else None
