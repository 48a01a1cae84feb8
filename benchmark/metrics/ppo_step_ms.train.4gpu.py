"""ppo_step_ms.train.4gpu: milliseconds a PPO minibatch step takes over the
ranks (eager, one gradient all-reduce each), from rank 0's spans around
`Trainer.update` (ended on a sync) over the window's epochs x
minibatches."""


def read(run):
    spans = run.spans.get("update") if run.kind == "train_ranks" else None
    return 1e3 * sum(spans) / (len(spans) * run.minibatch_steps) if spans else None
