"""ppo_step_ms.train: milliseconds a PPO minibatch step takes, from the
benchmark's spans around `Trainer.update` (ended on a sync) over the
window's epochs x minibatches."""


def read(run):
    return 1e3 * sum(run.spans["update"]) / (len(run.spans["update"]) * run.minibatch_steps) if run.kind == "train" else None
