"""allreduce_ms.train.4gpu: milliseconds of one all-reduce of the flat
gradient (and the loss terms) on rank 0, from the port's collective clock
(`mesh.CLOCK`: a CUDA event pair around each collective on its stream)
over the profiled update's minibatch steps. It holds the wait for the
slowest rank besides the transfer."""


def read(run):
    if run.kind != "train_ranks":
        return None
    seconds, calls = (run.spans.get(k, [0])[0] for k in ("gradient_allreduce_s",
                                                         "gradient_allreduces"))
    return 1e3 * seconds / calls if calls else None
