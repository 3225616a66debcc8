"""Host milliseconds a step in the backward (span ``train.backward``:
autograd, the checkpoint's recompute and the backward kernels' wrappers),
over the profiled steps."""

from portbench import spans


def read(r):
    return spans.per("train.backward", "train.step", 1e3)
