"""Host milliseconds a step in Adam (span ``train.adam``: the zero
gradients of leaves the loss missed, then the update), over the profiled
steps."""

from portbench import spans


def read(r):
    return spans.per("train.adam", "train.step", 1e3)
