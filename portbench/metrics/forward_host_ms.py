"""Host milliseconds a step in the forward (span ``train.forward``: the
scene, the render and the loss), over the profiled steps."""

from portbench import spans


def read(r):
    return spans.per("train.forward", "train.step", 1e3)
