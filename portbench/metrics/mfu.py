"""The whole frame's or step's share of the card's peak: the operations
every layer of it needs (the sample start, the bounce loop, the sums and,
training, the backward; ``reference.work``) over the unprofiled part of
the window at the card's issue limit (``mfu.render`` and ``.train``
alike)."""

from portbench import readers


def read(r):
    return readers.mfu_pct(r)
