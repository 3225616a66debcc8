"""Host microseconds a sample in the sums' 9 adds (span
``render.accumulate``), over the profiled frame."""

from portbench import spans


def read(r):
    return spans.per("render.accumulate", "render.accumulate", 1e6)
