"""Host microseconds a call of the sample start (span
``render.sample_start``: the sample-start kernel's wrapper and launch),
over the profiled frame."""

from portbench import spans


def read(r):
    return spans.per("render.sample_start", "render.sample_start", 1e6)
