"""Host milliseconds a frame in the copies of its tiles' sums to the host
(spans ``render_image.fetch``, each waiting for the frame's queued
kernels), over the profiled frame."""

from portbench import spans


def read(r):
    return spans.per("render_image.fetch", "render_image", 1e3)
