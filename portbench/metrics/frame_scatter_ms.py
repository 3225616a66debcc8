"""Host milliseconds a frame in the scatter of its tiles' sums into the
frame's arrays by pixel id (spans ``render_image.scatter``), over the
profiled frame."""

from portbench import spans


def read(r):
    return spans.per("render_image.scatter", "render_image", 1e3)
