"""Host milliseconds a frame in ``assemble_image`` (span
``render_image.assemble``: means, tone map, quantize, flip), read inside
the program, over the profiled frame."""

from portbench import spans


def read(r):
    return spans.per("render_image.assemble", "render_image", 1e3)
