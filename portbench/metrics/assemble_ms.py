"""Host milliseconds a frame in ``render.assemble_image`` (means, tone
map, quantize, the row flip), by a span around the call, over the
window's unprofiled frames."""

from portbench import readers


def read(r):
    return readers.mean_ms(r.host.get("assemble_s"))
