"""Host microseconds a call of the bounce loop (span
``render.bounce_loop``: the K1, K3 or scan-path call), over the profiled
frame."""

from portbench import spans


def read(r):
    return spans.per("render.bounce_loop", "render.bounce_loop", 1e6)
