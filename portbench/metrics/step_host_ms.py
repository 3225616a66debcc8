"""Host milliseconds a step spends in the step function's call, without a
sync (the host's share of a step that the card does not wait for), over
the window's unprofiled steps."""

from portbench import readers


def read(r):
    return readers.mean_ms(r.host.get("step_host_s"))
