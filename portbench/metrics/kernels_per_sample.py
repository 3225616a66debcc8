"""Device kernels in the profiled window over the samples rendered there
(frames or steps x samples a frame; ``kernels_per_sample.render`` and
``.train`` alike)."""

from portbench import readers


def read(r):
    return readers.kernels_per_sample(r)
