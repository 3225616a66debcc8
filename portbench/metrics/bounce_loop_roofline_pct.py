"""The forward bounce loop's least time (``reference.work``: the live
(ray, bounce) pairs the reference counted, each shaded with one test of
its winner, the draws they use, the rays' bytes) over the device time of
its kernels (K1, K3) in the profiled window. Reads
``bounce_loop_roofline_pct.render`` and ``.train`` alike."""

from portbench import readers

# the program's forward bounce-loop kernels (K1, K3 per triangle, merged)
KERNELS = ("trace_spheres_kernel", "trace_scene_kernel",
           "trace_scene_kernel_merged")


def read(r):
    return readers.roofline_pct(r, "bounce_loop", KERNELS)
