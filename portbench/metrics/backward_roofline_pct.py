"""The backward's least time (the adjoint of the live (ray, bounce) pairs
the reference counted, their draws, the rays' and cotangents' bytes) over
the device time of its kernels (K2, K5 and their sums) in the profiled
window."""

from portbench import readers

# the program's backward kernels (K2's modes, K5, their table sums)
KERNELS = ("sphere_backward_kernel", "backward_kernel", "sum_blocks_kernel",
           "mesh_sum_kernel", "spheres_ad_kernel")


def read(r):
    return readers.roofline_pct(r, "backward", KERNELS)
