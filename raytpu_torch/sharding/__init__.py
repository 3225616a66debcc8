"""Sharded rendering over a (tiles, samples) grid of devices or processes.

Port of ``raytpu/sharding``: pixels split over ``tiles`` (disjoint
outputs, no communication), samples over ``samples`` (each cell renders
the same pixels at its own global sample indices, and the sums are added
across the axis). ``mesh`` holds the grid of ``torch.device``s of one
process and its render; ``multihost`` the ``torch.distributed`` (gloo)
counterpart across processes, one rank a cell. Because every draw is
keyed by (pixel, global sample index), every factorization computes the
per-sample terms of one device's render; the sums agree up to f32
summation order.
"""

from raytpu_torch.sharding.mesh import (make_mesh, render_image_sharded,
                                        render_sharded)
from raytpu_torch.sharding.multihost import (init_distributed,
                                             make_global_mesh,
                                             render_image_multihost)

__all__ = [
    "make_mesh",
    "render_sharded",
    "render_image_sharded",
    "init_distributed",
    "make_global_mesh",
    "render_image_multihost",
]
