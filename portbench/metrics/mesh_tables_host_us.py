"""Host microseconds a call of K3's table packing (span
``trace_scene.tables``: the sphere, triangle, material and atlas packers
and ``mesh_tables``, once a sample), over the profiled frame."""

from portbench import spans


def read(r):
    return spans.per("trace_scene.tables", "trace_scene.tables", 1e6)
