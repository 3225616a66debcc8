"""The candidates K3's search tests a ray against, over the scene's
triangles (counters ``trace_scene.candidates`` and
``trace_scene.triangles`` of ``render.frame_selection``): 1 for the
per-triangle search, about 0.5 where every triangle is half of a merged
quad. None where the program has no counters or counted nothing."""


def read(r):
    try:
        from raytpu_torch.observe import count_stats
    except ImportError:
        return None
    c = count_stats()
    if not c.get("trace_scene.triangles"):
        return None
    return c.get("trace_scene.candidates", 0) / c["trace_scene.triangles"]
