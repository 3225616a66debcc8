"""What the readers of the program's own spans share. The program tallies
each span (``raytpu_torch.observe.span``) while a profiler records, so
``observe.span_stats()`` holds the traced run's profiled frames or steps
alone. A program without spans gives nothing to read."""

from __future__ import annotations


def per(name: str, unit: str, scale: float) -> float | None:
    """``scale`` x the seconds of span ``name`` over the calls of span
    ``unit`` (``name`` itself for a mean a call); None where the program
    has no such spans or recorded none."""
    try:
        from raytpu_torch.observe import span_stats
    except ImportError:
        return None
    stats = span_stats()
    if name not in stats or not stats.get(unit, (0, 0.0))[0]:
        return None
    return scale * stats[name][1] / stats[unit][0]
