"""Host milliseconds a call of the merged search's selection tables (span
``render.frame_selection``: the triangle table, the plan's rects,
parallelograms and leftovers and the walk's tables, once a render call),
over the profiled frame."""

from portbench import spans


def read(r):
    return spans.per("render.frame_selection", "render.frame_selection", 1e3)
